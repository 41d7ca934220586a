"""The continuous scheduler's request lifecycle against the JAX package's:
deadlines, cancellation and backpressure.

The port of ``tests/test_resilience.py``'s lifecycle tests (deadline in
the queue, mid-generation, unparseable; cancel queued and in flight;
the backpressure bound), each run on the port's ``ContinuousScheduler``
(paged KV, the kernels' plain versions on the CPU) and on JAX's, with the
same requests, the same admit/step sequence and weights converted from
one JAX init (the resilience tests' 1-layer d 16 LM, fp32). Codes,
messages (a queue wait's milliseconds aside), ``partial`` texts and the
``deadline_expired`` / ``cancelled`` / ``backpressure`` stats must be
JAX's. Then the port alone: a slot that took a prefix-cache hit (aliased
device-tier blocks) aborted mid-generation gives the pool back every
block it held, leaves the trie no pin and its device blocks' refcounts
as they were, and the next request answers as if nothing happened;
client threads (more than cores) submitting and cancelling while the
loop runs leave every request answered once and no count behind; ``cli.serve
--max_backlog`` and ``deadline_ms`` lines against JAX's
``serve_continuous`` on the same stdin.
"""

import io
import json
import os
import queue
import re
import sys
import threading
import time

import jax
import pytest

from transformer_tpu.cli import serve as j_serve
from transformer_tpu.config import ModelConfig as JConfig
from transformer_tpu.data.tokenizer import SubwordTokenizer as JTokenizer
from transformer_tpu.models import transformer_init
from transformer_tpu.serve import ContinuousScheduler as JScheduler
from transformer_tpu.train.checkpoint import _flatten, export_params
from transformer_tpu_torch.cli import serve
from transformer_tpu_torch.config import ModelConfig as TConfig
from transformer_tpu_torch.convert import params_from_numpy
from transformer_tpu_torch.data.tokenizer import SubwordTokenizer as TTokenizer
from transformer_tpu_torch.serve.prefix_cache import PrefixCache
from transformer_tpu_torch.serve.scheduler import ContinuousScheduler

STATS = ("deadline_expired", "cancelled", "backpressure", "admitted")


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    tok = JTokenizer.build_from_corpus(["ab cd ef gh ij kl mn"] * 3, target_vocab_size=300)
    path = str(tmp_path_factory.mktemp("vocab") / "tiny.subwords")
    tok.save(path)
    kw = dict(
        num_layers=1, d_model=16, num_heads=2, dff=32,
        input_vocab_size=tok.model_vocab_size, target_vocab_size=tok.model_vocab_size,
        max_position=32, decoder_only=True, tie_output=True, dtype="float32",
        dropout_rate=0.0,
    )
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    jparams = transformer_init(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(_flatten(jparams), tcfg, device="cpu")
    return dict(jcfg=jcfg, cfg=tcfg, jparams=jparams, params=params, jtok=tok,
                tok=TTokenizer.load(path), vocab=path)


def _pair(lm, **kw):
    """(JAX scheduler, port scheduler) over the same weights."""
    return (JScheduler(lm["jparams"], lm["jcfg"], lm["jtok"], **kw),
            ContinuousScheduler(lm["params"], lm["cfg"], lm["tok"], kv_block=4, device="cpu",
                                kv_layout="paged", decode_kernel="paged_flash", **kw))


def _same(got, want):
    """Answers equal but for the milliseconds a queue wait took."""
    def norm(answers):
        return [json.loads(re.sub(r"after \d+ms", "after Nms", json.dumps(a))) for a in answers]

    assert norm(got) == norm(want)


def _stats(s):
    return {k: s.stats[k] for k in STATS}


def test_deadline_expires_in_queue(lm):
    reqs = [{"prompt": "ab cd", "max_new": 3, "deadline_ms": 0},
            {"prompt": "ab cd", "max_new": 3}]
    j, s = _pair(lm, num_slots=2)
    want = j.run([dict(r) for r in reqs])
    out = s.run([dict(r) for r in reqs])
    _same(out, want)
    assert out[0]["code"] == "deadline" and "in the admission queue" in out[0]["error"]
    assert "continuation" in out[1] and "partial" not in out[0]
    assert _stats(s) == _stats(j) and s.stats["deadline_expired"] == 1
    assert len(s._free) == 2 and s.alloc.used_blocks == 0


def test_deadline_expires_mid_generation(lm):
    outs = []
    for s in _pair(lm, num_slots=2):
        order = s.submit({"prompt": "ab cd", "max_new": 20, "deadline_ms": 60_000})
        s.admit()
        s.step()
        s.step()
        (slot, st), = s._active.items()
        st.deadline = time.perf_counter() - 1.0  # force expiry at the boundary
        s.step()
        out = s.drain_ready()
        assert out and out[0]["code"] == "deadline" and "partial" in out[0]
        assert order not in s._done and len(s._free) == 2 and not s._active
        outs.append((out, _stats(s)))
    (want, j_stats), (got, stats) = outs
    assert got == want and stats == j_stats
    assert re.fullmatch(r"deadline_ms elapsed after \d+ of 20 tokens", got[0]["error"])


def test_deadline_elapsed_during_prefill(lm):
    """A deadline that the prefill alone spends answers right after it."""
    j, s = _pair(lm, num_slots=2)
    reqs = [{"prompt": "ab cd ef gh ij", "max_new": 8, "deadline_ms": 1e-9}]
    for sched in (j, s):
        sched.submit(dict(reqs[0]))
        sched._queue[0].deadline = time.perf_counter() + 3600.0  # survive the queue check
        sched._queue[0].req["deadline_ms"] = 1e-9
        sched._queue[0].t_enqueue = time.perf_counter() - 1.0  # already spent at admission
    j.admit()
    s.admit()
    _same(s.drain_ready(), j.drain_ready())
    assert not s._active and s.alloc.used_blocks == 0
    assert _stats(s) == _stats(j) and s.stats["deadline_expired"] == 1


def test_unparseable_deadline_is_a_validation_error(lm):
    reqs = [{"prompt": "ab cd", "max_new": 2, "deadline_ms": "soon"},
            {"prompt": "ab", "max_new": 2, "deadline_ms": None}]
    j, s = _pair(lm, num_slots=2)
    want = j.run([dict(r) for r in reqs])
    out = s.run([dict(r) for r in reqs])
    assert out == want
    assert out[0] == {"error": "ValueError: could not convert string to float: 'soon'",
                      "code": "validation"}
    assert "continuation" in out[1]


def test_cancel_queued_and_active(lm):
    results = []
    for s in _pair(lm, num_slots=1):
        o1 = s.submit({"prompt": "ab cd", "max_new": 20})
        o2 = s.submit({"prompt": "ef gh", "max_new": 2})
        s.admit()   # o1 takes the only slot; o2 queued
        s.step()
        assert s.cancel(o2)                  # queued: registered
        assert s.cancel(o1)                  # in flight: registered
        assert not s.cancel(o1)              # already pending
        assert not s.cancel(999)             # unknown order
        s.step()                             # the loop executes both
        assert not s.cancel(o1)              # already answered
        out = s.drain_ready()
        assert [r["code"] for r in out] == ["cancelled", "cancelled"]
        assert "partial" in out[0] and "partial" not in out[1]
        assert len(s._free) == 1 and not s._active and not s.busy
        assert not s.cancel(o2)              # answered and drained
        results.append((out, _stats(s)))
    (want, j_stats), (got, stats) = results
    assert got == want and stats == j_stats and stats["cancelled"] == 2


def test_cancel_caught_at_admission(lm):
    """A cancellation registered before the request's first admission
    answers without a prefill or a slot."""
    results = []
    for s in _pair(lm, num_slots=1):
        order = s.submit({"prompt": "ab cd", "max_new": 4})
        assert s.cancel(order, "gone")
        s.admit()
        results.append((s.drain_ready(), _stats(s)))
        assert not s._active and not s.busy
    (want, j_stats), (got, stats) = results
    assert got == want == [{"error": "gone", "code": "cancelled"}]
    assert stats == j_stats and stats["admitted"] == 0


def test_backpressure_bound(lm):
    results = []
    for s in _pair(lm, num_slots=1, max_backlog=2):
        for _ in range(5):
            s.submit({"prompt": "ab", "max_new": 1})
        while s.busy:
            s.admit()
            s.step()
        out = s.drain_ready()
        codes = [r.get("code", "ok") for r in out]
        assert codes.count("backpressure") == 3 and codes.count("ok") == 2
        assert len(out) == 5  # refused requests answer at their own positions
        results.append((out, _stats(s)))
    (want, j_stats), (got, stats) = results
    assert got == want and stats == j_stats and stats["backpressure"] == 3
    assert got[2] == {"error": "admission queue is full (2 requests); retry after a backoff",
                      "code": "backpressure"}


def test_abort_after_a_prefix_hit_leaks_nothing(lm):
    cache = PrefixCache(lm["cfg"], block_tokens=4, budget_mb=4)
    s = ContinuousScheduler(lm["params"], lm["cfg"], lm["tok"], num_slots=2, kv_block=4,
                            prefix_cache=cache, kv_layout="paged", decode_kernel="paged_flash",
                            device="cpu")
    prompt = "ab cd ef gh ij kl mn ab cd ef gh ij"
    first = s.run([{"prompt": prompt, "max_new": 3}])
    donated = cache.stats["device_blocks"]
    assert donated >= 2 and s.alloc.used_blocks == donated
    free_before = s.alloc.free_blocks
    refs_before = {bid: s.alloc.refs(bid) for bid in range(1, s.alloc.num_blocks)}
    order = s.submit({"prompt": prompt + " kl", "max_new": 20})
    s.admit()
    assert s.stats["prefix_alias_tokens"] > 0  # the hit aliased device-tier blocks
    assert cache.outstanding_refs() == 0        # admission released its pins
    s.step()
    s.step()
    assert s.cancel(order)
    s.step()
    (out,) = s.drain_ready()
    assert out["code"] == "cancelled" and "partial" in out
    s.alloc.check_consistency()
    assert s.alloc.free_blocks == free_before and not s._active
    assert {bid: s.alloc.refs(bid) for bid in refs_before} == refs_before
    assert cache.stats["device_blocks"] == donated and cache.outstanding_refs() == 0
    # The next request answers as a fresh scheduler does.
    again = s.run([{"prompt": prompt, "max_new": 3}])
    assert again == first
    assert s.alloc.free_blocks == free_before


def test_client_threads_submit_and_cancel_while_serving(lm):
    """More client threads than cores submit (half with a deadline that
    never passes) and cancel while the loop steps, with a short switch
    interval: every request answers exactly once, the counts add up, and
    no queued-deadline count, cancellation or block is left behind."""
    _, s = _pair(lm, num_slots=2)
    workers, per = (os.cpu_count() or 1) + 1, 2
    cancelled: list[bool] = []
    stop = threading.Event()

    def client(i):
        for j in range(per):
            req = {"prompt": "ab cd ef", "max_new": 6}
            if j % 2:
                req["deadline_ms"] = 600_000
            order = s.submit(req)
            if (i + j) % 2:
                cancelled.append(s.cancel(order))

    def loop():
        while not stop.is_set() or s.busy:
            s.admit()
            s.step()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        runner = threading.Thread(target=loop)
        runner.start()
        clients = [threading.Thread(target=client, args=(i,)) for i in range(workers)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=60)
        stop.set()
        runner.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not runner.is_alive() and not any(t.is_alive() for t in clients)
    out = s.drain_ready()
    assert len(out) == workers * per and not s._done
    codes = [a.get("code", "ok") for a in out]
    assert set(codes) <= {"ok", "cancelled"}
    # A cancellation that lost the race to completion answers normally.
    assert codes.count("cancelled") == s.stats["cancelled"] <= sum(cancelled)
    assert codes.count("ok") + codes.count("cancelled") == workers * per
    assert s._queued_deadlines == 0 and not s._cancel_pending and not s._queue
    assert s.alloc.used_blocks == 0 and len(s._free) == 2


def test_cli_max_backlog_and_deadlines_match_jax(lm, tmp_path, capsys):
    export = str(tmp_path / "export")
    export_params(lm["jparams"], lm["jcfg"], export)
    lines = ([json.dumps({"prompt": "ef gh", "max_new": 2, "deadline_ms": 0})]
             + [json.dumps({"prompt": "ab cd", "max_new": 3})] * 4
             + [json.dumps({"src": "ab"}), "{oops", json.dumps({"prompt": "ab", "max_new": 2})])
    q: queue.Queue = queue.Queue()
    for line in lines:
        q.put(line + "\n")
    q.put(None)
    j_serve.serve_continuous(q, JScheduler(lm["jparams"], lm["jcfg"], lm["jtok"], num_slots=1,
                                           max_backlog=3), lm["jcfg"])
    want = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    out = io.StringIO()
    sched = serve.main(["--export_path", export, "--tgt_vocab_file", lm["vocab"],
                        "--serve_slots", "1", "--max_backlog", "3", "--prefix_block", "4",
                        "--kv_layout", "paged", "--decode_kernel", "paged_flash",
                        "--device", "cpu"], stdin=io.StringIO("\n".join(lines) + "\n"),
                       stdout=out)
    got = [json.loads(line) for line in out.getvalue().splitlines()]
    _same(got, want)
    assert [a.get("code") for a in got] == ["deadline", None, None, "backpressure",
                                            "backpressure", "routing", "validation",
                                            "backpressure"]
    assert sched.stats["backpressure"] == 3 and sched.stats["deadline_expired"] == 1
