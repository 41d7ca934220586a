"""Fault-tolerant serving, ported from the JAX package's
``tests/test_resilience.py`` (the parts the port's server reaches): the
``--fault_spec`` grammar, fault schedules that fire at the JAX plane's
call indices, the disarmed plane, backoff and the error taxonomy, the
breaker ladder, transient admission faults retried to byte-identical
answers, a persistent fault answered ``transient``, the chaos subset
(answers and stats equal to JAX's scheduler under the same spec), the
drafter and prefix-cache fault sites opening their breakers, the hammer
storm of client threads, and ``--fault_spec`` with the breaker flags
through ``cli.serve.main``.

Both schedulers run the chaos drills with ``retry_backoff_ms=0`` and a
zero cooldown: a retried admission then waits exactly one ``admit`` call
and a breaker re-probes at once, so the call sequence, and with it which
calls the plane fires at, is a function of the requests alone (with a
wall-clock backoff it would depend on each step's duration).
"""

import io
import json
import os
import queue
import sys
import threading
import time

import jax
import pytest

from transformer_tpu.config import ModelConfig as JConfig
from transformer_tpu.data.tokenizer import SubwordTokenizer as JTokenizer
from transformer_tpu.models import transformer_init
from transformer_tpu.serve import ContinuousScheduler as JScheduler
from transformer_tpu.serve import PrefixCache as JPrefixCache
from transformer_tpu.serve import resilience as jres
from transformer_tpu.train.checkpoint import _flatten, export_params
from transformer_tpu_torch.cli import serve
from transformer_tpu_torch.config import ModelConfig
from transformer_tpu_torch.convert import params_from_numpy
from transformer_tpu_torch.data.tokenizer import SubwordTokenizer
from transformer_tpu_torch.serve import resilience
from transformer_tpu_torch.serve.prefix_cache import PrefixCache
from transformer_tpu_torch.serve.resilience import (
    CircuitBreaker,
    FaultPlane,
    InjectedFault,
    TransientError,
    backoff_ms,
    classify_error,
)
from transformer_tpu_torch.serve.scheduler import ContinuousScheduler
from transformer_tpu_torch.serve.speculative import ModelDrafter, NgramDrafter


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm")
    jtok = JTokenizer.build_from_corpus(["ab cd ef gh ij kl mn"] * 3, target_vocab_size=300)
    vocab = str(tmp / "tiny.subwords")
    jtok.save(vocab)
    kw = dict(num_layers=1, d_model=16, num_heads=2, dff=32,
              input_vocab_size=jtok.model_vocab_size, target_vocab_size=jtok.model_vocab_size,
              max_position=32, decoder_only=True, tie_output=True, dtype="float32",
              dropout_rate=0.0)
    jparams = transformer_init(jax.random.PRNGKey(0), JConfig(**kw))
    cfg = ModelConfig(**kw)
    export = str(tmp / "export")
    export_params(jparams, JConfig(**kw), export)
    return dict(jtok=jtok, tok=SubwordTokenizer.load(vocab), jparams=jparams, jcfg=JConfig(**kw),
                params=params_from_numpy(_flatten(jparams), cfg, device="cpu"), cfg=cfg,
                vocab=vocab, export=export)


def _sched(lm, **kw):
    return ContinuousScheduler(lm["params"], lm["cfg"], lm["tok"], device="cpu", **kw)


def _jsched(lm, **kw):
    return JScheduler(lm["jparams"], lm["jcfg"], lm["jtok"], **kw)


# --------------------------------------------------------------------------
# the fault plane


def test_fault_spec_grammar():
    spec = ("serve.prefill:p=0.25,seed=7;obs.emit:at=2+5;draft.slow:every=3,ms=40;"
            "prefix.corrupt:times=1;route.canary")
    plane, jplane = FaultPlane.parse(spec), jres.FaultPlane.parse(spec)
    assert plane._rules.keys() == jplane._rules.keys()
    for point, rule in plane._rules.items():
        assert vars(rule) == vars(jplane._rules[point])
    assert resilience.FAULT_POINTS == jres.FAULT_POINTS
    for bad, match in (("serve.prefil:p=1", "unknown fault point"),
                       ("serve.prefill:prob=1", "unknown fault_spec key"),
                       ("obs.emit:at=2;obs.emit:at=5", "twice"),
                       ("serve.prefill:p", "not key=value")):
        with pytest.raises(ValueError, match=match) as err:
            FaultPlane.parse(bad)
        with pytest.raises(ValueError) as jerr:
            jres.FaultPlane.parse(bad)
        assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("spec", [
    "serve.prefill:p=0.3,seed=11",
    "serve.prefill:p=0.3,seed=12;prefix.match:p=0.5,seed=4",
    "serve.prefill:at=3+5;draft.propose:every=4,times=3",
    "draft.slow:every=2,ms=0;prefix.corrupt:p=0.7,seed=9,times=5",
])
def test_fault_schedules_fire_at_jax_call_indices(spec):
    points = ("serve.prefill", "prefix.match", "draft.propose", "draft.slow", "prefix.corrupt")
    plane, jplane = FaultPlane.parse(spec), jres.FaultPlane.parse(spec)
    order = [points[(i * 7) % len(points)] for i in range(300)]
    got = [bool(plane.fire(p)) for p in order]
    want = [bool(jplane.fire(p)) for p in order]
    assert got == want and any(got)
    assert plane.fired_log == jplane.fired_log and plane.calls == jplane.calls
    assert FaultPlane.parse(spec).fired_log == []  # a fresh plane replays from call 1


def test_disarmed_plane_is_free_and_scoped():
    assert resilience.installed() is None
    resilience.maybe_fail("serve.prefill")  # no plane: a no-op
    assert resilience.fired("prefix.corrupt") is False
    with resilience.active(FaultPlane.parse("serve.prefill:p=1")) as plane:
        assert resilience.installed() is plane
        with pytest.raises(InjectedFault) as e:
            resilience.maybe_fail("serve.prefill")
        assert isinstance(e.value, OSError) and isinstance(e.value, TransientError)
        assert str(e.value) == str(jres.InjectedFault("serve.prefill", 1))
    assert resilience.installed() is None


def test_backoff_and_error_taxonomy_match_jax():
    for order in range(5):
        for attempt in range(3):
            assert backoff_ms(20.0, attempt, order) == jres.backoff_ms(20.0, attempt, order)
    a = backoff_ms(20.0, 0, order=7)
    assert 10.0 <= a < 30.0 and 20.0 <= backoff_ms(20.0, 1, order=7) < 60.0

    def excs(mod):
        return (mod.InjectedFault("serve.prefill", 1), ValueError("bad"), RuntimeError("boom"),
                KeyError("k"), mod.TransientError("t"))

    assert [classify_error(e) for e in excs(resilience)] == [
        jres.classify_error(e) for e in excs(jres)] == [
        "transient", "validation", "internal", "validation", "transient"]
    assert resilience.ERROR_CODES.keys() == jres.ERROR_CODES.keys()
    assert resilience.error_answer("deadline", "m", partial="x") == jres.error_answer(
        "deadline", "m", partial="x")


# --------------------------------------------------------------------------
# circuit breakers (a test clock: deterministic cooldowns)


def _ladder(cls):
    clock = [0.0]
    seen = []
    b = cls("x", threshold=2, cooldown_s=10.0, clock=lambda: clock[0],
            on_transition=lambda name, old, new: seen.append((old, new)))
    trace = [b.allow(), b.state]
    b.record_failure()
    trace += [b.state, b.allow(), b.record_failure(), b.state, b.allow()]
    clock[0] = 5.0
    trace.append(b.allow())
    clock[0] = 10.0
    trace += [b.allow(), b.state, b.record_failure(), b.state, b.allow()]
    clock[0] = 25.0
    trace.append(b.allow())
    b.record_success()
    trace += [b.state, b.allow()]
    b.record_failure()
    b.record_success()
    b.record_failure()
    trace.append(b.state)
    return trace, seen, dict(b.stats)


def test_breaker_ladder():
    trace, seen, stats = _ladder(CircuitBreaker)
    assert (trace, seen, stats) == _ladder(jres.CircuitBreaker)
    assert seen == [("closed", "open"), ("open", "half_open"), ("half_open", "open"),
                    ("open", "half_open"), ("half_open", "closed")]
    assert stats["opens"] == 2 and stats["closes"] == 1
    with pytest.raises(ValueError, match="threshold"):
        CircuitBreaker("x", threshold=0)


def test_breaker_open_ignores_stray_success():
    clock = [0.0]
    b = CircuitBreaker("x", threshold=1, cooldown_s=10.0, clock=lambda: clock[0])
    assert b.record_failure() is True
    b.record_success()  # a success from work admitted before the trip
    assert b.state == "open" and not b.allow()
    clock[0] = 10.0
    assert b.allow() and b.state == "half_open"
    b.record_success()
    assert b.state == "closed"


# --------------------------------------------------------------------------
# admission faults


@pytest.mark.parametrize("kv_layout", ["dense", "paged"])
def test_transient_fault_retries_to_byte_identical_answer(lm, kv_layout):
    reqs = [{"prompt": "ab cd ef", "max_new": 4}, {"prompt": "kl", "max_new": 2}]
    want = _sched(lm, num_slots=2).run([dict(r) for r in reqs])
    assert want == _jsched(lm, num_slots=2).run([dict(r) for r in reqs])
    s = _sched(lm, num_slots=2, retry_backoff_ms=1.0, kv_layout=kv_layout, kv_block=4)
    with resilience.active(FaultPlane.parse("serve.prefill:at=1")) as plane:
        out = s.run([dict(r) for r in reqs])
    assert out == want, "a retried admission must not change the answer"
    assert s.stats["retries"] == 1 and plane.episodes == 1
    assert len(s._free) == 2


def test_persistent_fault_answers_structured_transient(lm):
    s = _sched(lm, num_slots=2, admission_retries=1, retry_backoff_ms=1.0)
    with resilience.active(FaultPlane.parse("serve.prefill:p=1")):
        out = s.run([{"prompt": "ab cd", "max_new": 2}])
    assert out[0]["code"] == "transient" and "InjectedFault" in out[0]["error"]
    assert len(s._free) == 2 and not s.busy


# --------------------------------------------------------------------------
# chaos drills


CHAOS_REQS = [
    {"prompt": "ab cd ef gh ij kl", "max_new": 4},
    {"prompt": "ab cd ef gh mn", "max_new": 3},
    {"prompt": "kl mn", "max_new": 2},
    {"prompt": "ab cd ef gh ij kl", "max_new": 4},
]
CHAOS_SPEC = ("serve.prefill:p=0.4,seed=3;prefix.match:p=0.4,seed=4;"
              "prefix.corrupt:p=0.5,seed=5;draft.propose:p=0.5,seed=6")
STAT_KEYS = ("admitted", "steps", "max_active", "prompt_tokens", "prefix_hit_tokens",
             "prefill_forwards", "retries", "drafted", "accepted")


def _answers_ok(out, n):
    assert len(out) == n, f"only {len(out)}/{n} requests answered"
    for r in out:
        assert ("continuation" in r) or ("error" in r and "code" in r), r


def _invariants(s, cache):
    assert sorted(s._free) == list(range(s.num_slots)), "slot leak"
    assert not s._active and not s.busy
    assert s._queued_deadlines == 0
    assert cache.outstanding_refs() == 0, "leaked prefix-cache pin"
    if s.alloc is not None:
        s.alloc.check_consistency()
        assert s.alloc.used_blocks == cache.stats["device_blocks"]


def _chaos_drill(sched, plane, install):
    want = sched.run([dict(r) for r in CHAOS_REQS])  # also fills the trie
    sched.run([dict(r) for r in CHAOS_REQS])          # the hit paths
    rounds = []
    with install(plane):
        for _ in range(3):
            out = sched.run([dict(r) for r in CHAOS_REQS])
            _answers_ok(out, len(CHAOS_REQS))
            rounds.append(out)
    recovered = sched.run([dict(r) for r in CHAOS_REQS])
    return want, rounds, recovered


def test_chaos_fast_subset(lm):
    """Four fault points, seeded, the breakers flipping: every request
    answered, nothing leaked, greedy answers byte-identical once the plane
    disarms and the breakers close, and the answers, fault episodes and
    stats those of JAX's scheduler under the same spec."""
    common = dict(num_slots=2, speculate_k=2, breaker_threshold=2, breaker_cooldown_s=0.0,
                  retry_backoff_ms=0.0)
    cache = PrefixCache(lm["cfg"], block_tokens=4, budget_mb=8)
    s = _sched(lm, prefix_cache=cache, **common)
    plane = FaultPlane.parse(CHAOS_SPEC)
    want, rounds, recovered = _chaos_drill(s, plane, resilience.active)
    jcache = JPrefixCache(lm["jcfg"], block_tokens=4, budget_mb=8)
    js = _jsched(lm, prefix_cache=jcache, **common)
    jplane = jres.FaultPlane.parse(CHAOS_SPEC)
    jwant, jrounds, jrecovered = _chaos_drill(js, jplane, jres.active)
    assert plane.episodes >= 8 and len({p for p, _ in plane.fired_log}) >= 3
    assert all("continuation" in r for r in want)
    assert recovered == want, "answers changed after the chaos round"
    assert s.breakers["speculative"].state == "closed"
    assert s.breakers["prefix_cache"].state == "closed"
    _invariants(s, cache)
    assert (want, rounds, recovered) == (jwant, jrounds, jrecovered)
    assert plane.fired_log == jplane.fired_log
    assert {k: s.stats[k] for k in STAT_KEYS} == {k: js.stats.get(k, 0) for k in STAT_KEYS}
    for name, b in s.breakers.items():
        assert b.stats == js.breakers[name].stats, name
    assert cache.stats["corrupt_blocks"] == jcache.stats["corrupt_blocks"] > 0
    assert s.stats["spec_breaker_open_steps"] + s.stats["prefix_breaker_open_admissions"] >= 0


@pytest.mark.parametrize("kv_layout", ["dense", "paged"])
def test_breakers_open_and_close_at_the_fault_sites(lm, kv_layout):
    """Drafter faults (a raise, and a proposal past ``drafter_slow_ms``)
    open the speculative breaker; prefix-cache faults (match, a corrupt
    host block, insert) open the prefix breaker. While open, verify rows
    carry no drafts and admissions skip the cache; after the cooldown one
    probe closes each. Answers never change."""
    clock = [0.0]
    cache = PrefixCache(lm["cfg"], block_tokens=4, budget_mb=8)
    s = _sched(lm, num_slots=2, speculate_k=2, prefix_cache=cache, breaker_threshold=2,
               breaker_cooldown_s=10.0, breaker_clock=lambda: clock[0], drafter_slow_ms=5.0,
               retry_backoff_ms=0.0, kv_layout=kv_layout, kv_block=4)
    want = s.run([dict(r) for r in CHAOS_REQS])
    if kv_layout == "paged":
        cache.release_device_blocks(1 << 30)  # spill: the next hits read host blocks
    # The first propose raises and the second stalls past the budget; the
    # first match raises and the second finds a corrupt host block: two
    # consecutive faults each. The first insert raises once the prefix
    # breaker lets retirements feed the trie again.
    spec = ("draft.propose:at=1;draft.slow:at=1,ms=20;prefix.match:at=1;prefix.corrupt:at=1;"
            "prefix.insert:at=1")
    with resilience.active(FaultPlane.parse(spec)) as plane:
        out = s.run([dict(r) for r in CHAOS_REQS])
        assert out == want
        assert ("speculative", "closed", "open") in s.breaker_log
        assert ("prefix_cache", "closed", "open") in s.breaker_log
        assert s.stats["spec_breaker_open_steps"] > 0
        assert s.stats["prefix_breaker_open_admissions"] > 0
        assert cache.stats["corrupt_blocks"] == 1
        clock[0] = 10.0
        assert s.run([dict(r) for r in CHAOS_REQS]) == want
    assert {p for p, _ in plane.fired_log} == {"draft.propose", "draft.slow", "prefix.match",
                                               "prefix.corrupt", "prefix.insert"}
    assert s.run([dict(r) for r in CHAOS_REQS]) == want
    for name in ("speculative", "prefix_cache"):
        states = [(old, new) for n, old, new in s.breaker_log if n == name]
        assert states[-2:] == [("open", "half_open"), ("half_open", "closed")], states
    _invariants(s, cache)


def test_model_drafter_fault_points(lm):
    """``ModelDrafter.propose`` passes the drafter's fault points as the
    n-gram drafter does."""
    for drafter in (NgramDrafter(), ModelDrafter(lm["params"], lm["cfg"], max_total=32,
                                                 device="cpu")):
        state = drafter.start([1, 5, 6, 5])
        with resilience.active(FaultPlane.parse("draft.propose:at=1")) as plane:
            with pytest.raises(InjectedFault, match="draft.propose"):
                drafter.propose(state, [1, 5, 6, 5], 2)
            drafter.propose(state, [1, 5, 6, 5], 2)
        assert plane.calls == {"draft.propose": 2, "draft.slow": 1}


@pytest.mark.parametrize("kv_layout", ["dense", "paged"])
def test_hammer_thread_storm(lm, kv_layout):
    """Four client threads submit plain and pre-expired requests while the
    scheduler loop runs under injected prefill and prefix faults: every
    request answered exactly once, no slot, block or pin leaked."""
    cache = PrefixCache(lm["cfg"], block_tokens=4, budget_mb=8)
    s = _sched(lm, num_slots=2, prefix_cache=cache, breaker_threshold=2,
               breaker_cooldown_s=0.0, retry_backoff_ms=1.0, kv_layout=kv_layout, kv_block=4)
    n_threads, per = 4, 10

    def client(t):
        for i in range(per):
            req = {"prompt": "ab cd ef gh", "max_new": 2}
            if (t + i) % 4 == 0:
                req["deadline_ms"] = 0
            s.submit(req)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(n_threads)]
    give_up = time.monotonic() + 120
    with resilience.active(FaultPlane.parse(
            "serve.prefill:p=0.3,seed=8;prefix.match:p=0.3,seed=9")) as plane:
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads) or s.busy:
            s.admit()
            s.step()
            assert time.monotonic() < give_up, "storm did not drain"
        for t in threads:
            t.join()
        while s.busy:
            s.admit()
            s.step()
    out = s.drain_ready()
    _answers_ok(out, n_threads * per)
    assert sum(1 for r in out if r.get("code") == "deadline") == n_threads * per // 4
    _invariants(s, cache)
    assert plane.episodes > 0


def test_shutdown_races_client_threads(lm):
    """More client threads than cores submit while another thread calls
    ``shutdown`` and the loop steps, with a short switch interval: every
    order answers exactly once, and the orders refused with ``routing``
    are exactly those after the close (the order counter and the closed
    flag change under one lock)."""
    s = _sched(lm, num_slots=2)
    workers, per = (os.cpu_count() or 1) + 1, 3
    orders: list[int] = []
    stop = threading.Event()

    def client():
        for _ in range(per):
            orders.append(s.submit({"prompt": "ab cd", "max_new": 2}))

    def loop():
        while not stop.is_set() or s.busy:
            s.admit()
            s.step()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        runner = threading.Thread(target=loop)
        runner.start()
        clients = [threading.Thread(target=client) for _ in range(workers)]
        for i, t in enumerate(clients):
            t.start()
            if i == workers // 2:
                s.shutdown()
        for t in clients:
            t.join(timeout=60)
        stop.set()
        runner.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not runner.is_alive() and not any(t.is_alive() for t in clients)
    out = s.drain_ready()
    assert sorted(orders) == list(range(workers * per)) and len(out) == workers * per
    refused = [i for i, r in enumerate(out) if r.get("code") == "routing"]
    served = [i for i, r in enumerate(out) if "continuation" in r]
    assert len(refused) + len(served) == len(out) and refused
    assert not served or max(served) < min(refused)
    assert sorted(s._free) == [0, 1] and not s.busy


def test_cli_fault_spec_and_breaker_flags(lm):
    """``cli.serve --fault_spec`` arms the plane for the run (and disarms
    it after); ``--breaker_threshold`` / ``--breaker_cooldown`` reach the
    breakers; the faulted run's answers equal the clean run's, the
    deadline answer carries JAX's code."""
    lines = [json.dumps({"prompt": "ab cd ef gh", "max_new": 3}),
             json.dumps({"prompt": "kl mn", "max_new": 2, "deadline_ms": 0}),
             json.dumps({"prompt": "ab cd ef gh ij", "max_new": 4})]
    base = ["--export_path", lm["export"], "--tgt_vocab_file", lm["vocab"], "--serve_slots", "2",
            "--prefix_block", "4", "--speculate_k", "2", "--prefix_cache_mb", "8",
            "--device", "cpu"]

    def run(*extra):
        out = io.StringIO()
        sched = serve.main(base + list(extra), stdin=io.StringIO("\n".join(lines) + "\n"),
                           stdout=out)
        return [json.loads(line) for line in out.getvalue().splitlines()], sched

    clean, _ = run()
    got, sched = run("--fault_spec", "serve.prefill:at=1;draft.propose:at=1+2",
                     "--breaker_threshold", "2", "--breaker_cooldown", "0.5")
    assert got == clean and len(got) == 3
    assert got[1]["code"] == "deadline"
    assert sched.stats["retries"] == 1
    assert sched.breakers["speculative"].threshold == 2
    assert sched.breakers["prefix_cache"].cooldown_s == 0.5
    assert ("speculative", "closed", "open") in sched.breaker_log
    assert resilience.installed() is None
    with pytest.raises(ValueError, match="unknown fault point"):
        serve.main(base + ["--fault_spec", "serve.prefil"], stdin=io.StringIO(""),
                   stdout=io.StringIO())
    defaults = serve.build_parser().parse_args(["--export_path", "x", "--tgt_vocab_file", "y"])
    assert (defaults.kv_layout, defaults.decode_kernel, defaults.breaker_threshold,
            defaults.breaker_cooldown, defaults.fault_spec) == ("dense", "xla", 3, 30.0, "")


def test_serve_continuous_carries_error_codes(lm):
    s = _sched(lm, num_slots=2)
    q: queue.Queue = queue.Queue()
    q.put('{"prompt": "ab cd", "max_new": 2, "deadline_ms": 0}\n')
    q.put('{"prompt": "ab cd", "max_new": 2}\n')
    q.put(None)
    out = io.StringIO()
    serve.serve_continuous(q, s, out)
    lines = [json.loads(line) for line in out.getvalue().strip().splitlines()]
    assert lines[0]["code"] == "deadline"
    assert "continuation" in lines[1]
