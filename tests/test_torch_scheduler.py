"""The continuous scheduler's contracts, ported from the JAX package's
``tests/test_scheduler.py``: the port's ``ContinuousScheduler`` on its
default dense layout (and, for the first test, on the paged layout through
gathered views and through the kernels' plain versions) against sequential
batch-1 ``generate`` and against JAX's ``ContinuousScheduler``, on a tiny
fp32 LM whose weights are converted from the JAX init. Greedy answers
must equal JAX's; sampled ones equal the port's own sequential
``generate`` (the port draws from torch generators keyed as the
scheduler keys them; JAX's threefry draws cannot be reproduced). Then the
lifecycle contracts: a poisoned request fails alone, a straggler does not
block admission, answers leave in arrival order, the int8 rolling-window
cache (``attention_window`` 4) serves as sequential decoding does, a
flood of malformed lines stays bounded, a submission after ``shutdown``
answers ``routing``, and ``serve_continuous`` answers one line per
request.
"""

import io
import json
import queue

import jax
import pytest

from transformer_tpu.cli.serve import serve_continuous as j_serve_continuous
from transformer_tpu.config import ModelConfig as JConfig
from transformer_tpu.data.tokenizer import SubwordTokenizer as JTokenizer
from transformer_tpu.models import transformer_init
from transformer_tpu.serve import ContinuousScheduler as JScheduler
from transformer_tpu.train.checkpoint import _flatten
from transformer_tpu_torch.cli.serve import serve_continuous
from transformer_tpu_torch.config import ModelConfig
from transformer_tpu_torch.convert import params_from_numpy
from transformer_tpu_torch.data.tokenizer import SubwordTokenizer
from transformer_tpu_torch.serve.scheduler import ContinuousScheduler
from transformer_tpu_torch.train.decode import generate

LAYOUTS = {
    "dense": dict(kv_layout="dense"),
    "paged_xla": dict(kv_layout="paged", decode_kernel="xla", kv_block=4),
    "paged_flash": dict(kv_layout="paged", decode_kernel="paged_flash", kv_block=4),
}


def _kw(tok, **extra):
    return dict(
        num_layers=1, d_model=16, num_heads=2, dff=32,
        input_vocab_size=tok.model_vocab_size, target_vocab_size=tok.model_vocab_size,
        max_position=32, decoder_only=True, tie_output=True, dtype="float32",
        dropout_rate=0.0, **extra,
    )


def _model(tok, **extra):
    kw = _kw(tok, **extra)
    jparams = transformer_init(jax.random.PRNGKey(0), JConfig(**kw))
    cfg = ModelConfig(**kw)
    return jparams, JConfig(**kw), params_from_numpy(_flatten(jparams), cfg, device="cpu"), cfg


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    jtok = JTokenizer.build_from_corpus(["ab cd ef gh ij kl mn"] * 3, target_vocab_size=300)
    path = str(tmp_path_factory.mktemp("vocab") / "tiny.subwords")
    jtok.save(path)
    tok = SubwordTokenizer.load(path)
    jparams, jcfg, params, cfg = _model(jtok)
    return dict(jtok=jtok, tok=tok, jparams=jparams, jcfg=jcfg, params=params, cfg=cfg)


REQS = [
    {"prompt": "ab cd ef gh ij", "max_new": 6},
    {"prompt": "kl", "max_new": 2},
    {"prompt": "ef", "max_new": 0},  # empty-budget edge: "" both paths
    {"prompt": "ab cd", "max_new": 8, "temperature": 0.9, "seed": 3},
    {"prompt": "mn ef cd", "max_new": 1},
    {"prompt": "gh ij kl mn", "max_new": 5, "temperature": 0.7, "top_k": 4, "seed": 1},
]
GREEDY = [i for i, r in enumerate(REQS) if "temperature" not in r]


def _sequential(params, cfg, tok, reqs):
    """The serve_batch=1 oracle: each request alone through generate()."""
    return [
        generate(params, cfg, tok, [r["prompt"]], max_new=r.get("max_new", 64),
                 temperature=r.get("temperature", 0.0), top_k=r.get("top_k", 0),
                 top_p=r.get("top_p", 1.0), seed=r.get("seed", 0))[0]
        for r in reqs
    ]


def _sched(lm, **kw):
    return ContinuousScheduler(lm["params"], lm["cfg"], lm["tok"], device="cpu", **kw)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_matches_sequential_serving(lm, layout):
    """2 slots, 6 requests with mixed prompt/output lengths and sampling
    params: the same continuations as decoding each request alone, and
    JAX's scheduler's greedy answers."""
    want = _sequential(lm["params"], lm["cfg"], lm["tok"], REQS)
    sched = _sched(lm, num_slots=2, **LAYOUTS[layout])
    got = sched.run([dict(r) for r in REQS])
    assert [g.get("continuation") for g in got] == want
    jgot = JScheduler(lm["jparams"], lm["jcfg"], lm["jtok"], num_slots=2).run(
        [dict(r) for r in REQS])
    assert [got[i] for i in GREEDY] == [jgot[i] for i in GREEDY]
    assert sched.stats["admitted"] == len(REQS)
    assert sched.stats["max_active"] <= 2
    assert not sched.busy and len(sched._free) == 2
    if sched.alloc is not None:
        sched.alloc.check_consistency()
        assert sched.alloc.used_blocks == 0


def test_single_slot_matches_sequential(lm):
    reqs = REQS[:3]
    want = _sequential(lm["params"], lm["cfg"], lm["tok"], reqs)
    got = _sched(lm, num_slots=1).run([dict(r) for r in reqs])
    assert [g.get("continuation") for g in got] == want


def test_poisoned_request_fails_alone(lm):
    good = {"prompt": "ab cd", "max_new": 3}
    over = {"prompt": "ab cd ef gh " * 30, "max_new": 3}  # > max_position
    bad_field = {"prompt": "ef gh", "max_new": "four"}
    stray_seed = {"prompt": "ab cd", "max_new": 3, "seed": "abc"}
    big_topk = {"prompt": "ab cd", "max_new": 3, "temperature": 0.8, "top_k": 100000}
    reqs = [good, over, bad_field, good, stray_seed, big_topk, good]
    sched = _sched(lm, num_slots=2)
    got = sched.run([dict(r) for r in reqs])
    want = JScheduler(lm["jparams"], lm["jcfg"], lm["jtok"], num_slots=2).run(
        [dict(r) for r in reqs])
    assert got == want
    assert got[0]["continuation"] == got[3]["continuation"] == got[6]["continuation"]
    assert "max_position" in got[1]["error"] and "top_k" in got[5]["error"]
    assert got[4]["continuation"] == got[0]["continuation"]
    assert len(sched._free) == 2


def test_straggler_does_not_block_admission(lm):
    reqs = [{"prompt": "ab cd ef gh ij kl", "max_new": 20}] + [
        {"prompt": "mn", "max_new": 1} for _ in range(4)
    ]
    sched = _sched(lm, num_slots=2)
    got = sched.run([dict(r) for r in reqs])
    jsched = JScheduler(lm["jparams"], lm["jcfg"], lm["jtok"], num_slots=2)
    assert got == jsched.run([dict(r) for r in reqs])
    assert all("continuation" in g for g in got)
    assert sched.stats["max_active"] == 2
    assert sched.stats["steps"] == jsched.stats["steps"] <= 20 + len(reqs) + 8


def test_arrival_order_output(lm):
    sched = _sched(lm, num_slots=4)
    sched.submit({"prompt": "ab cd ef gh ij", "max_new": 8})
    sched.submit_done({"error": "routing"})
    sched.submit({"prompt": "kl", "max_new": 1})
    early = []
    while sched.busy:
        sched.admit()
        sched.step()
        early.extend(sched.drain_ready())
        if early:
            assert "continuation" in early[0]
    out = early + sched.drain_ready()
    assert len(out) == 3
    assert out[1] == {"error": "routing"}
    assert "continuation" in out[2]


def test_cache_variants_match_sequential(lm):
    """The dense pool serves the int8 rolling-window cache (window 4, over
    prompts and continuations longer than it) as sequential decoding does,
    and as JAX's scheduler does."""
    jparams, jcfg, params, cfg = _model(lm["jtok"], kv_cache_int8=True, attention_window=4)
    reqs = [dict(r) for r in REQS[:3]] + [{"prompt": "ab cd ef gh ij kl mn ab", "max_new": 9}]
    want = _sequential(params, cfg, lm["tok"], reqs)
    sched = ContinuousScheduler(params, cfg, lm["tok"], num_slots=2, prefill_chunk=2,
                                device="cpu")
    got = sched.run([dict(r) for r in reqs])
    assert [g.get("continuation") for g in got] == want
    assert got == JScheduler(jparams, jcfg, lm["jtok"], num_slots=2, prefill_chunk=2).run(
        [dict(r) for r in reqs])
    assert sched.pools[0]["k"].shape[1] == 4 and "rolling" in sched.pools[0]


def test_malformed_flood_stays_bounded(lm, capsys):
    sched = _sched(lm, num_slots=2)
    peak = 0
    orig = sched.submit_done

    def spying(resp):
        nonlocal peak
        order = orig(resp)
        peak = max(peak, sched.ready_count)
        return order

    sched.submit_done = spying
    q: queue.Queue = queue.Queue()
    for _ in range(100):
        q.put("{bad\n")
    q.put(None)
    out = io.StringIO()
    serve_continuous(q, sched, out)
    lines = out.getvalue().strip().splitlines()
    assert len(lines) == 100
    assert all("error" in json.loads(line) for line in lines)
    assert peak <= 2 * 8  # backlog_cap for num_slots=2


def test_submit_after_shutdown_answers_routing_error(lm):
    sched = _sched(lm, num_slots=2)
    jsched = JScheduler(lm["jparams"], lm["jcfg"], lm["jtok"], num_slots=2)
    outs = []
    for s in (sched, jsched):
        s.submit({"prompt": "ab cd", "max_new": 3})
        s.shutdown()
        assert s.submit({"prompt": "ef gh", "max_new": 3}) == 1
        while s.busy:
            s.admit()
            s.step()
        outs.append(s.drain_ready())
    out, want = outs
    assert out == want and len(out) == 2
    assert "continuation" in out[0]
    assert out[1]["code"] == "routing" and "shut down" in out[1]["error"]
    assert sched.backlog == 0 and len(sched._free) == 2


def test_serve_continuous_loop(lm, capsys):
    """JSONL, raw, malformed and wrong-kind lines through the stdin queue:
    one answer per line, in order, the loop surviving the bad ones; the
    lines JAX's loop prints."""
    lines = [
        "ab cd\n",
        '{"prompt": "ef gh", "max_new": 2}\n',
        "{broken json\n",
        '{"src": "wrong kind"}\n',
        '{"src": "x", "prompt": "y"}\n',
        "\n",
    ]

    def run(loop, sched, *out):
        q: queue.Queue = queue.Queue()
        for line in lines:
            q.put(line)
        q.put(None)
        loop(q, sched, *out)

    out = io.StringIO()
    run(serve_continuous, _sched(lm, num_slots=2), out)
    got = [json.loads(line) for line in out.getvalue().strip().splitlines()]
    capsys.readouterr()
    run(j_serve_continuous, JScheduler(lm["jparams"], lm["jcfg"], lm["jtok"], num_slots=2),
        lm["jcfg"])
    want = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert len(got) == 5
    assert [g.get("continuation") for g in got[:2]] == [w.get("continuation") for w in want[:2]]
    assert "continuation" in got[0] and "continuation" in got[1] and "error" in got[2]
    assert got[3]["error"] == got[4]["error"] == "LM export serves 'prompt', not 'src'"
    assert got[3:] == want[3:]
