"""The port scheduler's telemetry against the JAX scheduler's.

The port's ``ContinuousScheduler`` on the CPU (the plain versions of
kernels B and A on the paged_flash layout) and JAX's (its Pallas kernels
in interpret mode), in fp32 on a tiny LM whose weights are converted from
the JAX init, serve the same greedy requests (shared prefixes, a prompt
over the slot budget, a pre-answered routing error) with telemetry and
tracing on, on the dense and the paged_flash layouts, with and without
``speculate_k`` and the prefix cache. Then:

- the ``serve.request`` events carry the same fields, and the same token
  and prefix-hit counts, request by request;
- every request's span tree is JAX's (names, parents, lanes), and the
  scheduler's ``scheduler.step`` / ``spec.*`` spans come in the same
  numbers;
- the registry holds the same metric names;
- the answers are byte-identical to the port's own run with telemetry
  off (and to JAX's);
- ``--slo_spec`` parses, and ``slo.burn`` fires as JAX's does;
- the ``obs.emit`` fault point fires in the event log's write, at the
  same call as JAX's, and drops the same event;
- ``cli.serve`` with ``--metrics_jsonl --trace`` writes what ``obs
  summarize`` renders (``perf:``, SLOs) and answers as without them.
"""

import io
import json

import jax
import pytest

import transformer_tpu.obs as jobs
import transformer_tpu_torch.obs as tobs
from transformer_tpu.config import ModelConfig as JConfig
from transformer_tpu.data.tokenizer import SubwordTokenizer as JTokenizer
from transformer_tpu.models import transformer_init
from transformer_tpu.serve import ContinuousScheduler as JScheduler
from transformer_tpu.serve import PrefixCache as JPrefixCache
from transformer_tpu.serve import resilience as jresilience
from transformer_tpu.train.checkpoint import _flatten
from transformer_tpu_torch.config import ModelConfig
from transformer_tpu_torch.convert import export_params, params_from_numpy
from transformer_tpu_torch.data.tokenizer import SubwordTokenizer
from transformer_tpu_torch.serve import resilience
from transformer_tpu_torch.serve.prefix_cache import PrefixCache
from transformer_tpu_torch.serve.scheduler import ContinuousScheduler

CASES = {
    "dense": dict(kv_layout="dense"),
    "paged_flash": dict(kv_layout="paged", decode_kernel="paged_flash", kv_block=4),
    "paged_flash_spec_prefix": dict(kv_layout="paged", decode_kernel="paged_flash",
                                    speculate_k=2, prefix=True),
    "dense_spec_prefix_chunked": dict(kv_layout="dense", speculate_k=2, prefix=True,
                                      prefill_chunk=4),
}
REQS = [
    {"prompt": "ab cd ef gh ij", "max_new": 6},
    {"prompt": "kl", "max_new": 2},
    {"prompt": "ab cd ef gh ij kl", "max_new": 4},
    {"prompt": "ab " * 40, "max_new": 2},  # over the slot budget: a validation error
    {"prompt": "mn ef cd ab cd", "max_new": 3},
    {"prompt": "ab cd ef gh ij mn", "max_new": 5},
]
ROUTING = {"error": "LM export serves 'prompt', not 'src'", "code": "routing"}


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    jtok = JTokenizer.build_from_corpus(["ab cd ef gh ij kl mn"] * 3, target_vocab_size=300)
    d = tmp_path_factory.mktemp("serve_tel")
    jtok.save(str(d / "tiny.subwords"))
    tok = SubwordTokenizer.load(str(d / "tiny.subwords"))
    kw = dict(num_layers=1, d_model=16, num_heads=2, dff=32,
              input_vocab_size=tok.model_vocab_size, target_vocab_size=tok.model_vocab_size,
              max_position=32, decoder_only=True, tie_output=True, dtype="float32",
              dropout_rate=0.0)
    jparams = transformer_init(jax.random.PRNGKey(0), JConfig(**kw))
    cfg = ModelConfig(**kw)
    params = params_from_numpy(_flatten(jparams), cfg, device="cpu")
    export_params(params, cfg, str(d / "export"))
    return dict(jtok=jtok, tok=tok, jparams=jparams, jcfg=JConfig(**kw), params=params,
                cfg=cfg, dir=d)


def _telemetry(pkg, buf):
    tel = pkg.Telemetry(events=pkg.EventLog(buf), interval=1e9, trace=True)
    tel.arm_profiler(baseline={})
    return tel


def _jax(lm, case, telemetry=None, slos=None):
    kw = {k: v for k, v in CASES[case].items() if k != "prefix"}
    if CASES[case].get("prefix"):
        kw["prefix_cache"] = JPrefixCache(lm["jcfg"], block_tokens=4, budget_mb=1)
    return JScheduler(lm["jparams"], lm["jcfg"], lm["jtok"], num_slots=2, max_total=32,
                      default_max_new=4, telemetry=telemetry, slos=slos, **kw)


def _port(lm, case, telemetry=None, slos=None):
    kw = {k: v for k, v in CASES[case].items() if k != "prefix"}
    if CASES[case].get("prefix"):
        kw["prefix_cache"] = PrefixCache(lm["cfg"], block_tokens=4, budget_mb=1)
    return ContinuousScheduler(lm["params"], lm["cfg"], lm["tok"], num_slots=2, max_total=32,
                               default_max_new=4, telemetry=telemetry, slos=slos,
                               device="cpu", **kw)


def _serve(sched):
    sched.submit_done(dict(ROUTING))
    return sched.run([dict(r) for r in REQS])


def _events(buf):
    return [json.loads(line) for line in buf.getvalue().splitlines()]


def _requests(events):
    return sorted((e for e in events if e["kind"] == "serve.request"), key=lambda e: e["order"])


def _trees(events):
    """Per request (by order): its spans' sorted (name, parent name, lane)."""
    spans = [e for e in events if e["kind"] == "trace.span"]
    names = {e["span"]: e["name"] for e in spans}
    by_trace = {}
    for e in spans:
        by_trace.setdefault(e["trace"], []).append(
            (e["name"], names.get(e.get("parent")), e.get("lane")))
    out = {}
    for req in _requests(events):
        out[req["order"]] = sorted(by_trace.get(req.get("trace"), []))
    steps = {}
    for e in spans:
        if e["name"].startswith(("scheduler.", "spec.")):
            steps[e["name"]] = steps.get(e["name"], 0) + 1
    return out, steps


@pytest.mark.parametrize("case", sorted(CASES))
def test_serve_telemetry_matches_jax(lm, case):
    jbuf, tbuf = io.StringIO(), io.StringIO()
    jtel, ttel = _telemetry(jobs, jbuf), _telemetry(tobs, tbuf)
    jans = _serve(_jax(lm, case, jtel))
    tans = _serve(_port(lm, case, ttel))
    plain = _serve(_port(lm, case))
    # Inert, and JAX's answers (greedy, fp32).
    assert json.dumps(tans) == json.dumps(plain)
    assert tans == jans
    jtel.close()
    ttel.close()
    jev, tev = _events(jbuf), _events(tbuf)
    jreq, treq = _requests(jev), _requests(tev)
    assert [sorted(e) for e in treq] == [sorted(e) for e in jreq]
    for key in ("order", "prompt_tokens", "new_tokens", "prefix_hit_tokens", "error", "code"):
        assert [e.get(key) for e in treq] == [e.get(key) for e in jreq], key
    assert _trees(tev) == _trees(jev)
    jnames = sorted(k for e in jev if e["kind"] == "metrics.snapshot" for k in e["metrics"])
    tnames = sorted(k for e in tev if e["kind"] == "metrics.snapshot" for k in e["metrics"])
    assert tnames == jnames
    snap = [e for e in tev if e["kind"] == "metrics.snapshot"][-1]["metrics"]
    program = ("serve.pool_verify" if CASES[case].get("speculate_k") else "serve.pool_step")
    program += {"dense": "", "paged": "_paged_flash"}[CASES[case]["kv_layout"]]
    steps = [e for e in tev if e["kind"] == "trace.span" and e["name"] == "scheduler.step"]
    assert snap[f"perf_seconds_{program.replace('.', '_')}"]["count"] == len(steps)
    assert snap["serve_steps_total"] == len(steps)


@pytest.mark.parametrize("spec", ["availability:objective=0.999",
                                  "ttft_p95:threshold=0.000001;deadline_miss:objective=0.9"])
def test_slo_spec_and_burn_events_match_jax(lm, spec):
    assert [s.name for s in tobs.parse_slo_spec(spec)] == [
        s.name for s in jobs.parse_slo_spec(spec)]
    jbuf, tbuf = io.StringIO(), io.StringIO()
    jtel, ttel = _telemetry(jobs, jbuf), _telemetry(tobs, tbuf)
    _serve(_jax(lm, "dense", jtel, slos=spec))
    _serve(_port(lm, "dense", ttel, slos=spec))
    jtel.close()
    ttel.close()

    def burns(buf):
        return [(e["name"], e["breached"]) for e in _events(buf) if e["kind"] == "slo.burn"]

    assert burns(tbuf) == burns(jbuf) and burns(tbuf)
    gauges = [k for e in _events(tbuf) if e["kind"] == "metrics.snapshot"
              for k in e["metrics"] if k.startswith("serve_slo_burn_")]
    assert gauges


def test_obs_emit_fault_point_fires_as_jaxs(lm):
    spec = "obs.emit:at=3+7"
    outs = {}
    for pkg, res, build in ((jobs, jresilience, _jax), (tobs, resilience, _port)):
        buf = io.StringIO()
        from transformer_tpu_torch.obs.breaker import CircuitBreaker

        tel = pkg.Telemetry(events=pkg.EventLog(buf, breaker=CircuitBreaker(
            "event_sink", threshold=5, cooldown_s=30.0)), interval=1e9, trace=True)
        with res.active(res.FaultPlane.parse(spec)) as plane:
            answers = _serve(build(lm, "dense", tel))
        tel.close()
        outs[pkg.__name__] = (answers, plane.fired_log, [
            (e["kind"], e.get("name")) for e in _events(buf)])
    assert outs["transformer_tpu_torch.obs"] == outs["transformer_tpu.obs"]
    assert outs["transformer_tpu_torch.obs"][1] == [("obs.emit", 3), ("obs.emit", 7)]


def test_cli_serve_telemetry(lm, tmp_path, capsys):
    from transformer_tpu_torch.cli import serve
    from transformer_tpu_torch.obs.__main__ import main as obs_main

    lines = "".join(json.dumps(r) + "\n" for r in REQS) + '{"src": "x"}\n'
    base = ["--device=cpu", "--export_path", str(lm["dir"] / "export"), "--tgt_vocab_file",
            str(lm["dir"] / "tiny.subwords"), "--serve_slots", "2", "--max_len", "4",
            "--kv_layout", "paged", "--decode_kernel", "paged_flash", "--prefix_block", "4"]
    plain, traced = io.StringIO(), io.StringIO()
    serve.main(base, stdin=io.StringIO(lines), stdout=plain)
    path = str(tmp_path / "s.jsonl")
    sched = serve.main(base + ["--metrics_jsonl", path, "--trace"], stdin=io.StringIO(lines),
                       stdout=traced)
    assert traced.getvalue() == plain.getvalue()
    assert sched._slo is not None  # '' = the default objectives with telemetry on
    events = tobs.read_events(path)
    assert sum(e["kind"] == "serve.request" for e in events) == len(REQS) + 1
    capsys.readouterr()
    assert obs_main(["summarize", path]) == 0
    out = capsys.readouterr().out
    assert "perf:" in out and "serve.pool_step_paged_flash" in out and "slo" in out
    assert obs_main(["trace", path, "--out", str(tmp_path / "t.json")]) == 0
    with open(tmp_path / "t.json") as f:
        trace = json.load(f)
    roots = [e for e in trace["traceEvents"]
             if e.get("name") == "serve.request" and "parent" not in e.get("args", {})]
    assert len(roots) == len(REQS) + 1
    # --slo_spec without telemetry is accepted and evaluates nothing.
    sched = serve.main(base + ["--slo_spec", "availability:objective=0.9"],
                       stdin=io.StringIO(lines), stdout=io.StringIO())
    assert sched._slo is None
