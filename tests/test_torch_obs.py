"""The port's telemetry package (``transformer_tpu_torch.obs``) against the
JAX package's (``transformer_tpu.obs``): the same inputs, made from numpy
seeds, give the same outputs, byte for byte where the JAX package renders
text or JSON.

- ``StreamingHistogram``: equal snapshots (quantiles, counts, tails);
- ``MetricsRegistry``: byte-identical Prometheus text and equal snapshots;
- the ``obs`` CLI (``summarize`` text and JSON, ``trace``, ``slo``,
  ``roofline``, ``postmortem``, ``--merge`` / ``--last``) byte-identical
  on the same event files: a synthetic episode covering every section,
  and a log written by JAX's ``EventLog`` from a JAX scheduler run;
- ``summarize_events`` / ``render_text``, ``chrome_trace``,
  ``merge_events`` / ``filter_events`` and ``roofline_report`` equal as
  functions;
- the flight recorder's dump has the JAX recorder's keys, and its SIGTERM
  dump leaves the trainer's ``PreemptionGuard`` able to checkpoint;
- the import rule: nothing under ``transformer_tpu_torch/obs`` imports
  torch, numpy, jax or ``transformer_tpu``; every literal ``emit`` kind in
  the port is in the event catalogue; the port's roofline bank carries the
  H100's memory rate and no TPU figure.
"""

import ast
import io
import json
import os
import pathlib
import signal
import urllib.request

import numpy as np
import pytest

import transformer_tpu.obs as jobs
import transformer_tpu.obs.__main__ as jmain
import transformer_tpu.obs.profile as jprofile
import transformer_tpu_torch.obs as tobs
import transformer_tpu_torch.obs.__main__ as tmain
import transformer_tpu_torch.obs.profile as tprofile
from transformer_tpu.obs.flight import FlightRecorder as JFlight
from transformer_tpu_torch.obs.flight import FlightRecorder as TFlight

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_OBS = REPO / "transformer_tpu_torch" / "obs"


@pytest.fixture(autouse=True)
def same_bank(monkeypatch):
    """Both CLIs join against the JAX package's bank, so ``summarize``'s
    perf section (which reads the default bank) compares like for like;
    the port's own bank is tested on its own below."""
    monkeypatch.setattr(tprofile, "BASELINE_PATH", jprofile.BASELINE_PATH)


# --------------------------------------------------------------------------
# primitives


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_streaming_histogram_snapshots_equal(seed):
    rng = np.random.default_rng(seed)
    samples = rng.lognormal(mean=-5.0, sigma=2.0, size=4000)
    samples[:5] = [0.0, 1e-12, 1e9, 3.5, 7.25]  # under/overflow and exact values
    j, t = jobs.StreamingHistogram(), tobs.StreamingHistogram()
    for i, x in enumerate(samples.tolist()):
        n = 1 + i % 3
        j.observe(x, n=n)
        t.observe(x, n=n)
    assert t.snapshot() == j.snapshot()
    assert t.percentiles() == j.percentiles()
    assert list(t.buckets()) == list(j.buckets())


def _fill_registry(reg, seed: int) -> None:
    rng = np.random.default_rng(seed)
    c = reg.counter("serve_requests_total", "requests submitted")
    g = reg.gauge("serve_slots_active", "slots occupied")
    h = reg.histogram("serve_step_seconds", "one pool step")
    for x in rng.exponential(0.002, size=500).tolist():
        h.observe(x)
    c.inc(int(rng.integers(1, 50)))
    g.set(float(rng.integers(0, 8)))
    reg.gauge("train_loss", "loss").set(float(rng.normal()))
    reg.counter("train_tokens_total", "tokens").inc(float(rng.integers(1000, 9000)))


@pytest.mark.parametrize("seed", [0, 3])
def test_registry_prometheus_text_byte_identical(seed):
    j, t = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    _fill_registry(j, seed)
    _fill_registry(t, seed)
    # The exposition ends in "# EOF generated <unix time>": equal up to it.
    assert t.to_prometheus_text().rsplit("# EOF", 1)[0] == \
        j.to_prometheus_text().rsplit("# EOF", 1)[0]
    assert t.snapshot() == j.snapshot()


# --------------------------------------------------------------------------
# event files


def _synthetic_episode(path: str, seed: int, source: str) -> None:
    """One process's log written through the JAX package's sinks: serve
    requests with span trees (errors, prefix hits, drafts), train windows,
    memory and compile records, the profiler's streams in snapshots,
    breaker, retry, router, fleet, upgrade, SLO and flight events."""
    rng = np.random.default_rng(seed)
    tel = jobs.Telemetry(events=jobs.EventLog(path), interval=0.0, trace=True)
    prof = tel.arm_profiler(baseline={})
    tr = tel.tracer
    t0 = 1_700_000_000.0 + 10 * seed
    for order in range(12):
        root = tr.start_span("serve.request", lane="intake")
        q = tr.start_span("serve.queue", parent=root, lane="intake")
        q.end()
        root.lane = f"slot{order % 3}"
        pf = tr.start_span("serve.prefill", parent=root, lane=root.lane)
        pf.end(prompt_tokens=int(rng.integers(3, 40)))
        dec = tr.start_span("serve.decode", parent=root, lane=root.lane)
        dec.end(new_tokens=int(rng.integers(1, 9)))
        span = {
            "order": order, "prompt_tokens": int(rng.integers(3, 40)),
            "new_tokens": int(rng.integers(1, 9)),
            "queue_s": round(float(rng.exponential(0.01)), 6),
            "total_s": round(float(rng.exponential(0.2)), 6),
            "prefill_s": round(float(rng.exponential(0.02)), 6),
            "ttft_s": round(float(rng.exponential(0.05)), 6),
            "forwards": int(rng.integers(1, 9)),
            "prefix_hit_tokens": int(rng.integers(0, 16)),
            "drafted": int(rng.integers(0, 10)), "draft_accepted": int(rng.integers(0, 5)),
            "trace": root.ctx.trace_id, "ts": round(t0 + order, 6),
        }
        if order % 5 == 4:
            span = {"order": order, "total_s": 0.0, "error": "boom", "code": "validation",
                    "ts": round(t0 + order, 6)}
        root.end(order=order)
        tel.emit("serve.request", **span)
        prof.record("serve.pool_step_paged_flash", float(rng.exponential(0.001)), tokens=4)
        prof.record("serve.slot_prefill_paged", float(rng.exponential(0.003)), tokens=30)
        tel.registry.gauge("serve_slots_active", "slots").set(order % 4)
        tel.registry.gauge("serve_slots_total", "slots").set(4)
        tel.maybe_flush()
    tel.emit("serve.breaker", name="speculative", state="open", previous="closed",
             ts=round(t0 + 3.5, 6))
    tel.emit("serve.breaker", name="speculative", state="closed", previous="open",
             ts=round(t0 + 9.5, 6))
    tel.emit("serve.retry", order=2, attempt=1, backoff_ms=12.5, error="TransientError: x")
    tel.emit("serve.batch", size=4, errors=1, batch_s=0.125)
    for step in (8, 16):
        prof.record("train.step", float(rng.exponential(0.03)))
        tel.emit("train.window", epoch=1, step=step, steps=8, tokens=4096,
                 window_s=round(float(rng.uniform(0.1, 0.3)), 6),
                 loss=round(float(rng.normal(5, 1)), 6), accuracy=0.1, grad_norm=1.5)
    tel.emit("train.eval", epoch=1, step=16, loss=5.1, accuracy=0.12)
    tel.emit("train.memory", epoch=1, step=16,
             devices={"0": {"bytes_in_use": 1000, "peak_bytes_in_use": 2000}})
    tel.emit("train.compile", epoch=1, step=16,
             cache_sizes={"train_step": 0, "multi_step": 1, "eval_step": 0})
    tel.emit("route.dispatch", order=1, replica="replica0", policy="affinity", stage=None,
             redispatch=0, weight_version=None, trace="ab" * 16)
    tel.emit("route.dispatch", order=2, replica="replica1", policy="least_loaded",
             stage=None, redispatch=1, weight_version="v1", trace="cd" * 16)
    tel.emit("route.failover", replica="replica1", reason="eof", orders=[2],
             traces=["cd" * 16])
    tel.emit("route.spawn", replica="replica1", heal_s=12.5, warmed_tokens=64)
    tel.emit("route.scale", direction="down", signal="ttft_p95", burn_rate=0.0,
             fleet_size=1, evidence={"w": 1})
    tel.emit("route.retire", replica="replica1")
    tel.emit("route.upgrade", phase="completed", version="v1", time_to_upgrade_s=3.25)
    tel.emit("slo.burn", name="ttft_p95", breached=True, burn={"short": 2.0, "long": 1.5})
    tel.emit("perf.drift", program="train.step", ratio=6.0, band=[0.2, 5.0],
             measured_p50_s=0.06, baseline_p50_s=0.01, breached=True)
    rec = JFlight(None)
    rec.record("serve.request", {"order": 1, "ts": t0})
    tel.emit("route.postmortem", replica="replica1", origin="file", reason="auto",
             record=rec.snapshot_record("auto"))
    tel.close()
    del source


@pytest.fixture(scope="module")
def episodes(tmp_path_factory):
    d = tmp_path_factory.mktemp("episodes")
    paths = []
    for seed, name in ((0, "router.jsonl"), (1, "router.jsonl.r0"), (2, "router.jsonl.r1")):
        path = str(d / name)
        _synthetic_episode(path, seed, name)
        paths.append(path)
    # A truncated final line (a crash mid-write) must not change anything.
    with open(paths[1], "a") as f:
        f.write('{"ts": 1, "kind": "serve.req')
    flight = JFlight(str(d / "dead.flight.json"), source="replica1")
    for i in range(5):
        flight.record("serve.request", {"order": i, "total_s": 0.01 * i})
        flight.record("trace.span", {"trace": "ef" * 16, "span": f"{i:016x}", "name": "x",
                                     "t0": 1.0 + i, "dur_s": 0.5})
    flight.dump("auto")
    return d, paths


def _cli(main, argv, capsys) -> tuple[int, str]:
    rc = main(argv)
    return rc, capsys.readouterr().out


CLI_CASES = {
    "summarize": lambda p, d: ["summarize", p[0]],
    "summarize_json": lambda p, d: ["summarize", p[0], "--format", "json"],
    "summarize_merge": lambda p, d: ["summarize", *p],
    "summarize_merge_json": lambda p, d: ["summarize", *p, "--format", "json"],
    "summarize_last": lambda p, d: ["summarize", *p, "--last", "5s"],
    "slo": lambda p, d: ["slo", *p],
    "slo_spec_json": lambda p, d: ["slo", p[0], "--slo_spec",
                                   "availability:objective=0.99;ttft_p95:threshold=0.05",
                                   "--format", "json"],
    "roofline": lambda p, d: ["roofline", *p, "--baseline", jprofile.BASELINE_PATH],
    "roofline_json": lambda p, d: ["roofline", p[0], "--format", "json", "--baseline",
                                   jprofile.BASELINE_PATH],
    "postmortem": lambda p, d: ["postmortem", *p, str(d / "dead.flight.json")],
    "postmortem_json": lambda p, d: ["postmortem", p[0], str(d / "dead.flight.json"),
                                     "--format", "json"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_output_byte_identical(episodes, case, capsys):
    d, paths = episodes
    argv = CLI_CASES[case](paths, d)
    jrc, jout = _cli(jmain.main, argv, capsys)
    trc, tout = _cli(tmain.main, argv, capsys)
    assert (trc, tout) == (jrc, jout)
    assert tout.strip()


@pytest.mark.parametrize("merge", [False, True])
def test_trace_export_byte_identical(episodes, tmp_path, merge, capsys):
    _, paths = episodes
    inputs = paths if merge else paths[:1]
    jrc, jout = _cli(jmain.main, ["trace", *inputs, "--out", str(tmp_path / "j.json")], capsys)
    trc, tout = _cli(tmain.main, ["trace", *inputs, "--out", str(tmp_path / "t.json")], capsys)
    assert (trc, tout.replace("t.json", "j.json")) == (jrc, jout)
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()


def test_functions_agree_on_the_same_event_lists(episodes):
    _, paths = episodes
    jev, jinfo = jobs.merge_events(paths)
    tev, tinfo = tobs.merge_events(paths)
    assert (tev, tinfo) == (jev, jinfo)
    for kw in ({"last": 4.0}, {"since": jev[len(jev) // 2]["ts"]}):
        assert tobs.filter_events(tev, **kw) == jobs.filter_events(jev, **kw)
    assert json.dumps(tobs.chrome_trace(tev)) == json.dumps(jobs.chrome_trace(jev))
    report = tmain.summarize_events(tev)
    assert report == jmain.summarize_events(jev)
    assert tmain.render_text(report) == jmain.render_text(report)
    bank = jprofile.load_baseline()
    assert tprofile.roofline_report(tev, baseline=bank) == jprofile.roofline_report(
        jev, baseline=bank)
    assert tobs.evaluate_slos(tev, tobs.DEFAULT_SLOS) == jobs.evaluate_slos(
        jev, jobs.DEFAULT_SLOS)


def test_summarize_on_a_jax_scheduler_log(tmp_path, capsys):
    """A log written by JAX's EventLog from a traced JAX scheduler run."""
    import jax

    from transformer_tpu.config import ModelConfig
    from transformer_tpu.data.tokenizer import SubwordTokenizer
    from transformer_tpu.models import transformer_init
    from transformer_tpu.serve import ContinuousScheduler

    tok = SubwordTokenizer.build_from_corpus(["ab cd ef gh ij kl mn"] * 3,
                                             target_vocab_size=300)
    cfg = ModelConfig(num_layers=1, d_model=16, num_heads=2, dff=32,
                      input_vocab_size=tok.model_vocab_size,
                      target_vocab_size=tok.model_vocab_size, max_position=32,
                      decoder_only=True, tie_output=True, dtype="float32", dropout_rate=0.0)
    params = transformer_init(jax.random.PRNGKey(0), cfg)
    path = str(tmp_path / "jax.jsonl")
    tel = jobs.Telemetry(events=jobs.EventLog(path), interval=0.0, trace=True)
    tel.arm_profiler(baseline={})
    sched = ContinuousScheduler(params, cfg, tok, num_slots=2, max_total=32,
                                default_max_new=4, telemetry=tel, slos=jobs.DEFAULT_SLOS)
    sched.run([{"prompt": "ab cd ef gh ij", "max_new": 5}, {"prompt": "kl", "max_new": 2},
               {"prompt": "mn ef", "max_new": 3}])
    tel.close()
    for argv in (["summarize", path], ["summarize", path, "--format", "json"],
                 ["slo", path], ["roofline", path, "--baseline", jprofile.BASELINE_PATH]):
        assert _cli(tmain.main, argv, capsys) == _cli(jmain.main, argv, capsys), argv
    events = jobs.read_events(path)
    assert tobs.read_events(path) == events
    assert json.dumps(tobs.chrome_trace(events)) == json.dumps(jobs.chrome_trace(events))


# --------------------------------------------------------------------------
# flight recorder


def _fill_flight(rec) -> None:
    for i in range(300):
        kind = ("trace.span", "metrics.snapshot", "serve.request")[i % 3]
        rec.record(kind, {"i": i, "ts": 1.0 + i})


def test_flight_dump_keys_equal(tmp_path):
    j = JFlight(str(tmp_path / "j.flight.json"), capacity=16, snapshots=4, source="r0")
    t = TFlight(str(tmp_path / "t.flight.json"), capacity=16, snapshots=4, source="r0")
    _fill_flight(j)
    _fill_flight(t)
    jr, tr_ = j.dump("request"), t.dump("request")
    assert sorted(tr_) == sorted(jr)
    for key in ("events", "spans", "snapshots"):
        assert tr_[key] == jr[key]
    on_disk = json.loads((tmp_path / "t.flight.json").read_text())
    assert sorted(on_disk) == sorted(json.loads((tmp_path / "j.flight.json").read_text()))
    from transformer_tpu_torch.obs.flight import flight_path_for, load_flight_record

    assert flight_path_for("x.jsonl") == "x.jsonl.flight.json"
    assert load_flight_record(str(tmp_path / "t.flight.json"))["events"] == tr_["events"]
    assert load_flight_record(str(tmp_path / "missing.json")) is None


def test_sigterm_with_the_flight_recorder_armed_still_latches_the_guard(tmp_path):
    """A user's SIGTERM handler, then the recorder (which chains to it),
    then the trainer's guard: the first signal dumps, runs the user's
    handler and latches the graceful stop, so the trainer checkpoints; a
    second signal runs the whole chain again."""
    from transformer_tpu_torch.utils.preemption import PreemptionGuard

    original = signal.getsignal(signal.SIGTERM)
    calls = []
    try:
        signal.signal(signal.SIGTERM, lambda num, frame: calls.append(num))
        rec = TFlight(str(tmp_path / "p.flight.json"))
        rec.record("train.window", {"step": 1})
        rec.install_signal_handlers()
        with PreemptionGuard() as guard:
            os.kill(os.getpid(), signal.SIGTERM)
            assert guard.should_stop and guard.signal_received == signal.SIGTERM
            assert calls == [signal.SIGTERM]  # the user's handler ran on the first
            assert json.loads((tmp_path / "p.flight.json").read_text())["reason"] == "signal"
            os.kill(os.getpid(), signal.SIGTERM)  # the second: the whole chain
            assert calls == [signal.SIGTERM] * 2
    finally:
        signal.signal(signal.SIGTERM, original)


def test_guard_over_the_recorder_skips_only_the_sig_dfl_reraise(tmp_path):
    """Under SIG_DFL the recorder's whole handler would end the process
    after its dump; the guard, installed after it, runs the dump and
    survives the first signal, latched."""
    from transformer_tpu_torch.utils.preemption import PreemptionGuard

    original = signal.getsignal(signal.SIGTERM)
    try:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        rec = TFlight(str(tmp_path / "d.flight.json"))
        rec.install_signal_handlers()
        with PreemptionGuard() as guard:
            os.kill(os.getpid(), signal.SIGTERM)
            assert guard.should_stop and guard.signal_received == signal.SIGTERM
            assert json.loads((tmp_path / "d.flight.json").read_text())["reason"] == "signal"
    finally:
        signal.signal(signal.SIGTERM, original)


# --------------------------------------------------------------------------
# sinks


def test_event_log_obs_emit_fault_point(tmp_path):
    """``obs.emit`` fires inside EventLog.emit's write, through the
    resilience plane's ``fault_hook`` slot, and feeds the sink breaker."""
    from transformer_tpu_torch.obs import events
    from transformer_tpu_torch.obs.breaker import CircuitBreaker
    from transformer_tpu_torch.serve import resilience

    path = tmp_path / "e.jsonl"
    log = tobs.EventLog(str(path), breaker=CircuitBreaker("event_sink", threshold=3,
                                                            cooldown_s=30.0))
    with resilience.active(resilience.FaultPlane.parse("obs.emit:at=2+3")) as plane:
        assert events.fault_hook is not None
        for i in range(4):
            log.emit("serve.request", order=i)
    assert events.fault_hook is None
    assert plane.fired_log == [("obs.emit", 2), ("obs.emit", 3)]
    log.close()
    assert [e["order"] for e in tobs.read_events(str(path))] == [0, 3]


def test_telemetry_prom_file_and_http_endpoint(tmp_path):
    tel = tobs.Telemetry(events=tobs.EventLog(str(tmp_path / "m.jsonl")),
                         prom_path=str(tmp_path / "m.jsonl.prom"), interval=0.0)
    _fill_registry(tel.registry, 5)
    tel.arm_flight(str(tmp_path / "m.jsonl.flight.json"))
    assert tel.maybe_flush()
    ref = jobs.MetricsRegistry()
    _fill_registry(ref, 5)
    ref.gauge("flight_depth", "entries currently held in the flight-recorder ring").set(1)
    # Equal up to the exposition's "# EOF generated <unix time>" stamp.
    def body(text):
        return text.rsplit("# EOF generated", 1)[0]

    assert body((tmp_path / "m.jsonl.prom").read_text()) == body(ref.to_prometheus_text())
    port = tel.start_prometheus_server(0)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
            assert body(r.read().decode()) == body(tel.registry.to_prometheus_text())
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
            doc = json.loads(r.read())
        assert doc["ok"] and doc["flight"]["depth"] >= 1
    finally:
        tel.close()
    assert tel._server is None


def test_timed_profile_traced_call_chain():
    buf = io.StringIO()
    tel = tobs.Telemetry(events=tobs.EventLog(buf), trace=True)
    prof = tel.arm_profiler(baseline={})
    from transformer_tpu_torch.obs.profile import profile_call

    def fn(x):
        return x + 1

    h = tel.registry.histogram("d", "d")
    wrapped = tobs.traced_call(profile_call(tobs.timed_call(fn, h), prof, "train.step"),
                               tel.tracer, "train.step", lane="train")
    assert wrapped(1) == 2 and wrapped(2) == 3
    assert wrapped.__wrapped__.__wrapped__.__wrapped__ is fn
    assert h.hist.count == 2 and prof.summary()["train.step"]["dispatches"] == 2
    spans = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert [s["name"] for s in spans] == ["train.step", "train.step"]


# --------------------------------------------------------------------------
# the package's rules


def _imports(path: pathlib.Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
    return out


@pytest.mark.parametrize("path", sorted(PORT_OBS.glob("*.py")), ids=lambda p: p.name)
def test_obs_imports_no_torch_numpy_jax_or_the_jax_package(path):
    for name in _imports(path):
        root = name.split(".")[0]
        assert root not in ("torch", "numpy", "jax", "jaxlib", "transformer_tpu"), (path, name)


def test_importing_obs_loads_no_torch_or_numpy():
    import subprocess
    import sys

    code = ("import sys; import transformer_tpu_torch.obs, transformer_tpu_torch.obs.__main__, "
            "transformer_tpu_torch.obs.flight, transformer_tpu_torch.obs.profile; "
            "print(sorted(m for m in ('torch', 'numpy', 'jax') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(REPO), check=True).stdout
    assert out.strip() == "[]"


def _emitted_kinds() -> set[str]:
    kinds = set()
    for py in sorted((REPO / "transformer_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(py.read_text(encoding="utf-8"))):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            func = node.func
            name = func.attr if isinstance(func, ast.Attribute) else getattr(func, "id", None)
            a0 = node.args[0]
            if (name in ("emit", "emit_event", "_emit") and isinstance(a0, ast.Constant)
                    and isinstance(a0.value, str)):
                kinds.add(a0.value)
    return kinds


def test_event_catalogue_covers_every_emit_site():
    from transformer_tpu.obs.events import EVENT_CATALOGUE as JAX_CATALOGUE
    from transformer_tpu_torch.obs.events import EVENT_CATALOGUE

    emitted = _emitted_kinds()
    assert not emitted - set(EVENT_CATALOGUE), sorted(emitted - set(EVENT_CATALOGUE))
    assert set(EVENT_CATALOGUE) == set(JAX_CATALOGUE)
    for kind in ("serve.request", "serve.retry", "serve.breaker", "serve.batch",
                 "train.window", "train.eval", "train.memory", "train.compile",
                 "train.preempt", "route.dispatch", "route.postmortem", "metrics.snapshot",
                 "flight.dump", "perf.drift", "slo.burn", "trace.span"):
        assert kind in emitted, kind


def test_the_ports_bank_is_the_h100s():
    bank = json.loads((PORT_OBS / "roofline_baseline.json").read_text())
    assert bank["peak_bytes_per_s"] == 3.35e12 == tprofile.DEFAULT_PEAK_BYTES_PER_S
    assert all("bytes_moved" not in row and "p50_s" not in row
               for row in bank["programs"].values())
    assert set(bank["programs"]) <= set(tprofile.CANNED_PROGRAMS)
    for path in [*PORT_OBS.glob("*.py"), PORT_OBS / "roofline_baseline.json"]:
        text = path.read_text(encoding="utf-8")
        for figure in ("819", "8.19e11", "v5 lite", "v5e"):
            assert figure not in text, (path.name, figure)
    # Tolerant of the bank's missing predictions: measured columns only.
    prof = tprofile.ProgramProfiler(registry=tobs.MetricsRegistry(), baseline=bank)
    for x in np.random.default_rng(0).exponential(0.001, 16).tolist():
        prof.record("serve.pool_step_paged_flash", x, tokens=4)
    row = prof.summary()["serve.pool_step_paged_flash"]
    assert row["dispatches"] == 16 and row["tokens_per_s"] > 0
    assert "roofline_ratio" not in row and "drift" not in row
    report = tprofile.roofline_report([{"kind": "metrics.snapshot",
                                        "metrics": prof._registry.snapshot()}], baseline=bank)
    assert report["peak_bytes_per_s"] == 3.35e12
    assert [r["program"] for r in report["programs"]] == ["serve.pool_step_paged_flash"]
    assert tprofile.band_breaches(report) == []


def test_device_memory_stats_is_none_on_the_cpu():
    import torch

    from transformer_tpu_torch.device import device_memory_stats

    assert device_memory_stats(torch.device("cpu")) is None
