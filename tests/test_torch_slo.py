"""The port's SLO module (``transformer_tpu_torch/obs/slo.py``) against the
JAX package's ``obs/slo.py``, ported from ``tests/test_slo.py``: the spec
grammar and its refusals, per-span sampling, the hand-computed burn rates
of the offline report, and the streaming engine's gauges, breach
transition events, pruning and interval, each on the same inputs in both
packages. The scheduler cases feed the engine from each package's
``span_tap`` (the fleet's side channel; the port's scheduler keeps no
engine of its own until its telemetry lands).
"""

from __future__ import annotations

import dataclasses
import io
import json

import pytest

from transformer_tpu.obs import EventLog, MetricsRegistry
from transformer_tpu.obs import slo as jslo
from transformer_tpu_torch.obs import slo as tslo


def _specs(specs):
    return [dataclasses.astuple(s) for s in specs]


def test_parse_slo_spec_grammar():
    spec = ("availability:objective=0.999,windows=60+600;ttft_p95:threshold=0.5;"
            "acceptance_rate:objective=0.6,name=floor")
    got = tslo.parse_slo_spec(spec)
    assert _specs(got) == _specs(jslo.parse_slo_spec(spec))
    by_name = {s.name: s for s in got}
    assert by_name["availability"].windows == (60.0, 600.0)
    assert by_name["ttft_p95"].threshold_s == 0.5 and by_name["ttft_p95"].objective == 0.95
    assert by_name["floor"].kind == "acceptance_rate"
    assert tslo.parse_slo_spec("none") == () and tslo.parse_slo_spec("off") == ()


@pytest.mark.parametrize("bad", [
    "nonsense_kind",
    "availability:objective=1.5",
    "availability:objective",
    "availability:frobnicate=1",
    "ttft_p95:objective=0.95,threshold=0",
    "availability;availability",
    "availability:windows=0+60",
])
def test_parse_slo_spec_rejects(bad):
    with pytest.raises(ValueError) as got:
        tslo.parse_slo_spec(bad)
    with pytest.raises(ValueError) as want:
        jslo.parse_slo_spec(bad)
    assert str(got.value) == str(want.value)


def test_default_slos_are_jax():
    assert _specs(tslo.DEFAULT_SLOS) == _specs(jslo.DEFAULT_SLOS)
    assert tslo.DEFAULT_WINDOWS == jslo.DEFAULT_WINDOWS


def test_span_sample_per_kind():
    spans = [
        {"order": 1, "ttft_s": 0.2, "total_s": 1.0},
        {"order": 2, "ttft_s": 0.9, "total_s": 1.0},
        {"order": 3, "error": "boom", "code": "internal"},
        {"order": 4, "error": "deadline_ms elapsed", "code": "deadline"},
        {"order": 5, "ttft_s": 0.1, "drafted": 8, "draft_accepted": 6},
    ]
    for mod_args in (("a", "availability", 0.99), ("d", "deadline_miss", 0.99),
                     ("r", "acceptance_rate", 0.5)):
        for span in spans:
            assert tslo.span_sample(tslo.SLOSpec(*mod_args), span) == \
                jslo.span_sample(jslo.SLOSpec(*mod_args), span)
    for span in spans:
        assert tslo.span_sample(tslo.SLOSpec("t", "ttft_p95", 0.95, threshold_s=0.5), span) == \
            jslo.span_sample(jslo.SLOSpec("t", "ttft_p95", 0.95, threshold_s=0.5), span)
    assert tslo.span_sample(tslo.SLOSpec("r", "acceptance_rate", 0.5), spans[4]) == (2.0, 8.0)


def _req(ts, **fields):
    return {"kind": "serve.request", "ts": ts, **fields}


def _both_reports(events, make_specs, now):
    return (tslo.evaluate_slos(events, make_specs(tslo), now=now),
            jslo.evaluate_slos(events, make_specs(jslo), now=now))


def test_burn_rates_hand_computed_windows():
    now = 1_000_000.0
    events = []
    for i in range(20):
        events.append(_req(now - 1 - i * 2.5, order=i,
                           **({"error": "x", "code": "internal"} if i < 2 else {"ttft_s": 0.1})))
    for i in range(30):
        events.append(_req(now - 61 - i * 17, order=100 + i,
                           **({"error": "x", "code": "internal"} if i < 1 else {"ttft_s": 0.1})))
    got, want = _both_reports(
        events, lambda m: [m.SLOSpec("availability", "availability", 0.99,
                                     windows=(60.0, 600.0))], now)
    assert got == want
    w = got["slos"]["availability"]["windows"]
    assert (w["60s"]["bad"], w["60s"]["total"], w["60s"]["burn_rate"]) == (2, 20, 10.0)
    assert (w["600s"]["bad"], w["600s"]["total"], w["600s"]["burn_rate"]) == (3, 50, 6.0)
    assert got["slos"]["availability"]["breached"] is True


def test_burn_requires_every_window_hot():
    now = 1_000_000.0
    events = [_req(now - 90 - i, order=i, error="x", code="internal") for i in range(4)]
    events += [_req(now - 5 - i, order=10 + i, ttft_s=0.1) for i in range(6)]
    got, want = _both_reports(
        events, lambda m: [m.SLOSpec("availability", "availability", 0.9,
                                     windows=(60.0, 600.0))], now)
    assert got == want
    w = got["slos"]["availability"]["windows"]
    assert w["60s"]["burn_rate"] == 0.0 and w["600s"]["burn_rate"] == 4.0
    assert got["slos"]["availability"]["breached"] is False


def test_ttft_and_acceptance_weighted_math():
    now = 500.0
    events = [
        _req(now - 10, order=0, ttft_s=0.2, drafted=10, draft_accepted=9),
        _req(now - 20, order=1, ttft_s=2.0, drafted=30, draft_accepted=15),
        _req(now - 30, order=2, ttft_s=0.1),
        _req(now - 40, order=3, error="x", code="internal"),
    ]
    got, want = _both_reports(events, lambda m: [
        m.SLOSpec("ttft", "ttft_p95", 0.95, threshold_s=1.0, windows=(100.0,)),
        m.SLOSpec("acc", "acceptance_rate", 0.5, windows=(100.0,)),
    ], now)
    assert got == want
    assert got["slos"]["ttft"]["windows"]["100s"]["burn_rate"] == round((1 / 3) / 0.05, 4)
    assert got["slos"]["acc"]["windows"]["100s"]["burn_rate"] == 0.8
    assert tslo.render_slo_text(got) == jslo.render_slo_text(want)


def test_no_samples_reports_none_not_breach():
    got, want = _both_reports([], lambda m: [m.SLOSpec("availability", "availability", 0.99)],
                              100.0)
    assert got == want
    assert all(x["burn_rate"] is None
               for x in got["slos"]["availability"]["windows"].values())
    assert got["slos"]["availability"]["breached"] is False


class _Gauges:
    """A minimal registry for the port's engine: ``gauge(name, help)``
    with ``set`` / ``value``."""

    def __init__(self):
        self.gauges = {}

    def gauge(self, name, help=""):
        return self.gauges.setdefault(name, _Gauge())


class _Gauge:
    value = 0.0

    def set(self, v):
        self.value = v


def test_engine_gauges_and_breach_transition_events():
    def run(mod, registry, emit, read_gauge, read_events):
        clock = [1000.0]
        spec = mod.SLOSpec("availability", "availability", 0.9, windows=(60.0, 600.0))
        eng = mod.SLOEngine([spec], registry=registry, emit=emit, interval=0.0,
                            clock=lambda: clock[0])
        trail = []
        for i in range(8):
            eng.record({"order": i, "ttft_s": 0.1})
        eng.evaluate()
        trail.append(read_gauge())
        for i in range(8):
            eng.record({"order": 10 + i, "error": "x", "code": "internal"})
        trail.append(eng.evaluate())
        trail.append(read_gauge())
        eng.evaluate()
        clock[0] += 70.0
        for i in range(4):
            eng.record({"order": 20 + i, "ttft_s": 0.1})
        trail.append(eng.evaluate())
        trail.append(read_events())
        return trail

    buf = io.StringIO()
    log = EventLog(buf)
    reg = MetricsRegistry()
    want = run(jslo, reg, log.emit, lambda: reg.gauge("serve_slo_burn_availability").value,
               lambda: [{k: v for k, v in json.loads(line).items() if k != "ts"}
                        for line in buf.getvalue().splitlines()])
    events, gauges = [], _Gauges()
    got = run(tslo, gauges, lambda kind, **f: events.append({"kind": kind, **f}),
              lambda: gauges.gauges["serve_slo_burn_availability"].value, lambda: list(events))
    assert got == want
    assert got[0] == 0.0 and got[2] == 5.0
    assert [e["breached"] for e in got[4]] == [True, False]


def test_engine_prunes_beyond_longest_window():
    clock = [0.0]
    eng = tslo.SLOEngine([tslo.SLOSpec("availability", "availability", 0.9, windows=(10.0,))],
                         interval=0.0, clock=lambda: clock[0])
    for i in range(100):
        eng.record({"order": i})
    clock[0] = 1000.0
    eng.evaluate()
    assert len(eng._samples["availability"]) == 0


def test_engine_maybe_evaluate_honors_interval():
    def run(mod):
        clock = [0.0]
        eng = mod.SLOEngine([mod.SLOSpec("availability", "availability", 0.9)],
                            interval=5.0, clock=lambda: clock[0])
        trail = [eng.maybe_evaluate() is not None, eng.maybe_evaluate() is not None]
        clock[0] += 6.0
        return trail + [eng.maybe_evaluate() is not None,
                        eng.maybe_evaluate(force=True) is not None]

    assert run(tslo) == run(jslo) == [True, False, True, True]


# --------------------------------------------------------------------------
# the engine fed from each scheduler's span tap


@pytest.fixture(scope="module")
def lm():
    from torch_fleet import jax_model, port_model

    model = jax_model()
    return model, port_model(model)


REQS = [{"prompt": "ab cd ef", "max_new": 3}, {"prompt": "ab " * 40, "max_new": 2},
        {"prompt": "kl", "max_new": 2}]


def _tapped(lm):
    from transformer_tpu.serve import ContinuousScheduler as JScheduler
    from transformer_tpu_torch.serve.scheduler import ContinuousScheduler

    (jparams, jcfg, jtok), (params, cfg, tok) = lm
    taps, jtaps = [], []
    out = ContinuousScheduler(params, cfg, tok, num_slots=2, max_total=32, default_max_new=4,
                              span_tap=taps.append, device="cpu").run([dict(r) for r in REQS])
    want = JScheduler(jparams, jcfg, jtok, num_slots=2, max_total=32, default_max_new=4,
                      span_tap=jtaps.append).run([dict(r) for r in REQS])
    return out, want, taps, jtaps


def test_span_tap_feeds_the_engine_as_jax_does(lm):
    """Answers are the same with the tap; the engine over each package's
    tapped spans (a fixed clock) reports the same windows: the over-length
    request answers an error at admission and is never tapped, in both."""
    out, want, taps, jtaps = _tapped(lm)
    assert out == want and "error" in out[1]

    def report(mod, spans):
        eng = mod.SLOEngine(mod.parse_slo_spec("availability:objective=0.9,windows=60+600"),
                            interval=0.0, clock=lambda: 50.0)
        for span in spans:
            eng.record(span)
        return eng.evaluate()

    assert report(tslo, taps) == report(jslo, jtaps)
    assert sorted(t["order"] for t in taps) == sorted(t["order"] for t in jtaps) == [0, 2]


def test_evaluate_slos_over_tapped_spans(lm):
    """The offline report over the tapped spans as ``serve.request``
    events: the same report in both packages."""
    _, _, taps, jtaps = _tapped(lm)

    def events(spans):
        return [{"kind": "serve.request", "ts": 10.0 + i, **{k: v for k, v in s.items()
                                                              if k != "ttft_s"},
                 "ttft_s": 0.5} for i, s in enumerate(spans)]

    got = tslo.evaluate_slos(events(taps), tslo.DEFAULT_SLOS, now=20.0)
    want = jslo.evaluate_slos(events(jtaps), jslo.DEFAULT_SLOS, now=20.0)
    assert got == want and got["requests"] == 2


def test_router_slos_off_with_none(lm):
    """``slos="none"`` gives the router no engine; a spec string gives one."""
    from torch_fleet import PACKAGES, fake_link_class

    for pkg in PACKAGES.values():
        Fake = fake_link_class(pkg)
        assert pkg.Router([Fake(0, "f0")], encode=None, slos="none")._slo_engine is None
        assert pkg.Router([Fake(0, "f0")], encode=None,
                          slos="availability")._slo_engine is not None
