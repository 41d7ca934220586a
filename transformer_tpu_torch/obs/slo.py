"""Declarative SLOs evaluated as multi-window burn rates.

Port of ``transformer_tpu/obs/slo.py`` (standard library only), the whole
module: the spec shape (:class:`SLOSpec`, ``--slo_spec`` grammar in
:func:`parse_slo_spec`, :data:`DEFAULT_SLOS`), the per-span sampling
(:func:`span_sample`), the offline report over an event list
(:func:`evaluate_slos`) and the streaming :class:`SLOEngine`. The fleet's
router feeds its engine from the answer funnel (the replicas' per-answer
``slo`` side channel); the rollout coordinator keeps one engine per
weight version for the canary verdict (``serve/upgrade.py``).

Burn rate, per window: ``bad_fraction / (1 - objective)`` — 1.0 means
"exactly consuming the error budget", N means the budget is gone in
``window / N``. A spec BREACHES when every configured window burns > 1
simultaneously (the multi-window rule: the long window proves it
matters, the short window proves it is still happening).

==================  =====================================================
``availability``    bad = the request answered with an error
``ttft_p95``        bad = ``ttft_s`` above ``threshold_s`` (objective
                    0.95 = the p95 target; generalizes to any quantile)
``deadline_miss``   bad = the answer's taxonomy code is ``deadline``
``acceptance_rate`` weighted: bad = rejected draft tokens, total =
                    drafted (objective = the acceptance-rate floor)
==================  =====================================================

``SLOEngine(registry=...)`` takes any object whose ``gauge(name, help)``
returns something with ``set(value)``, and ``emit(kind, **fields)`` any
event sink; both are optional.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

SLO_KINDS = ("availability", "ttft_p95", "deadline_miss", "acceptance_rate")

#: Default multi-window pair (seconds): fast "is it still happening" and
#: slow "does it matter" — override per spec with ``windows=60+300``.
DEFAULT_WINDOWS = (300.0, 3600.0)


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One objective. ``objective`` is the good-fraction target (0.99 =
    "99% of requests succeed"; for ``acceptance_rate`` it is the floor);
    ``threshold_s`` parameterizes the latency kinds."""

    name: str
    kind: str
    objective: float
    threshold_s: float = 0.0
    windows: tuple = DEFAULT_WINDOWS

    def __post_init__(self):
        if self.kind not in SLO_KINDS:
            raise ValueError(
                f"unknown SLO kind {self.kind!r}; valid: {', '.join(SLO_KINDS)}"
            )
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"objective must be in (0, 1), got {self.objective} "
                f"({self.name})"
            )
        if self.kind == "ttft_p95" and self.threshold_s <= 0:
            raise ValueError(
                f"{self.name}: ttft_p95 needs threshold=<seconds> > 0"
            )
        if not self.windows or any(w <= 0 for w in self.windows):
            raise ValueError(f"{self.name}: windows must be positive")

    @property
    def budget(self) -> float:
        return 1.0 - self.objective


#: The serve tier's default objectives — deliberately loose (CI boxes and
#: laptops must not page themselves); production overrides via --slo_spec.
DEFAULT_SLOS = (
    SLOSpec("availability", "availability", 0.99),
    SLOSpec("ttft_p95", "ttft_p95", 0.95, threshold_s=2.0),
    SLOSpec("deadline_miss", "deadline_miss", 0.99),
    SLOSpec("acceptance_rate", "acceptance_rate", 0.5),
)


def parse_slo_spec(spec: str) -> "tuple[SLOSpec, ...]":
    """``--slo_spec`` grammar (mirrors ``--fault_spec``):

        spec   := clause (';' clause)*
        clause := kind [':' param (',' param)*]
        param  := 'objective=' float | 'threshold=' seconds
                | 'windows=' seconds('+' seconds)* | 'name=' str

    Example — 99.9% availability with tight windows, 500ms TTFT p95::

        availability:objective=0.999,windows=60+600;ttft_p95:threshold=0.5

    ``none`` (or ``off``) disables SLO evaluation entirely.
    """
    spec = spec.strip()
    if spec.lower() in ("none", "off"):
        return ()
    out = []
    for clause in spec.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        kind, _, params = clause.partition(":")
        kw: dict = {"kind": kind.strip(), "name": kind.strip()}
        for param in params.split(",") if params else []:
            key, sep, value = param.partition("=")
            key, value = key.strip(), value.strip()
            if not sep:
                raise ValueError(f"slo_spec param {param!r} is not key=value")
            if key == "objective":
                kw["objective"] = float(value)
            elif key == "threshold":
                kw["threshold_s"] = float(value)
            elif key == "windows":
                kw["windows"] = tuple(float(v) for v in value.split("+"))
            elif key == "name":
                kw["name"] = value
            else:
                raise ValueError(
                    f"unknown slo_spec key {key!r} (valid: objective, "
                    "threshold, windows, name)"
                )
        if "objective" not in kw:
            defaults = {s.kind: s for s in DEFAULT_SLOS}
            if kw["kind"] in defaults:
                kw.setdefault("objective", defaults[kw["kind"]].objective)
                if "threshold_s" not in kw:
                    kw["threshold_s"] = defaults[kw["kind"]].threshold_s
            else:
                raise ValueError(f"unknown SLO kind {kw['kind']!r}")
        out.append(SLOSpec(**kw))
    names = [s.name for s in out]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate SLO names in spec: {names}")
    return tuple(out)


def span_sample(spec: SLOSpec, span: dict) -> "tuple[float, float] | None":
    """One ``serve.request`` span dict -> ``(bad_weight, total_weight)``
    for this spec, or None when the span does not participate (e.g. a
    request that never drafted contributes nothing to the acceptance
    floor). The ONE place event fields map onto SLO arithmetic — the live
    engine and the offline report both call it."""
    if spec.kind == "availability":
        return (1.0 if "error" in span else 0.0), 1.0
    if spec.kind == "deadline_miss":
        return (1.0 if span.get("code") == "deadline" else 0.0), 1.0
    if spec.kind == "ttft_p95":
        ttft = span.get("ttft_s")
        if not isinstance(ttft, (int, float)):
            # Errored/tokenless requests have no first token; they are
            # availability's problem, not the latency SLO's.
            return None
        return (1.0 if ttft > spec.threshold_s else 0.0), 1.0
    if spec.kind == "acceptance_rate":
        drafted = span.get("drafted")
        if not isinstance(drafted, (int, float)) or drafted <= 0:
            return None
        accepted = span.get("draft_accepted", 0)
        accepted = accepted if isinstance(accepted, (int, float)) else 0
        return float(drafted - accepted), float(drafted)
    return None


def _window_burn(
    samples, now: float, spec: SLOSpec
) -> dict:
    """Burn rates over ``spec.windows`` for TIME-ORDERED (ts, bad, total)
    samples, in ONE newest-to-oldest pass: the live engine calls this
    between decode steps, so cost must be O(samples), never
    O(windows x samples) — each cutoff is crossed exactly once on the
    walk, and the walk stops at the oldest window's edge."""
    order = sorted(set(spec.windows))          # ascending window size =
    cutoffs = [now - w for w in order]         # descending cutoff time
    sums: dict = {}
    bad = total = 0.0
    i = 0
    for ts, b, t in reversed(samples):
        while i < len(order) and ts < cutoffs[i]:
            sums[order[i]] = (bad, total)
            i += 1
        if i >= len(order):
            break  # older than every window: nothing left to count
        bad += b
        total += t
    while i < len(order):
        sums[order[i]] = (bad, total)
        i += 1
    windows = {}
    for w in spec.windows:
        b, t = sums[w]
        frac = (b / t) if t else None
        windows[f"{w:g}s"] = {
            "total": t,
            "bad": b,
            "bad_fraction": None if frac is None else round(frac, 6),
            "burn_rate": (
                None if frac is None else round(frac / spec.budget, 4)
            ),
        }
    return windows


def _breached(windows: dict) -> bool:
    burns = [w["burn_rate"] for w in windows.values()]
    return bool(burns) and all(b is not None and b > 1.0 for b in burns)


def evaluate_slos(
    events: list, specs=DEFAULT_SLOS, now: "float | None" = None
) -> dict:
    """Offline SLO report over an event log: for each spec, per-window
    totals / bad fraction / burn rate, plus the multi-window breach
    verdict. ``now`` defaults to the newest event timestamp (end of log),
    so reports over historical logs stay meaningful."""
    spans = [e for e in events if e.get("kind") == "serve.request"]
    if now is None:
        now = max(
            (e["ts"] for e in events if isinstance(e.get("ts"), (int, float))),
            default=time.time(),
        )
    report: dict = {"now": round(now, 6), "requests": len(spans), "slos": {}}
    for spec in specs:
        samples = []
        for span in spans:
            s = span_sample(spec, span)
            if s is not None and isinstance(span.get("ts"), (int, float)):
                samples.append((span["ts"], s[0], s[1]))
        # _window_burn's one-pass walk needs time order; offline logs can
        # interleave sources (merge) or clock steps, so sort here (the
        # live engine's deque is ordered by construction).
        samples.sort(key=lambda s: s[0])
        windows = _window_burn(samples, now, spec)
        report["slos"][spec.name] = {
            "kind": spec.kind,
            "objective": spec.objective,
            **(
                {"threshold_s": spec.threshold_s}
                if spec.kind == "ttft_p95" else {}
            ),
            "windows": windows,
            "breached": _breached(windows),
        }
    return report


class SLOEngine:
    """Streaming burn-rate evaluation for the serving loop.

    ``record(span)`` is called wherever a ``serve.request`` event is
    emitted (host-side answer boundaries); ``maybe_evaluate()``
    re-computes burn rates at most once per ``interval`` seconds, sets
    the ``serve_slo_burn_<name>`` gauges (the max across that spec's
    windows — the paging number), and emits one ``slo.burn`` event per
    breach-state transition. THREAD-SAFE: most answers come from the
    scheduler loop, but backpressure refusals and pre-answered responses
    record from CLIENT threads (``submit``/``submit_done``), so one lock
    serializes sample appends against evaluation's iteration/pruning
    (evaluation itself stays scheduler-loop-only). Near-simultaneous
    cross-thread appends can land microseconds out of order; the
    one-pass window walk tolerates that at a window edge (one sample
    attributed one window over), which is noise at burn-rate scale.
    Memory is bounded: samples older than the longest window are pruned
    on every evaluation."""

    def __init__(
        self,
        specs=DEFAULT_SLOS,
        registry=None,
        emit=None,
        interval: float = 5.0,
        clock=time.time,
    ):
        self.specs = tuple(specs)
        self._registry = registry
        self._emit = emit
        self._interval = max(float(interval), 0.0)
        self._clock = clock
        self._samples = {s.name: deque() for s in self.specs}
        self._breached = {s.name: False for s in self.specs}
        self._last_eval: "float | None" = None
        self._lock = threading.Lock()
        self._gauges = {}
        if registry is not None:
            for s in self.specs:
                self._gauges[s.name] = registry.gauge(
                    f"serve_slo_burn_{s.name}",
                    f"max burn rate across {s.kind} windows "
                    "(1.0 = consuming the error budget exactly)",
                )

    def record(self, span: dict, ts: "float | None" = None) -> None:
        ts = ts if ts is not None else self._clock()
        with self._lock:
            for spec in self.specs:
                s = span_sample(spec, span)
                if s is not None:
                    self._samples[spec.name].append((ts, s[0], s[1]))

    def maybe_evaluate(self, force: bool = False) -> "dict | None":
        now = self._clock()
        if (
            not force
            and self._last_eval is not None
            and now - self._last_eval < self._interval
        ):
            return None
        self._last_eval = now
        return self.evaluate(now)

    def evaluate(self, now: "float | None" = None) -> dict:
        now = now if now is not None else self._clock()
        out = {}
        for spec in self.specs:
            with self._lock:
                # Prune + snapshot under the lock (client threads append
                # concurrently; iterating a mutating deque raises); the
                # burn math and gauge/event work run on the copy.
                samples = self._samples[spec.name]
                horizon = now - max(spec.windows)
                while samples and samples[0][0] < horizon:
                    samples.popleft()
                samples = list(samples)
            windows = _window_burn(samples, now, spec)
            burns = [
                w["burn_rate"] for w in windows.values()
                if w["burn_rate"] is not None
            ]
            max_burn = max(burns) if burns else 0.0
            if spec.name in self._gauges:
                self._gauges[spec.name].set(max_burn)
            breached = _breached(windows)
            if breached != self._breached[spec.name]:
                self._breached[spec.name] = breached
                if self._emit is not None:
                    # "spec" (not "kind") for the SLO kind: the emit
                    # callable's first positional IS the event kind.
                    self._emit(
                        "slo.burn",
                        name=spec.name,
                        spec=spec.kind,
                        objective=spec.objective,
                        breached=breached,
                        burn_rate=max_burn,
                        windows={
                            k: w["burn_rate"] for k, w in windows.items()
                        },
                    )
            out[spec.name] = {
                "windows": windows, "breached": breached,
                "burn_rate": max_burn,
            }
        return out


def render_slo_text(report: dict) -> str:
    lines = [
        f"{report['requests']} requests, "
        f"{len(report['slos'])} SLO(s) @ now={report['now']}"
    ]
    for name, slo in report["slos"].items():
        head = f"{name} ({slo['kind']}, objective {slo['objective']:g}"
        if "threshold_s" in slo:
            head += f", threshold {slo['threshold_s']:g}s"
        head += "): " + ("BREACHED" if slo["breached"] else "ok")
        lines.append(head)
        for wname, w in slo["windows"].items():
            if w["burn_rate"] is None:
                lines.append(f"  {wname:>8}: no samples")
            else:
                lines.append(
                    f"  {wname:>8}: burn {w['burn_rate']:g}x "
                    f"({w['bad']:g}/{w['total']:g} bad)"
                )
    return "\n".join(lines)
