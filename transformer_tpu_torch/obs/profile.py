"""Per-program dispatch profiler: the measured half of the roofline story.

Port of ``transformer_tpu/obs/profile.py`` (standard library only). The
scheduler and the trainer clock each program they run (a pool step, a
verify step, a slot prefill, a train dispatch) up to the device
synchronize the loop already has, so a sample is the program's real time
on the card, not the time to enqueue it. Three surfaces:

- :class:`ProgramProfiler` — per-program
  :class:`~transformer_tpu_torch.obs.quantiles.StreamingHistogram` of
  seconds plus a token counter, registry-bound as
  ``perf_seconds_<program>`` / ``perf_tokens_total_<program>`` so the
  samples ride every ``metrics.snapshot`` event and Prometheus exposition.
  Derived ``perf_measured_*`` gauges (tokens/s, p50 ms, and, where the
  bank holds a program's ``bytes_moved``, effective bytes/s and roofline
  ratio) and a ``perf_drift_<program>`` gauge (measured p50 over the
  banked p50, where one is banked) refresh as samples arrive; a
  ``perf.drift`` event fires on each banked-band breach-state TRANSITION.
- the banked baseline (``obs/roofline_baseline.json``): the card's peak
  memory rate and each program's acceptance band. The port's bank holds
  no ``bytes_moved`` and no ``p50_s`` yet (they wait for a cost model of
  the port's programs), so its report shows the measured columns, and
  drift is judged only once a ``p50_s`` is banked (``obs roofline
  --update`` on the card).
- :func:`roofline_report` — the offline join (``obs roofline``): measured
  per-program histograms recovered from a JSONL episode's
  ``metrics.snapshot`` stream against a predictions document and the bank,
  tolerant when either side is absent.

:func:`profile_call` is the wrapper sibling of ``obs.telemetry.timed_call``
/ ``obs.trace.traced_call``: it times the call it wraps and forwards its
outputs untouched.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable

from transformer_tpu_torch.obs.quantiles import StreamingHistogram

#: The programs the scheduler and the trainer run, under the JAX
#: package's names (the join key between measurement and prediction, and
#: what makes both packages' reports comparable row by row). The port
#: records the pool step, verify and prefill of each layout and
#: ``train.step``; ``serve.slot_restore`` is the JAX package's name for a
#: prefix restore, which the port does not clock.
CANNED_PROGRAMS = (
    "serve.pool_step",
    "serve.pool_step_paged",
    "serve.pool_step_paged_flash",
    "serve.pool_verify",
    "serve.pool_verify_paged",
    "serve.pool_verify_paged_flash",
    "serve.slot_prefill",
    "serve.slot_prefill_paged",
    "serve.slot_restore",
    "train.step",
)

#: Fallback peak memory rate for the roofline denominator when the bank
#: does not hold one: the NVIDIA H100 80GB HBM3's 3.35 TB/s (its data
#: sheet; the figure ``chip_smoke.py``'s bounds use). ``obs roofline
#: --update`` keeps the bank's own figure.
DEFAULT_PEAK_BYTES_PER_S = 3.35e12

#: Default drift acceptance band, as [lo, hi] multipliers on the banked
#: p50: generous on purpose — the band exists to catch a silently-landed
#: 10x regression, not 20% scheduler noise.
DEFAULT_BAND = (0.2, 5.0)

#: Samples a program must accumulate before its p50 is judged against the
#: band (a first dispatch builds kernels and captures graphs: not steady
#: state).
MIN_DRIFT_SAMPLES = 8

BASELINE_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "roofline_baseline.json"
)

_SECONDS_PREFIX = "perf_seconds_"
_TOKENS_PREFIX = "perf_tokens_total_"


def metric_suffix(program: str) -> str:
    """Program name -> the registry-legal metric suffix
    (``serve.pool_step`` -> ``serve_pool_step``; dots are the only
    character the canned names carry outside the metric charset)."""
    return program.replace(".", "_")


_SUFFIX_TO_PROGRAM = {metric_suffix(p): p for p in CANNED_PROGRAMS}


def program_for_suffix(suffix: str) -> str:
    """Reverse of :func:`metric_suffix` for the canned set; unknown
    suffixes pass through unchanged (the report still rows them)."""
    return _SUFFIX_TO_PROGRAM.get(suffix, suffix)


# --------------------------------------------------------------------------
# baseline bank

def load_baseline(path: str | None = None) -> dict:
    """The banked baseline document, ``{}`` when missing or unreadable —
    the profiler and the report degrade to measured-only, never error."""
    try:
        with open(path or BASELINE_PATH, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return {}
    return doc if isinstance(doc, dict) else {}


def write_baseline(
    path: str,
    measured: dict,
    predictions: dict | None = None,
    peak_bytes_per_s: float | None = None,
    band=DEFAULT_BAND,
) -> dict:
    """Bank ``measured`` (program -> row with ``p50_s``) as the new
    baseline, freezing each program's predictions (``bytes_moved``,
    ``tokens_per_step``) next to its band. Atomic (tmp + rename)."""
    programs = {}
    for name in sorted(measured):
        row = measured[name]
        p50 = row.get("p50_s")
        if not isinstance(p50, (int, float)) or p50 <= 0:
            continue
        entry = {"p50_s": round(float(p50), 9), "band": list(band)}
        pred = (predictions or {}).get(name) or {}
        if pred.get("bytes_moved"):
            entry["bytes_moved"] = int(pred["bytes_moved"])
        extras = pred.get("extras") or {}
        tps = extras.get("tokens_per_step") or pred.get("tokens_per_step")
        if tps:
            entry["tokens_per_step"] = int(tps)
        programs[name] = entry
    doc = {
        "peak_bytes_per_s": float(peak_bytes_per_s or DEFAULT_PEAK_BYTES_PER_S),
        "programs": programs,
        "note": (
            "Banked by `obs roofline --update`: per-program measured p50 "
            "seconds + acceptance band [lo, hi] (multipliers on p50); "
            "bytes_moved/tokens_per_step frozen from the predictions at "
            "bank time. Absolute times are per card and power limit: "
            "re-bank on the card that enforces the band."
        ),
    }
    tmp = f"{path}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return doc


def predictions_by_program(costs) -> dict:
    """Index a predictions document (the JAX package's ``analysis costs
    --format=json`` shape: a ``programs`` list of rows with ``name`` and
    ``bytes_moved``) by BASE program name, stripping the ``[variant,...]``
    suffix; when several variants share a base the ``lm_bf16`` one wins
    (the default serving config)."""
    reports = costs.get("programs", []) if isinstance(costs, dict) else list(costs or [])
    out: dict = {}
    for r in reports:
        if not isinstance(r, dict):
            continue
        name = str(r.get("name") or "")
        base = name.split("[", 1)[0]
        if not base:
            continue
        prev = out.get(base)
        if prev is None or (
            "[lm_bf16" in name and "[lm_bf16" not in str(prev.get("name", ""))
        ):
            out[base] = r
    return out


# --------------------------------------------------------------------------
# the profiler

class _ProgramStream:
    __slots__ = (
        "hist", "tokens", "in_band", "m_tokens", "m_tokens_per_s",
        "m_p50_ms", "m_bytes_per_s", "m_roofline", "m_drift",
    )

    def __init__(self):
        self.hist = StreamingHistogram()
        self.tokens = 0.0
        self.in_band: bool | None = None  # None = not yet judged
        self.m_tokens = None
        self.m_tokens_per_s = None
        self.m_p50_ms = None
        self.m_bytes_per_s = None
        self.m_roofline = None
        self.m_drift = None


class ProgramProfiler:
    """Clock every dispatch of the canned programs into per-program
    histograms; export measured gauges; sentinel measured-vs-banked drift.

    ``record`` is the hot-path surface: one ``observe`` + a token add,
    with the derived gauges refreshed every ``refresh_every``-th sample
    (quantile extraction walks the histogram buckets — not free at
    per-step cadence). All host-side, torch-free, exception-free.
    """

    def __init__(
        self,
        registry=None,
        emit=None,
        baseline: dict | None = None,
        min_samples: int = MIN_DRIFT_SAMPLES,
        refresh_every: int = 8,
    ):
        self._registry = registry
        self._emit = emit
        self._lock = threading.Lock()
        self._streams: dict[str, _ProgramStream] = {}
        doc = load_baseline() if baseline is None else (baseline or {})
        self.baseline = doc.get("programs", {}) if isinstance(doc, dict) else {}
        self.peak_bytes_per_s = float(
            (doc.get("peak_bytes_per_s") if isinstance(doc, dict) else None)
            or DEFAULT_PEAK_BYTES_PER_S
        )
        self.min_samples = max(1, int(min_samples))
        self.refresh_every = max(1, int(refresh_every))
        self.stats = {"records": 0, "drift_events": 0}

    # -- recording ----------------------------------------------------------

    def _stream(self, program: str) -> _ProgramStream:
        s = self._streams.get(program)
        if s is not None:
            return s
        with self._lock:
            s = self._streams.get(program)
            if s is None:
                s = _ProgramStream()
                if self._registry is not None:
                    suffix = metric_suffix(program)
                    reg = self._registry
                    reg.histogram(
                        _SECONDS_PREFIX + suffix,
                        f"measured seconds per {program} call, up to the "
                        "device synchronize that ends it",
                        hist=s.hist,
                    )
                    s.m_tokens = reg.counter(
                        _TOKENS_PREFIX + suffix,
                        f"tokens processed by {program} dispatches",
                    )
                    s.m_tokens_per_s = reg.gauge(
                        f"perf_measured_tokens_per_s_{suffix}",
                        f"measured tokens/s for {program}",
                    )
                    s.m_p50_ms = reg.gauge(
                        f"perf_measured_p50_ms_{suffix}",
                        f"measured p50 dispatch ms for {program}",
                    )
                    if self._banked(program).get("bytes_moved"):
                        s.m_bytes_per_s = reg.gauge(
                            f"perf_measured_bytes_per_s_{suffix}",
                            f"effective bytes/s for {program} (predicted "
                            "bytes_moved over measured p50)",
                        )
                        s.m_roofline = reg.gauge(
                            f"perf_roofline_ratio_{suffix}",
                            f"effective over peak bytes/s for {program}",
                        )
                    if self._banked(program).get("p50_s"):
                        s.m_drift = reg.gauge(
                            f"perf_drift_{suffix}",
                            f"measured p50 over banked p50 for {program}",
                        )
                self._streams[program] = s
        return s

    def _banked(self, program: str) -> dict:
        entry = self.baseline.get(program)
        return entry if isinstance(entry, dict) else {}

    def record(self, program: str, seconds: float, tokens: float = 0) -> None:
        """One dispatch of ``program`` took ``seconds`` and processed
        ``tokens`` tokens (0 when the caller has no honest count)."""
        s = self._stream(program)
        s.hist.observe(max(float(seconds), 0.0))
        self.stats["records"] += 1
        if tokens:
            s.tokens += tokens
            if s.m_tokens is not None:
                s.m_tokens.inc(tokens)
        count = s.hist.count
        if count % self.refresh_every == 0 or count == self.min_samples:
            self._refresh(program, s)

    def _refresh(self, program: str, s: _ProgramStream) -> None:
        snap = s.hist.snapshot()
        p50 = snap.get("p50")
        if not p50 or p50 <= 0:
            return
        if s.m_p50_ms is not None:
            s.m_p50_ms.set(p50 * 1e3)
        total_s = snap.get("sum") or 0.0
        if s.m_tokens_per_s is not None and total_s > 0:
            s.m_tokens_per_s.set(s.tokens / total_s)
        bank = self._banked(program)
        bytes_moved = bank.get("bytes_moved")
        if bytes_moved and s.m_bytes_per_s is not None:
            eff = bytes_moved / p50
            s.m_bytes_per_s.set(eff)
            if s.m_roofline is not None:
                s.m_roofline.set(eff / self.peak_bytes_per_s)
        base_p50 = bank.get("p50_s")
        if base_p50 and snap.get("count", 0) >= self.min_samples:
            ratio = p50 / base_p50
            if s.m_drift is not None:
                s.m_drift.set(ratio)
            lo, hi = tuple(bank.get("band") or DEFAULT_BAND)
            in_band = lo <= ratio <= hi
            if s.in_band is not None and in_band != s.in_band and self._emit:
                # Breach-state TRANSITION only (slo.burn's discipline): a
                # drifting soak must not flood its own log.
                self.stats["drift_events"] += 1
                self._emit(
                    "perf.drift", program=program,
                    ratio=round(ratio, 4), band=[lo, hi],
                    measured_p50_s=round(p50, 9),
                    baseline_p50_s=round(base_p50, 9),
                    breached=not in_band,
                )
            elif s.in_band is None and not in_band and self._emit:
                self.stats["drift_events"] += 1
                self._emit(
                    "perf.drift", program=program,
                    ratio=round(ratio, 4), band=[lo, hi],
                    measured_p50_s=round(p50, 9),
                    baseline_p50_s=round(base_p50, 9),
                    breached=True,
                )
            s.in_band = in_band

    # -- reading ------------------------------------------------------------

    def summary(self) -> dict:
        """program -> measured row (the benchmarks' and tests' surface):
        ``dispatches`` / ``p50_ms`` / ``p95_ms`` / ``p50_s`` / ``tokens``
        / ``tokens_per_s``, plus ``drift`` when the program is banked."""
        out = {}
        with self._lock:
            streams = dict(self._streams)
        for program, s in sorted(streams.items()):
            snap = s.hist.snapshot()
            if not snap.get("count"):
                continue
            p50 = snap.get("p50") or 0.0
            total_s = snap.get("sum") or 0.0
            row = {
                "program": program,
                "dispatches": snap["count"],
                "p50_s": p50,
                "p50_ms": round(p50 * 1e3, 6),
                "p95_ms": round((snap.get("p95") or 0.0) * 1e3, 6),
                "tokens": s.tokens,
                "tokens_per_s": (
                    round(s.tokens / total_s, 3) if total_s > 0 else None
                ),
            }
            bank = self._banked(program)
            if bank.get("p50_s") and p50 > 0:
                row["drift"] = round(p50 / bank["p50_s"], 4)
            if bank.get("bytes_moved") and p50 > 0:
                row["effective_bytes_per_s"] = bank["bytes_moved"] / p50
                row["roofline_ratio"] = round(
                    row["effective_bytes_per_s"] / self.peak_bytes_per_s, 6
                )
            out[program] = row
        return out


def profile_call(
    fn: Callable, profiler: ProgramProfiler, program: str, tokens: float = 0
) -> Callable:
    """Wrap ``fn`` so each call's wall time lands in ``profiler`` under
    ``program`` (``tokens`` credited per call). Third sibling of
    ``timed_call`` / ``traced_call``: it forwards ``fn``'s outputs
    untouched and adds no device work. The time is the program's only when
    ``fn`` ends in a device synchronize (the trainer's dispatch callable
    does)."""

    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        profiler.record(program, time.perf_counter() - t0, tokens=tokens)
        return out

    wrapped.__wrapped__ = fn
    return wrapped


# --------------------------------------------------------------------------
# the offline join (obs roofline)

def measured_from_events(events: list) -> dict:
    """Recover per-program measured rows from a JSONL episode: the LAST
    ``metrics.snapshot`` carrying each ``perf_seconds_*`` histogram wins
    (registry metrics are cumulative, so the last snapshot is the
    episode's total)."""
    hists: dict[str, dict] = {}
    tokens: dict[str, float] = {}
    for e in events:
        if e.get("kind") != "metrics.snapshot":
            continue
        metrics = e.get("metrics")
        if not isinstance(metrics, dict):
            continue
        for name, value in metrics.items():
            if name.startswith(_SECONDS_PREFIX) and isinstance(value, dict):
                program = program_for_suffix(name[len(_SECONDS_PREFIX):])
                hists[program] = value
            elif name.startswith(_TOKENS_PREFIX) and isinstance(
                value, (int, float)
            ):
                program = program_for_suffix(name[len(_TOKENS_PREFIX):])
                tokens[program] = float(value)
    out = {}
    for program, snap in hists.items():
        if not snap.get("count"):
            continue
        p50 = snap.get("p50") or 0.0
        total_s = snap.get("sum") or 0.0
        toks = tokens.get(program, 0.0)
        out[program] = {
            "dispatches": snap.get("count", 0),
            "p50_s": p50,
            "p50_ms": round(p50 * 1e3, 6),
            "p95_ms": round((snap.get("p95") or 0.0) * 1e3, 6),
            "tokens": toks,
            "measured_tokens_per_s": (
                round(toks / total_s, 3) if total_s > 0 and toks else None
            ),
        }
    return out


def roofline_report(
    events: list, costs=None, baseline: dict | None = None
) -> dict:
    """Join a JSONL episode's measured programs against predictions and
    the banked baseline. Tolerant by construction: a
    missing prediction drops the bytes columns from that row, a missing
    bank drops the drift columns, an empty episode returns zero rows."""
    doc = load_baseline() if baseline is None else (baseline or {})
    banked = doc.get("programs", {}) if isinstance(doc, dict) else {}
    peak = float(
        (doc.get("peak_bytes_per_s") if isinstance(doc, dict) else None)
        or DEFAULT_PEAK_BYTES_PER_S
    )
    predicted = predictions_by_program(costs) if costs else {}
    measured = measured_from_events(events)
    rows = []
    for program in sorted(measured):
        m = measured[program]
        row = {"program": program, **m}
        pred = predicted.get(program) or {}
        bank = banked.get(program) if isinstance(banked, dict) else None
        bank = bank if isinstance(bank, dict) else {}
        bytes_moved = pred.get("bytes_moved") or bank.get("bytes_moved")
        extras = pred.get("extras") or {}
        tps = (
            extras.get("tokens_per_step")
            or pred.get("tokens_per_step")
            or bank.get("tokens_per_step")
        )
        p50 = m.get("p50_s") or 0.0
        if bytes_moved and p50 > 0:
            row["predicted_bytes_moved"] = int(bytes_moved)
            row["effective_bytes_per_s"] = bytes_moved / p50
            row["roofline_ratio"] = round(
                row["effective_bytes_per_s"] / peak, 6
            )
        if tps and p50 > 0:
            row["predicted_tokens_per_s"] = round(tps / p50, 3)
            mtps = m.get("measured_tokens_per_s")
            if mtps:
                row["measured_over_predicted_tokens"] = round(
                    mtps / row["predicted_tokens_per_s"], 4
                )
        if bank.get("p50_s") and p50 > 0:
            lo, hi = tuple(bank.get("band") or DEFAULT_BAND)
            row["drift"] = round(p50 / bank["p50_s"], 4)
            row["band"] = [lo, hi]
            row["in_band"] = lo <= row["drift"] <= hi
        rows.append(row)
    return {"peak_bytes_per_s": peak, "programs": rows}


def band_breaches(report: dict) -> list:
    """Rows whose measured p50 left their banked band (the ``--check``
    verdict): unbanked rows never breach — the band only judges what was
    deliberately banked."""
    return [
        r for r in report.get("programs", [])
        if r.get("in_band") is False
    ]


def roofline_ratio(
    bytes_moved: float, p50_s: float, peak_bytes_per_s: float | None = None
) -> float | None:
    """effective bytes/s over peak bytes/s for one program — the single
    definition the benchmarks and the report share."""
    if not bytes_moved or not p50_s or p50_s <= 0:
        return None
    peak = peak_bytes_per_s or float(
        load_baseline().get("peak_bytes_per_s") or DEFAULT_PEAK_BYTES_PER_S
    )
    return round((bytes_moved / p50_s) / peak, 6)
