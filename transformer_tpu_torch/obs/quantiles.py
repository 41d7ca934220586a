"""Online quantile estimation: one fixed-size log-bucketed histogram.

Port of ``transformer_tpu/obs/quantiles.py`` (a copy). The single
quantile implementation in the port — ``utils/profiling.StepTimer``
and the obs :class:`~transformer_tpu_torch.obs.registry.Histogram` both wrap this
class rather than keeping their own percentile code. Design constraints:

- **Dependency-free** (stdlib ``math`` only): the obs package must be
  importable from anywhere — the summarize CLI, test helpers — without
  paying a torch/numpy import.
- **O(1) memory, O(1) observe**: geometric buckets over ``[lo, hi)`` with a
  fixed growth factor; a serving process recording one sample per decode
  step must never grow state with traffic.
- **Bounded relative error**: a quantile is reported as the geometric
  midpoint of its bucket, so the error is at most ``sqrt(growth) - 1``
  (~3.9% at the default 1.08 growth) — plenty for p50/p95/p99 latency
  reporting, and the same shape Prometheus client libraries use.

Values below ``lo`` clamp into the first bucket, values at or above ``hi``
into the last — AND are counted (``underflow`` / ``overflow``, surfaced by
``snapshot()``), so a mis-ranged histogram announces itself instead of
silently reporting clamped tails as real quantiles. Exact
``min``/``max``/``sum``/``count`` are tracked on the side so summaries stay
honest at the tails.
"""

from __future__ import annotations

import math


class StreamingHistogram:
    """Fixed log-bucketed online histogram with approximate quantiles.

    The default range [1e-6, 1e4) in seconds spans microsecond host ops to
    hours-long windows — wide enough for every duration this repo records.
    """

    __slots__ = (
        "lo", "hi", "growth", "_log_lo", "_log_growth", "_counts",
        "count", "total", "sum_squares", "min", "max",
        "underflow", "overflow",
    )

    def __init__(
        self, lo: float = 1e-6, hi: float = 1e4, growth: float = 1.08
    ) -> None:
        if not (0 < lo < hi) or growth <= 1.0:
            raise ValueError(
                f"need 0 < lo < hi and growth > 1, got lo={lo} hi={hi} "
                f"growth={growth}"
            )
        self.lo, self.hi, self.growth = lo, hi, growth
        self._log_lo = math.log(lo)
        self._log_growth = math.log(growth)
        n = int(math.ceil((math.log(hi) - self._log_lo) / self._log_growth))
        self._counts = [0] * max(n, 1)
        self.count = 0
        self.total = 0.0
        self.sum_squares = 0.0
        self.min = math.inf
        self.max = -math.inf
        # Samples outside [lo, hi): clamped into the edge buckets (above),
        # but COUNTED — a nonzero tally means the configured range is wrong
        # for this stream and the reported tail quantiles are clamp
        # artifacts, not measurements.
        self.underflow = 0
        self.overflow = 0

    def observe(self, value: float, n: int = 1) -> None:
        """Record ``value`` ``n`` times (``n > 1`` attributes one measured
        window to the identical samples inside it — the StepTimer pattern,
        where a window's wall time is known but per-step times are not)."""
        if n < 1:
            return
        value = float(value)
        if value != value:  # NaN: poison nothing, record nothing
            return
        self.count += n
        self.total += value * n
        self.sum_squares += value * value * n
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        if value < self.lo:
            self.underflow += n
        elif value >= self.hi:
            self.overflow += n
        self._counts[self._index(value)] += n

    def _index(self, value: float) -> int:
        if value < self.lo:
            return 0
        i = int((math.log(value) - self._log_lo) / self._log_growth)
        return min(i, len(self._counts) - 1)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Approximate q-quantile (q in [0, 1]); 0.0 when empty."""
        if not self.count:
            return 0.0
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        # Rank of the wanted sample (1-based), walked over bucket counts.
        rank = max(1, math.ceil(q * self.count))
        seen = 0
        for i, c in enumerate(self._counts):
            seen += c
            if seen >= rank:
                # Geometric midpoint of bucket i, clamped to observed range.
                mid = self.lo * self.growth ** (i + 0.5)
                return min(max(mid, self.min), self.max)
        return self.max  # unreachable; counts always sum to self.count

    def percentiles(self, ps=(50, 95, 99)) -> dict[str, float]:
        return {f"p{p:g}": self.quantile(p / 100.0) for p in ps}

    def buckets(self) -> list[tuple[float, int]]:
        """(upper_bound, count) for every NON-EMPTY bucket, ascending — the
        export shape the Prometheus and tfevents sinks consume."""
        out = []
        for i, c in enumerate(self._counts):
            if c:
                out.append((self.lo * self.growth ** (i + 1), c))
        return out

    def snapshot(self) -> dict:
        """JSON-able summary (the form the event log and summarize CLI use)."""
        if not self.count:
            return {"count": 0}
        out = {
            "count": self.count,
            "sum": self.total,
            "mean": self.mean,
            "min": self.min,
            "max": self.max,
            **self.percentiles(),
        }
        # Only when nonzero: the common in-range case stays schema-stable
        # for every existing snapshot consumer, and a present key IS the
        # warning.
        if self.underflow:
            out["underflow"] = self.underflow
        if self.overflow:
            out["overflow"] = self.overflow
        return out
