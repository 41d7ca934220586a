"""Dependency-free metrics registry: counters, gauges, histograms.

Port of ``transformer_tpu/obs/registry.py`` (a copy): the host-side metrics
core of the port's obs package.
Deliberately NOT a Prometheus client-library clone: no label cardinality
machinery, no multiprocess files — one process, one registry, flat metric
names (``serve_slots_active``, ``train_tokens_per_sec_total``). What it does
promise:

- **Zero device interaction**: this module never imports torch/numpy —
  telemetry stays inert (same answers, losses and kernel launches) because
  recording is structurally unable to add device work.
- **Cheap recording**: ``inc``/``set``/``observe`` are a few float ops under
  the GIL — safe to call once per scheduler step or train dispatch.
- **Three export shapes** from one source of truth: ``snapshot()`` (JSON
  for the event log / summarize CLI), ``to_prometheus_text()`` (text
  exposition v0.0.4 for a scrape or file), and per-histogram
  :class:`~transformer_tpu_torch.obs.quantiles.StreamingHistogram` access (for the
  tfevents sink).
"""

from __future__ import annotations

import threading
import time

from transformer_tpu_torch.obs.quantiles import StreamingHistogram

_NAME_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:"
)


def _check_name(name: str) -> str:
    if not name or name[0].isdigit() or not set(name) <= _NAME_OK:
        raise ValueError(
            f"metric name {name!r} is not Prometheus-exposable: use "
            "[a-zA-Z_:][a-zA-Z0-9_:]*"
        )
    return name


class Counter:
    """Monotonically non-decreasing count."""

    kind = "counter"

    def __init__(self, name: str, help: str = "") -> None:
        self.name, self.help = name, help
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {n})")
        self.value += n


class Gauge:
    """A value that goes up and down (occupancy, backlog, bytes in use)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "") -> None:
        self.name, self.help = name, help
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n


class Histogram:
    """Distribution with online p50/p95/p99 — a thin registry wrapper over
    :class:`StreamingHistogram`. Pass ``hist=`` to export an EXISTING
    StreamingHistogram (the StepTimer-reuse path: one sample stream, no
    duplicate accounting) instead of allocating a private one."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str = "",
        hist: StreamingHistogram | None = None,
    ) -> None:
        self.name, self.help = name, help
        self.hist = hist if hist is not None else StreamingHistogram()

    def observe(self, value: float, n: int = 1) -> None:
        self.hist.observe(value, n)

    def quantile(self, q: float) -> float:
        return self.hist.quantile(q)


class MetricsRegistry:
    """Name-keyed get-or-create store for the three metric kinds.

    Threading contract: creation AND iteration take
    ``self._lock``, so the /metrics scrape thread can walk the registry
    while the observed loop lazily creates metrics. Recording on an
    already-created metric is plain float arithmetic — per-metric locks
    would cost more than the races they prevent, and every recorder in
    this repo is single-threaded per metric.
    """

    def __init__(self) -> None:
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name: str, help: str, **kw):
        _check_name(name)
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"wanted {cls.kind}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(
        self, name: str, help: str = "",
        hist: StreamingHistogram | None = None,
    ) -> Histogram:
        m = self._get_or_create(Histogram, name, help, hist=hist)
        if hist is not None and m.hist is not hist:
            raise ValueError(
                f"histogram {name!r} already bound to a different sample "
                "stream"
            )
        return m

    def __iter__(self):
        # Snapshot under the creation lock: the /metrics scrape handler
        # iterates from its own thread while the observed loop may still be
        # lazily creating metrics (first grouped batch, first epoch end) —
        # an unlocked dict walk there is a RuntimeError waiting for traffic.
        with self._lock:
            metrics = list(self._metrics.values())
        return iter(sorted(metrics, key=lambda m: m.name))

    def snapshot(self) -> dict:
        """JSON-able view of every metric — the payload of the periodic
        ``metrics.snapshot`` event the summarize CLI aggregates."""
        out: dict = {}
        for m in self:
            if isinstance(m, Histogram):
                out[m.name] = m.hist.snapshot()
            else:
                out[m.name] = m.value
        return out

    def to_prometheus_text(self) -> str:
        """Prometheus text exposition format v0.0.4. Histograms export the
        standard cumulative ``_bucket{le=...}`` / ``_sum`` / ``_count``
        triple, so a stock scraper computes the same quantiles we report."""
        lines: list[str] = []
        for m in self:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            if isinstance(m, Histogram):
                cum = 0
                for bound, count in m.hist.buckets():
                    cum += count
                    lines.append(f'{m.name}_bucket{{le="{bound:.9g}"}} {cum}')
                lines.append(f'{m.name}_bucket{{le="+Inf"}} {m.hist.count}')
                lines.append(f"{m.name}_sum {m.hist.total:.9g}")
                lines.append(f"{m.name}_count {m.hist.count}")
            else:
                lines.append(f"{m.name} {m.value:.9g}")
        lines.append(f"# EOF generated {time.time():.3f}")
        return "\n".join(lines) + "\n"
