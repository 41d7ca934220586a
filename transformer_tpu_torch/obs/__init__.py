"""transformer_tpu_torch.obs — the port's telemetry.

Port of ``transformer_tpu/obs`` (standard library only): a metrics
registry (counters / gauges / histograms with online p50/p95/p99), a
structured JSONL event log, hierarchical request tracing, SLO burn rates,
a per-program profiler, a flight recorder, circuit breakers, and three
sinks — JSONL, Prometheus text exposition (file and/or ``/metrics``
endpoint), and the ``utils/tensorboard.py`` tfevents writer.
``python -m transformer_tpu_torch.obs summarize <jsonl>`` renders a run
report; it reads the JAX package's logs too, and renders them as the JAX
package's CLI does.

Import rule: nothing under ``transformer_tpu_torch.obs`` imports torch or
numpy (a test pins it). Telemetry records host-side scalars at the sync
points the loops already have, which is what keeps it inert: the same
answers, losses, graph captures and kernel launches with it on and off.
The device's memory statistics are ``transformer_tpu_torch.device.
device_memory_stats``, outside this package for that reason.
"""

from transformer_tpu_torch.obs.events import EventLog, read_events
from transformer_tpu_torch.obs.merge import filter_events, merge_events
from transformer_tpu_torch.obs.quantiles import StreamingHistogram
from transformer_tpu_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from transformer_tpu_torch.obs.slo import (
    DEFAULT_SLOS,
    SLOEngine,
    SLOSpec,
    evaluate_slos,
    parse_slo_spec,
)
from transformer_tpu_torch.obs.telemetry import Telemetry, timed_call
from transformer_tpu_torch.obs.trace import (
    SpanContext,
    Tracer,
    chrome_trace,
    traced_call,
)

__all__ = [
    "Counter",
    "DEFAULT_SLOS",
    "EventLog",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "SLOEngine",
    "SLOSpec",
    "SpanContext",
    "StreamingHistogram",
    "Telemetry",
    "Tracer",
    "chrome_trace",
    "evaluate_slos",
    "filter_events",
    "merge_events",
    "parse_slo_spec",
    "read_events",
    "timed_call",
    "traced_call",
]
