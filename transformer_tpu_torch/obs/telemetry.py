"""The telemetry bundle the CLIs wire through train/serve.

Port of ``transformer_tpu/obs/telemetry.py`` (standard library only). One
:class:`Telemetry` object carries the whole obs surface: a
:class:`~transformer_tpu_torch.obs.registry.MetricsRegistry`, an optional
:class:`~transformer_tpu_torch.obs.events.EventLog`, and the periodic sinks —
a Prometheus text file rewritten atomically every ``interval`` seconds and
a ``metrics.snapshot`` event appended to the log on the same cadence.
``cli/train.py flags_to_telemetry`` builds it from ``--metrics_jsonl`` /
``--metrics_port`` / ``--metrics_interval``; passing ``telemetry=None``
everywhere keeps the zero-overhead default.

Design rule: nothing in this module imports torch or touches device
values. Recording happens at the host sync points the loops already have,
so telemetry is inert: the same answers, the same losses, the same CUDA
graph captures and kernel launches with it on and off. The device's
memory statistics come from ``transformer_tpu_torch.device.
device_memory_stats`` (it reads ``torch.cuda.memory_stats``), which keeps
this package free of torch.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable

from transformer_tpu_torch.obs.events import EventLog
from transformer_tpu_torch.obs.registry import Histogram, MetricsRegistry


def timed_call(
    fn: Callable, histogram: Histogram | None = None, counter=None
) -> Callable:
    """Wrap ``fn`` so each call's host wall time lands in ``histogram`` (and
    ``counter`` counts calls). It forwards ``fn``'s outputs untouched and
    adds no device work; what the time covers is what ``fn`` covers (the
    trainer's dispatch callable ends in the device synchronize it already
    had, so there it is the dispatch's device time plus the host's).
    """

    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if histogram is not None:
            histogram.observe(time.perf_counter() - t0)
        if counter is not None:
            counter.inc()
        return out

    wrapped.__wrapped__ = fn
    return wrapped


class Telemetry:
    """Registry + event log + periodic sinks, as one pass-around handle.

    ``trace=True`` additionally carries a :class:`~transformer_tpu_torch.obs.
    trace.Tracer` bound to this bundle's event emit — the scheduler and
    trainer consult ``telemetry.tracer`` and record hierarchical
    ``trace.span`` events when it is set. Off by default: spans multiply
    event volume per request, so tracing is an explicit opt-in
    (``--trace``), and inert whenever it is on.
    """

    def __init__(
        self,
        registry: MetricsRegistry | None = None,
        events: EventLog | None = None,
        prom_path: str | None = None,
        interval: float = 10.0,
        trace: bool = False,
    ) -> None:
        self.registry = registry if registry is not None else MetricsRegistry()
        self.events = events
        self.prom_path = prom_path
        self.interval = max(float(interval), 0.0)
        # -inf, not 0.0: perf_counter's epoch is unspecified (host boot on
        # Linux), so "now - 0 < interval" would skip the first flush on any
        # machine whose uptime is shorter than the interval — the first
        # flush must ALWAYS run.
        self._last_flush = float("-inf")
        self._server = None
        self._t0 = time.time()
        self.tracer = None
        # Armed on demand (arm_profiler / arm_flight): the per-program
        # profiler (obs/profile.py) and the always-on flight recorder
        # (obs/flight.py). None keeps both surfaces free.
        self.profiler = None
        self.flight = None
        if trace:
            from transformer_tpu_torch.obs.trace import Tracer

            self.tracer = Tracer(self.emit)

    # ---- optional subsystems ---------------------------------------------

    def arm_profiler(self, baseline: dict | None = None):
        """Attach a :class:`~transformer_tpu_torch.obs.profile.ProgramProfiler`
        bound to this bundle's registry and emit (perf_* metrics ride the
        snapshot/prom sinks; perf.drift events ride the log)."""
        from transformer_tpu_torch.obs.profile import ProgramProfiler

        self.profiler = ProgramProfiler(
            registry=self.registry, emit=self.emit, baseline=baseline
        )
        return self.profiler

    def arm_flight(
        self, path: str | None, capacity: int = 256, autodump_s: float = 2.0
    ):
        """Attach a :class:`~transformer_tpu_torch.obs.flight.FlightRecorder`
        tapped off :meth:`emit`; ``maybe_flush`` drives its autodumps and
        ``close`` writes the final record."""
        from transformer_tpu_torch.obs.flight import FlightRecorder

        self.flight = FlightRecorder(
            path, capacity=capacity, autodump_s=autodump_s,
            registry=self.registry, emit=self.emit,
        )
        return self.flight

    # ---- events -----------------------------------------------------------

    def emit(self, kind: str, **fields) -> None:
        if self.events is not None:
            self.events.emit(kind, **fields)
        if self.flight is not None:
            self.flight.record(kind, fields)

    # ---- periodic sinks ---------------------------------------------------

    def maybe_flush(self, force: bool = False) -> bool:
        """Run the periodic sinks if ``interval`` has elapsed (or ``force``).
        Cheap to call every scheduler step / train dispatch: the common case
        is one ``perf_counter`` read and a compare."""
        now = time.perf_counter()
        # The flight recorder's autodump runs at ITS cadence (autodump_s),
        # not the sink interval — a SIGKILL can't trigger a dump, so the
        # on-disk record's staleness bound must not inherit the (much
        # longer) snapshot interval.
        if self.flight is not None:
            self.flight.maybe_dump()
        if not force and now - self._last_flush < self.interval:
            return False
        self._last_flush = now
        self.emit("metrics.snapshot", metrics=self.registry.snapshot())
        if self.prom_path:
            self._write_prom()
        if self.events is not None:
            self.events.flush()
        return True

    def _write_prom(self) -> None:
        """Atomic rewrite (tmp + rename): a scraper tailing the file never
        sees a torn exposition."""
        import sys

        tmp = f"{self.prom_path}.tmp"
        try:
            with open(tmp, "w") as f:
                f.write(self.registry.to_prometheus_text())
            os.replace(tmp, self.prom_path)
        except OSError as e:
            # Same downgrade contract as EventLog: one stderr warning, then
            # the sink goes quiet — the observed process never dies (and a
            # scraper sees a stale-but-valid file, not a torn one).
            print(
                f"obs: prometheus file {self.prom_path} unwritable ({e}); "
                "sink disabled for this process",
                file=sys.stderr,
            )
            self.prom_path = None

    def close(self) -> None:
        self.maybe_flush(force=True)
        if self.flight is not None:
            self.flight.dump("close")
        if self._server is not None:
            self._server.shutdown()
            self._server = None
        if self.events is not None:
            self.events.close()

    # ---- health -----------------------------------------------------------

    def health(self) -> dict:
        """Liveness + sink states, the ``/healthz`` document. ``ok`` is
        False only when a sink has hard-downgraded (broken event log) —
        breaker-open is a transient, reported but not fatal."""
        doc: dict = {
            "ok": True,
            "pid": os.getpid(),
            "ts": round(time.time(), 6),
            "uptime_s": round(time.time() - self._t0, 3),
            "sinks": {
                "prom_file": {"enabled": bool(self.prom_path)},
            },
        }
        if self.events is not None:
            ev = {"broken": bool(getattr(self.events, "_broken", False))}
            breaker = getattr(self.events, "_breaker", None)
            if breaker is not None:
                ev["breaker"] = getattr(breaker, "state", "unknown")
            doc["sinks"]["event_log"] = ev
            if ev["broken"]:
                doc["ok"] = False
        if self.flight is not None:
            doc["flight"] = {
                "depth": self.flight.depth(),
                "dumps": self.flight.dumps,
                "broken": self.flight._broken,
            }
        if self.profiler is not None:
            doc["profiler"] = dict(self.profiler.stats)
        return doc

    # ---- scrape endpoint --------------------------------------------------

    def start_prometheus_server(self, port: int) -> int:
        """Serve ``GET /metrics`` (text exposition) and ``GET /healthz``
        (liveness JSON) on ``port`` from a daemon thread; returns the bound
        port (pass 0 to let the OS pick — tests). stdlib ``http.server``
        only: the obs package takes no dependencies."""
        import http.server
        import json as _json

        registry = self.registry
        telemetry = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
                if self.path == "/healthz":
                    doc = telemetry.health()
                    body = _json.dumps(doc).encode()
                    self.send_response(200 if doc["ok"] else 503)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if self.path not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                body = registry.to_prometheus_text().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # scrapes must not spam stderr
                pass

        server = http.server.ThreadingHTTPServer(("0.0.0.0", port), Handler)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        self._server = server
        return server.server_address[1]
