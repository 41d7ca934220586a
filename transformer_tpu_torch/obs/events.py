"""Structured JSONL event log.

Port of ``transformer_tpu/obs/events.py`` (standard library only). One
event per line: ``{"ts": <unix seconds>, "kind": "<dotted.kind>", ...}``.
The kinds are the JAX package's, with the same fields, so one
``python -m transformer_tpu_torch.obs summarize`` (or the JAX package's)
reads a log of either package. :data:`EVENT_CATALOGUE` lists them; the
port emits:

- ``serve.request`` / ``serve.batch`` / ``serve.retry`` /
  ``serve.breaker`` — the scheduler's answers (span breakdown), the
  grouped path's batches, admission retries and breaker transitions;
- ``train.window`` / ``train.eval`` / ``train.memory`` / ``train.compile``
  / ``train.preempt`` — the trainer's throughput windows, evals,
  ``torch.cuda.memory_stats`` at epoch ends, captured CUDA graphs, and
  the SIGTERM checkpoint;
- ``trace.span`` — one per closed tracing span (``obs/trace.py``);
- ``slo.burn`` / ``perf.drift`` — breach-state transitions of the SLO
  engine and of the program profiler's banked band;
- ``route.*`` — the fleet's router, supervisor and rollout;
- ``flight.dump`` / ``metrics.snapshot`` — flight-recorder dumps and
  periodic registry dumps.

Threading contract: ``emit`` is multi-writer safe. One lock serializes
every write, so two events never interleave bytes within a line, and the
``_broken``-sink transition happens under the same lock, so concurrent
writers hitting a dead disk produce exactly one stderr warning. A full
disk never kills the observed process: an OSError on write downgrades to
that warning and the log goes quiet.
"""

from __future__ import annotations

import io
import json
import os
import sys
import threading
import time

# Fault-injection slot: ``serve.resilience.install`` plants the plane's
# hook here (and clears it on uninstall) so the ``obs.emit`` chaos point
# works WITHOUT this module importing resilience — obs stays torch-free and
# serve-free by import structure (test-pinned). The injected exception
# subclasses OSError on purpose: it flows through the same handler a full
# disk would.
fault_hook = None

#: Every event kind of the JAX package's catalogue, with a one-line
#: meaning: the port keeps the whole list so both packages' logs read
#: alike (the ``bench.*`` kinds belong to the JAX package's bench harness
#: and the ``route.takeover``/HA kinds to its standby, which the port
#: does not emit yet). A test holds every literal ``emit`` kind in the
#: port to this catalogue.
EVENT_CATALOGUE = {
    "bench.attempt": "bench-infra: one per relay attempt (bench.py rows)",
    "bench.fallback_row": "bench-infra: CPU-fallback row attribution",
    "bench.no_value": "bench-infra: a probe that produced no value",
    "bench.relay_probe": "bench-infra: relay liveness probe outcome",
    "ckpt.fallback": "trainer restored an older checkpoint after a bad one",
    "flight.dump": "non-automatic flight-recorder dump (signal/request/close)",
    "metrics.snapshot": "periodic full metrics-registry dump",
    "perf.drift": "measured p50 left (or re-entered) its banked band",
    "route.answered": "HA journal: delivery mark for an accepted order",
    "route.canary": "canary slice lifecycle (started/promoted)",
    "route.dispatch": "router picked a replica for one request",
    "route.failover": "replica failure with victim orders re-dispatched",
    "route.hb": "HA journal: periodic primary liveness beacon",
    "route.intake": "HA journal: one replayable accepted-order record",
    "route.mesh_mismatch": "respawned replica reported the wrong mesh shape",
    "route.postmortem": "supervisor captured a dead replica's flight record",
    "route.retire": "supervised drain-and-retire completed",
    "route.revive": "half-open breaker revived a heartbeat-timeout victim",
    "route.scale": "autoscaling decision with its burn-rate evidence",
    "route.spawn": "replica (re)spawn admitted (or crash loop gave up)",
    "route.takeover": "standby adopted the fleet under a new epoch",
    "route.upgrade": "live-weights rollout lifecycle (by phase)",
    "schedules.test": "interleaving explorer's synthetic event (self-test)",
    "serve.batch": "one grouped-path decode batch",
    "serve.breaker": "admission circuit-breaker state transition",
    "serve.request": "one finished/errored request with span breakdown",
    "serve.retry": "one transient-admission retry",
    "slo.burn": "SLO breach-state transition with window burn rates",
    "trace.span": "one closed tracing span",
    "train.compile": "captured CUDA graphs of the step callables at an epoch boundary",
    "train.eval": "one eval pass result",
    "train.memory": "device memory stats (torch.cuda.memory_stats) at an epoch boundary",
    "train.predicted": "cost-model prediction snapshot for the train step",
    "train.preempt": "preemption checkpoint written on signal",
    "train.window": "one closed StepTimer throughput window",
}


class EventLog:
    """Append-only JSONL event writer.

    ``breaker`` (optional, duck-typed ``serve.resilience.CircuitBreaker``)
    upgrades the permanent ``_broken`` downgrade to the graceful-degradation
    ladder: K consecutive write failures OPEN the sink (events dropped,
    one stderr warning per outage), a cooldown later one half-open emit
    re-probes the disk, and success closes the breaker — a transiently
    full disk costs an outage window, not the rest of the process's
    telemetry. Without a breaker the historical contract holds: first
    failure disables the sink for good, with exactly one warning.
    """

    def __init__(
        self, path_or_file: "str | io.TextIOBase", breaker=None
    ) -> None:
        self._lock = threading.Lock()
        self._broken = False
        self._breaker = breaker
        if isinstance(path_or_file, str):
            d = os.path.dirname(os.path.abspath(path_or_file))
            os.makedirs(d, exist_ok=True)
            self._file = open(path_or_file, "a", buffering=1)
            self.path: str | None = path_or_file
            self._owns = True
        else:
            self._file = path_or_file
            self.path = getattr(path_or_file, "name", None)
            self._owns = False

    def emit(self, kind: str, **fields) -> None:
        """Append one event. ``fields`` must be JSON-serializable; a ``ts``
        stamp is added unless the caller supplies one.
        Safe to call from any thread: the line is serialized outside the
        lock, the single ``write`` happens inside it."""
        if self._broken:
            # Racy fast path — a dead sink must not keep paying json.dumps
            # per emit; the authoritative re-check happens under the lock.
            return
        if self._breaker is not None and not self._breaker.allow():
            return  # sink open: drop quietly until the cooldown re-probe
        event = {"ts": fields.pop("ts", None) or round(time.time(), 6),
                 "kind": kind, **fields}
        line = json.dumps(event, sort_keys=False)
        try:
            with self._lock:
                if self._broken:
                    return
                if fault_hook is not None:
                    fault_hook("obs.emit")  # raises an OSError-shaped fault
                self._file.write(line + "\n")
        except (OSError, ValueError):  # ValueError: write to a closed file
            if self._breaker is not None:
                self._record_sink_failure()
                return
            if self._mark_broken():
                print(
                    f"obs: event log {self.path or '<stream>'} unwritable; "
                    "telemetry disabled for this process",
                    file=sys.stderr,
                )
        else:
            if self._breaker is not None:
                self._breaker.record_success()

    def _record_sink_failure(self) -> None:
        """Feed the breaker; warn exactly when this failure OPENS it (one
        warning per outage, whichever of emit/flush trips it)."""
        if self._breaker.record_failure():
            print(
                f"obs: event log {self.path or '<stream>'} unwritable; "
                "sink open (will re-probe after cooldown)",
                file=sys.stderr,
            )

    def _mark_broken(self) -> bool:
        """Flip the sink dead under the lock; True for exactly one caller
        (so N concurrent writers racing a dead disk warn once, not N
        times)."""
        with self._lock:
            was = self._broken
            self._broken = True
            return not was

    def flush(self) -> None:
        try:
            with self._lock:
                if self._broken:
                    return
                self._file.flush()
        except (OSError, ValueError):
            if self._breaker is not None:
                # A flush can be the fault that OPENS the sink; without the
                # shared warn-on-trip the outage would start silently
                # (emit()'s allow() short-circuits before any write).
                self._record_sink_failure()
            else:
                self._mark_broken()

    def close(self) -> None:
        self.flush()
        if self._owns:
            try:
                self._file.close()
            except OSError:
                pass


def read_events(path: str, kind: str | None = None) -> list[dict]:
    """Load a JSONL event log; malformed lines (a crash mid-write) are
    skipped, never fatal — the summarize CLI must work on truncated logs."""
    out: list[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                continue
            if isinstance(ev, dict) and (kind is None or ev.get("kind") == kind):
                out.append(ev)
    return out
