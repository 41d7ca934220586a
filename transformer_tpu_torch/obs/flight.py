"""Flight recorder: the last seconds of telemetry, always on, crash-proof.

The fleet heals itself (supervised respawn) but until now threw away the
one thing a postmortem needs — the dying replica's final events. A
:class:`FlightRecorder` keeps a bounded in-memory ring of the process's
most recent events, spans, and metric snapshots (tapped off
``Telemetry.emit``, so every kind rides automatically) and persists it as
one small JSON document at ``<metrics_jsonl>.flight.json``:

- **periodically** (``autodump_s``) — the only dump a SIGKILL leaves
  behind, and the one the Supervisor salvages into a
  ``route.postmortem`` event before recycling the slot;
- **on signal** (SIGTERM, chained to any prior handler);
- **on explicit request** — the replica wire protocol's ``dump`` control
  message, operators, tests;
- **on close** — a clean shutdown's final record.

Non-automatic dumps additionally emit a ``flight.dump`` event (auto dumps
do not: a 2 Hz cadence must not flood the log it is recording).

Port of ``transformer_tpu/obs/flight.py`` (a copy). Design rules:
stdlib-only, torch-free, lock-cheap (``record`` is one deque
append under a lock — deques are bounded, so memory never grows with
traffic), and exception-free toward the host process — an unwritable dump
path downgrades to a one-time stderr warning exactly like the EventLog.
``python -m transformer_tpu_torch.obs postmortem`` merges flight records and
event logs back into one fleet timeline.
"""

from __future__ import annotations

import collections
import json
import os
import signal as _signal
import sys
import threading
import time

#: Ring capacities: events is the working set a postmortem reads; spans
#: mirror it; snapshots are big (full registry dumps) so few are kept.
DEFAULT_CAPACITY = 256
DEFAULT_SNAPSHOTS = 8


class FlightRecorder:
    """Bounded last-N ring of events/spans/snapshots with durable dumps.

    ``path=None`` disables persistence (``dump`` still returns the record
    — in-process tests use this). ``emit`` is an
    optional ``(kind, **fields)`` callable for the ``flight.dump`` event;
    the emitting Telemetry taps this recorder, so the dump event itself
    lands in the ring too (harmless — it is the ring's newest entry).
    """

    def __init__(
        self,
        path: str | None,
        capacity: int = DEFAULT_CAPACITY,
        snapshots: int = DEFAULT_SNAPSHOTS,
        autodump_s: float = 0.0,
        registry=None,
        emit=None,
        source: str | None = None,
    ):
        self.path = path
        self.autodump_s = max(float(autodump_s), 0.0)
        self.source = source
        self._emit = emit
        self._events: collections.deque = collections.deque(
            maxlen=max(1, int(capacity))
        )
        self._spans: collections.deque = collections.deque(
            maxlen=max(1, int(capacity))
        )
        self._snapshots: collections.deque = collections.deque(
            maxlen=max(1, int(snapshots))
        )
        self._lock = threading.Lock()
        self._last_dump = float("-inf")
        self._broken = False
        self.recorded = 0
        self.dumps = 0
        self._m_depth = None
        if registry is not None:
            self._m_depth = registry.gauge(
                "flight_depth",
                "entries currently held in the flight-recorder ring",
            )

    # -- recording (the Telemetry.emit tap) ---------------------------------

    def record(self, kind: str, fields: dict) -> None:
        """Append one event to the right ring. Lock-cheap: build outside
        the lock, one deque append inside it."""
        entry = {"ts": fields.get("ts") or round(time.time(), 6),
                 "kind": kind, **fields}
        if kind == "trace.span":
            ring = self._spans
        elif kind == "metrics.snapshot":
            ring = self._snapshots
        else:
            ring = self._events
        with self._lock:
            ring.append(entry)
            self.recorded += 1
            depth = (
                len(self._events) + len(self._spans) + len(self._snapshots)
            )
        if self._m_depth is not None:
            self._m_depth.set(depth)

    def tap(self, emit):
        """Wrap an ``(kind, **fields)`` emit callable so every event is
        recorded here before being forwarded — how a bare EventLog or
        Tracer arms the recorder without a Telemetry bundle."""

        def tapped(kind, **fields):
            self.record(kind, fields)
            return emit(kind, **fields)

        tapped.__wrapped__ = emit
        return tapped

    def depth(self) -> int:
        with self._lock:
            return len(self._events) + len(self._spans) + len(self._snapshots)

    # -- dumping ------------------------------------------------------------

    def snapshot_record(self, reason: str = "request") -> dict:
        """The dump document: bounded, self-describing, one JSON object."""
        with self._lock:
            events = list(self._events)
            spans = list(self._spans)
            snapshots = list(self._snapshots)
            recorded = self.recorded
        record = {
            "ts": round(time.time(), 6),
            "reason": reason,
            "pid": os.getpid(),
            "recorded": recorded,
            "dumps": self.dumps,
            "events": events,
            "spans": spans,
            "snapshots": snapshots,
        }
        if self.source:
            record["source"] = self.source
        return record

    def dump(self, reason: str = "request") -> dict:
        """Persist the ring to ``path`` (atomic tmp + rename) and return
        the record. Non-``auto`` reasons emit a ``flight.dump`` event."""
        record = self.snapshot_record(reason)
        self.dumps += 1
        record["dumps"] = self.dumps
        if self.path and not self._broken:
            tmp = f"{self.path}.tmp"
            try:
                with open(tmp, "w", encoding="utf-8") as f:
                    json.dump(record, f)
                os.replace(tmp, self.path)
            except OSError as e:
                # EventLog's downgrade contract: warn once, go quiet — the
                # observed process must never die because forensics broke.
                self._broken = True
                print(
                    f"obs: flight dump path {self.path} unwritable ({e}); "
                    "flight persistence disabled for this process",
                    file=sys.stderr,
                )
        if reason != "auto" and self._emit is not None:
            self._emit(
                "flight.dump", reason=reason, path=self.path,
                events=len(record["events"]), spans=len(record["spans"]),
                snapshots=len(record["snapshots"]),
            )
        return record

    def maybe_dump(self) -> bool:
        """Periodic autodump — the crash-durability path. Cheap when idle:
        one clock read and a compare."""
        if self.autodump_s <= 0:
            return False
        now = time.perf_counter()
        if now - self._last_dump < self.autodump_s:
            return False
        self._last_dump = now
        self.dump("auto")
        return True

    # -- signals ------------------------------------------------------------

    def install_signal_handlers(self, signums=(_signal.SIGTERM,)) -> None:
        """Dump on the given signals, then chain to the previous handler
        (SIG_DFL is re-raised so default termination semantics survive).
        Each handler carries ``without_chain``, the same without that
        re-raise, for a later handler that chains to it on a signal it
        latches. Best-effort: off the main thread this is a silent no-op."""
        for signum in signums:
            try:
                prev = _signal.getsignal(signum)

                def handler(num, frame, _prev=prev):
                    self.dump("signal")
                    if callable(_prev):
                        _prev(num, frame)
                    elif _prev == _signal.SIG_DFL:
                        _signal.signal(num, _signal.SIG_DFL)
                        os.kill(os.getpid(), num)

                # The dump and a callable previous handler, without the
                # re-raise of SIG_DFL (or Python's KeyboardInterrupt): a
                # handler installed later that latches the signal for a
                # graceful stop (the trainer's PreemptionGuard) runs this
                # on the first signal instead of the whole handler, whose
                # re-raise would end the process before the checkpoint.
                def without_chain(num, frame, _prev=prev):
                    self.dump("signal")
                    if callable(_prev) and _prev is not _signal.default_int_handler:
                        _prev(num, frame)

                handler.without_chain = without_chain
                _signal.signal(signum, handler)
            except (ValueError, OSError):
                pass


def load_flight_record(path: str) -> dict | None:
    """Read one dump file; None (never an exception) when missing or torn
    — the Supervisor salvages best-effort from a process that just died."""
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) and "events" in doc else None


def flight_path_for(metrics_jsonl: str) -> str:
    """The ONE definition of where a process's flight dumps live relative
    to its event log — the replica, the CLI flags, and the Supervisor's
    salvage must agree byte-for-byte."""
    return f"{metrics_jsonl}.flight.json"
