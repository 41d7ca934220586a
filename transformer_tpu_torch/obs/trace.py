"""Request-scoped distributed tracing: hierarchical spans over the event log.

Port of ``transformer_tpu/obs/trace.py`` (standard library only). The
metrics registry answers "how is the fleet doing"; this module answers
"where did THIS request's latency go". A :class:`Tracer` mints spans with
``trace_id`` / ``span_id`` / ``parent_id`` lineage and emits one
``trace.span`` event per CLOSED span onto the JSONL
:class:`~transformer_tpu_torch.obs.events.EventLog` — no second sink, no
second file format. :func:`chrome_trace` converts any such log into the
Chrome trace-event JSON that chrome://tracing and Perfetto load
(``python -m transformer_tpu_torch.obs trace <jsonl> --out trace.json``),
one lane per serve slot plus scheduler/intake/train lanes.

Design rules:

- **Host-only.** Spans are host wall-clock bookkeeping; nothing here
  touches device values, so answers, losses and kernel launches are the
  same with tracing on and off. A span around a CUDA graph replay sits
  outside the capture (Python inside a capture runs once, at capture).
- **Emit on close.** One event per span, written when the span ends (with
  its start time ``t0`` and duration ``dur_s``), so the log stays
  append-only and a crash loses only the spans still open;
  ``Tracer.open_count`` makes "every opened span closes exactly once"
  directly assertable.
- **Context crosses processes.** :class:`SpanContext` serializes to the
  W3C ``traceparent`` form (``00-<trace>-<span>-01``); the fleet's router
  mints one per request (under an incoming client ``traceparent`` when the
  request has one) and forwards it to the replica that serves it, whose
  scheduler adopts it as the root parent, so every redispatch keeps one
  trace id and a cross-file merge (``obs/merge.py``) re-joins one
  request's spans across the router's and the replicas' logs.

Parenting: ``tracer.span(...)`` (the context-manager form) keeps a
per-thread current-span stack, so nested ``with`` blocks — and any
:func:`traced_call`-wrapped function invoked inside them — parent
automatically. Long-lived spans that outlive a call frame (a serve
request's lifecycle across many scheduler steps) use ``start_span`` /
``Span.end`` with an explicit ``parent=`` instead; they never sit on the
stack.

Thread-safety: spans may start on one thread (client ``submit``) and end
on another (the scheduler loop); the tracer's open-span accounting is
locked, and emission goes through the multi-writer-safe EventLog.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

#: Reserved field names in a ``trace.span`` event — span attributes may not
#: shadow them (``Span.end`` silently drops offenders rather than corrupt
#: the schema; the exporter and merge tooling key on these).
RESERVED_SPAN_FIELDS = frozenset(
    {"ts", "kind", "trace", "span", "parent", "name", "lane", "t0", "dur_s"}
)

_TRACEPARENT_VERSION = "00"


def _hex_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


class SpanContext:
    """The serializable identity of one span: ``(trace_id, span_id)``.

    ``trace_id`` is 16 bytes (32 hex chars) shared by every span of one
    request's tree; ``span_id`` is 8 bytes (16 hex chars) unique per span.
    The wire form is the W3C traceparent header: ``00-<trace>-<span>-01``.
    """

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    @classmethod
    def new(cls) -> "SpanContext":
        return cls(_hex_id(16), _hex_id(8))

    def child(self) -> "SpanContext":
        """A fresh span id under the same trace."""
        return SpanContext(self.trace_id, _hex_id(8))

    def to_traceparent(self) -> str:
        return f"{_TRACEPARENT_VERSION}-{self.trace_id}-{self.span_id}-01"

    @classmethod
    def from_traceparent(cls, header) -> "SpanContext | None":
        """Parse a traceparent header; None (never an exception) on any
        malformation — an invalid incoming header must degrade to "start a
        new trace", not error the request carrying it (W3C semantics)."""
        if not isinstance(header, str):
            return None
        parts = header.strip().lower().split("-")
        if len(parts) != 4:
            return None
        version, trace_id, span_id, _flags = parts
        if len(version) != 2 or version == "ff":
            return None
        if len(trace_id) != 32 or len(span_id) != 16:
            return None
        try:
            int(trace_id, 16), int(span_id, 16)
        except ValueError:
            return None
        if trace_id == "0" * 32 or span_id == "0" * 16:
            return None
        return cls(trace_id, span_id)


class Span:
    """One timed operation. Created by the tracer, closed exactly once by
    ``end()`` — which is when (and only when) its event is emitted."""

    __slots__ = (
        "name", "ctx", "parent_id", "lane", "attrs",
        "_t0_wall", "_t0_mono", "_tracer", "_ended",
    )

    def __init__(self, tracer: "Tracer", name: str, ctx: SpanContext,
                 parent_id: "str | None", lane: "str | None", attrs: dict):
        self.name = name
        self.ctx = ctx
        self.parent_id = parent_id
        self.lane = lane
        self.attrs = attrs
        self._t0_wall = time.time()
        self._t0_mono = time.perf_counter()
        self._tracer = tracer
        self._ended = False

    def set(self, **attrs) -> None:
        """Attach/overwrite attributes before the span closes (recorded in
        the close event). Reserved schema fields are refused at end()."""
        self.attrs.update(attrs)

    def end(self, **attrs) -> None:
        """Close the span and emit its ``trace.span`` event. Exactly-once:
        a second end() is counted (``tracer.stats['double_end']``) and
        otherwise ignored — telemetry must never raise into serving code,
        and the span-tree tests read the counter."""
        if attrs:
            self.attrs.update(attrs)
        self._tracer._end_span(self)


class Tracer:
    """Span factory bound to an emit callable (``EventLog.emit`` or
    ``Telemetry.emit`` — anything with the ``(kind, **fields)`` shape)."""

    def __init__(self, emit) -> None:
        self._emit = emit
        self._lock = threading.Lock()
        self._open: dict[str, str] = {}  # span_id -> name (introspection)
        self._local = threading.local()
        self.stats = {"started": 0, "ended": 0, "double_end": 0,
                      "dropped_attrs": 0}

    # ---- introspection (the span-tree completeness surface) ---------------

    @property
    def open_count(self) -> int:
        with self._lock:
            return len(self._open)

    def open_spans(self) -> dict[str, str]:
        """span_id -> name of every not-yet-closed span (a copy)."""
        with self._lock:
            return dict(self._open)

    # ---- span lifecycle ----------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def current(self) -> "Span | None":
        """The innermost ``span()`` context on THIS thread, or None."""
        stack = self._stack()
        return stack[-1] if stack else None

    def start_span(
        self, name: str, parent=None, lane: "str | None" = None, **attrs
    ) -> Span:
        """Open a span. ``parent`` may be a :class:`Span`, a
        :class:`SpanContext` (e.g. parsed from an incoming traceparent), or
        None — None inherits this thread's current ``span()`` context, and
        starts a NEW trace only when there is none."""
        if parent is None:
            parent = self.current()
        if isinstance(parent, Span):
            parent = parent.ctx
        if isinstance(parent, SpanContext):
            ctx, parent_id = parent.child(), parent.span_id
        else:
            ctx, parent_id = SpanContext.new(), None
        span = Span(self, name, ctx, parent_id, lane, attrs)
        with self._lock:
            self.stats["started"] += 1
            self._open[ctx.span_id] = name
        return span

    def _end_span(self, span: Span) -> None:
        if span._ended:
            with self._lock:
                self.stats["double_end"] += 1
            return
        span._ended = True
        dur = time.perf_counter() - span._t0_mono
        with self._lock:
            self.stats["ended"] += 1
            self._open.pop(span.ctx.span_id, None)
        fields = {
            "trace": span.ctx.trace_id,
            "span": span.ctx.span_id,
            "name": span.name,
            "t0": round(span._t0_wall, 6),
            "dur_s": round(dur, 9),
        }
        if span.parent_id is not None:
            fields["parent"] = span.parent_id
        if span.lane is not None:
            fields["lane"] = span.lane
        for key, value in span.attrs.items():
            if key in RESERVED_SPAN_FIELDS or key in fields:
                with self._lock:
                    self.stats["dropped_attrs"] += 1
                continue
            fields[key] = value
        # ts = close time, consistent with every other event kind; t0/dur_s
        # carry the interval (the exporter never trusts ts for geometry).
        self._emit("trace.span", ts=round(span._t0_wall + dur, 6), **fields)

    @contextlib.contextmanager
    def span(self, name: str, parent=None, lane: "str | None" = None, **attrs):
        """Context-manager span: parents to the enclosing ``span()`` on this
        thread (unless ``parent=`` overrides), pushes itself as current for
        the duration, and always closes — even on exception (recorded as
        ``error=<type name>``; the exception propagates untouched)."""
        sp = self.start_span(name, parent=parent, lane=lane, **attrs)
        stack = self._stack()
        stack.append(sp)
        try:
            yield sp
        except BaseException as e:
            sp.end(error=type(e).__name__)
            raise
        finally:
            stack.pop()
            if not sp._ended:
                sp.end()


def traced_call(fn, tracer: Tracer, name: str, lane: "str | None" = None,
                **attrs):
    """Wrap ``fn`` so every call runs inside a ``tracer.span(name)`` —
    parenting to whatever span is current on the calling thread. The
    tracing sibling of ``obs.telemetry.timed_call``: it forwards ``fn``'s
    outputs untouched and adds no device work."""

    def wrapped(*args, **kwargs):
        with tracer.span(name, lane=lane, **attrs):
            return fn(*args, **kwargs)

    wrapped.__wrapped__ = fn
    return wrapped


# --------------------------------------------------------------------------
# Perfetto / Chrome trace-event export

#: Fixed lane -> tid mapping: control lanes first, then one lane per serve
#: slot (``slot0``.. at tid 10+), so every export of the same run lays out
#: identically. Unknown lanes allocate past the slots. ``router`` is the
#: front-end dispatcher's own lane (serve/router.py) — in a multi-source
#: merge the router's log is additionally its own PROCESS row, since
#: processes key on the ``source`` tag.
_CONTROL_LANES = {"intake": 1, "scheduler": 2, "train": 3, "router": 4}
_SLOT_TID_BASE = 10


def _lane_tid(lane: str, extra: dict) -> int:
    if lane in _CONTROL_LANES:
        return _CONTROL_LANES[lane]
    if lane.startswith("slot"):
        try:
            return _SLOT_TID_BASE + int(lane[4:])
        except ValueError:
            pass
    if lane not in extra:
        extra[lane] = 1000 + len(extra)
    return extra[lane]


def chrome_trace(events: list) -> dict:
    """``trace.span`` events -> a Chrome trace-event JSON document (the
    ``{"traceEvents": [...]}`` object form), loadable in chrome://tracing
    and ui.perfetto.dev. Each span becomes one complete ("X") event; each
    source file (multi-source merge) becomes one process with its lanes as
    named threads. Non-span events are ignored, so the exporter runs on
    any event log."""
    spans = [
        e for e in events
        if e.get("kind") == "trace.span"
        and isinstance(e.get("t0"), (int, float))
        and isinstance(e.get("dur_s"), (int, float))
    ]
    pids: dict[str, int] = {}
    extra_lanes: dict[tuple, int] = {}
    out: list[dict] = []
    seen_threads: set[tuple] = set()
    base = min((e["t0"] for e in spans), default=0.0)
    for e in spans:
        source = str(e.get("source", "main"))
        if source not in pids:
            pids[source] = len(pids) + 1
            out.append({
                "ph": "M", "name": "process_name", "pid": pids[source],
                "tid": 0, "args": {"name": source},
            })
        pid = pids[source]
        lane = str(e.get("lane", "main"))
        per_source = extra_lanes.setdefault(("extra", source), {})
        tid = _lane_tid(lane, per_source)
        if (pid, tid) not in seen_threads:
            seen_threads.add((pid, tid))
            out.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": lane},
            })
            # Sort index keeps lanes in the fixed tid order in the UI.
            out.append({
                "ph": "M", "name": "thread_sort_index", "pid": pid,
                "tid": tid, "args": {"sort_index": tid},
            })
        args = {
            k: v for k, v in e.items()
            if k not in ("kind", "t0", "dur_s", "lane", "name", "ts", "source")
        }
        out.append({
            "ph": "X",
            "name": str(e.get("name", "span")),
            "cat": str(e.get("name", "span")).split(".", 1)[0],
            "pid": pid,
            "tid": tid,
            "ts": round((e["t0"] - base) * 1e6, 3),   # microseconds
            "dur": round(max(e["dur_s"], 0.0) * 1e6, 3),
            "args": args,
        })
    out.sort(key=lambda ev: (ev["ph"] != "M", ev.get("ts", 0.0)))
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {
            # The JAX package's producer tag: an export of either
            # package's log is the same document.
            "producer": "transformer_tpu.obs trace",
            "sources": sorted(pids),
            "spans": len(spans),
            "base_unix_s": round(base, 6),
        },
    }


def span_tree(events: list) -> dict:
    """Index ``trace.span`` events into ``{trace_id: {span_id: event}}`` —
    the shape the completeness tests and the merge skew estimator walk."""
    trees: dict[str, dict[str, dict]] = {}
    for e in events:
        if e.get("kind") != "trace.span":
            continue
        trace, span = e.get("trace"), e.get("span")
        if isinstance(trace, str) and isinstance(span, str):
            trees.setdefault(trace, {})[span] = e
    return trees
