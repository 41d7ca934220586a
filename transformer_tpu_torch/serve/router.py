"""The fleet's front end: one router over N replica worker processes.

Port of ``transformer_tpu/serve/router.py``. A :class:`Router` owns client
intake (the scheduler's ``submit`` / ``submit_done`` / ``drain_ready``
surface, plus the line loop of ``cli/router.py``) and dispatches to N
replica workers (``serve/replica.py``), each a process running the
continuous scheduler over its own copy of the model. The router loads no
model and launches nothing on the card: the tokenizer is all it needs,
for affinity hashing.

Dispatch: **prefix affinity first, least-loaded as the fallback**. The
prompt's leading ``affinity_block``-aligned token blocks are hashed (the
alignment the prefix cache keys on) and the request goes, by rendezvous
hashing over the usable replicas, to the one whose ``PrefixCache`` is
warm for that prefix; a replica's death remaps only the keys it owned.
When the affine replica's load (router-assigned in-flight + heartbeat
backlog) exceeds the least-loaded one's by more than ``affinity_slack``,
the request goes to the least-loaded.

**Zero-loss failover**: every dispatched, unanswered request sits in an
order-keyed in-flight table. A replica's death (pipe EOF, a failed send,
process exit, missed heartbeats, each feeding a per-replica
:class:`~transformer_tpu_torch.obs.breaker.CircuitBreaker`) puts its
requests back at the front of the pending queue in their order, with
their trace id and deadline; a request is redispatched at most
``max_redispatch`` times, then answers ``transient``. A worker failed
over on heartbeats whose process still runs comes back through the
breaker's half-open probe when a newer heartbeat arrives. **At most one
answer per request**: an answer for an order already answered or drained
is counted and dropped.

**Trace identity**: each request gets a router-minted
:class:`~transformer_tpu_torch.obs.trace.SpanContext` (under the client's
``traceparent`` when it sends one), forwarded to the replica as the W3C
``traceparent`` field.

**Disaggregated prefill/decode** (``disaggregate=True``): a request first
goes to a prefill replica, which ingests the prompt (``max_new`` 0) and
hands back its KV as prefix-cache blocks (``serve/replica.py``
``export_blocks``); the router forwards the request and the blocks to a
decode replica, which injects them into its own cache, so admission
restores them without a forward. Losing either side degrades to a full
prefill on a live replica, never to a lost request.

Threads: client threads call ``submit`` / ``submit_done`` /
``drain_ready`` under the intake lock; each replica's reader thread only
parses its pipe's lines into the router's inbox queue; every dispatch,
answer and liveness table belongs to the one thread that runs
:meth:`Router.pump`.

``telemetry``, where given, is an ``obs.Telemetry`` (or, in tests, any
object with ``emit(kind, **fields)``): the router's events
(``route.failover``, ``route.revive``, ``route.dispatch``, and those of
the supervisor and the rollout) go there; with a registry, the
``router_*`` counters, the ``router_queue_seconds`` histogram and the
fleet-size gauges; with a tracer, one ``route.request`` span per request
on the ``router`` lane, the parent of the replica's ``serve.request``
span (its ``traceparent``), so ``python -m transformer_tpu_torch.obs
trace ROUTER ROUTER.r0 ROUTER.r1`` joins them.

**Router HA** (``ha=True``): the router journals what a warm standby
(``serve/standby.py``) needs to adopt the fleet to that event log: one
``route.intake`` per accepted order (the request, its traceparent and its
remaining deadline budget; a pre-answered order its response),
``route.answered`` delivery marks from :meth:`Router.drain_ready`, and a
``route.hb`` beacon every ``ha_heartbeat_s`` with the authority
``epoch`` and the workers' takeover ports (their ``ready`` lines'
``control_port``). A standby that adopts builds its Router through
:meth:`Router.seed_takeover`, which journals the adopted orders again for
the next standby.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import queue
import subprocess
import sys
import threading
import time
from collections import deque

from transformer_tpu_torch.obs.slo import SLOEngine, parse_slo_spec
from transformer_tpu_torch.obs.trace import SpanContext
from transformer_tpu_torch.serve.resilience import (
    CircuitBreaker,
    InjectedFault,
    error_answer,
    maybe_fail,
)

def affinity_key(ids, block: int) -> "int | None":
    """Hash of the prompt's leading ``block``-aligned token blocks: the
    prefix a replica's ``PrefixCache`` would match (the prompt less its
    last token, rounded down to whole blocks). None when the prompt is
    shorter than one block: the request then goes least-loaded."""
    if block < 1:
        return None
    aligned = ((len(ids) - 1) // block) * block
    if aligned < block:
        return None
    digest = hashlib.blake2b(
        ("/".join(str(i) for i in ids[:aligned])).encode(), digest_size=8
    ).digest()
    return int.from_bytes(digest, "big")


def _rendezvous(key: int, name: str) -> int:
    """Highest-random-weight score of (affinity key, replica name): each
    key ranks every replica on its own, so removing a dead replica remaps
    only the keys it owned."""
    digest = hashlib.blake2b(key.to_bytes(8, "big") + name.encode(), digest_size=8).digest()
    return int.from_bytes(digest, "big")


class _RouterLineError(ValueError):
    """A line for another export kind, answered with the bare message
    (``cli/serve.py``'s answers to the same lines)."""


def parse_router_line(line: str) -> dict:
    """One stdin line -> LM request dict (raises :class:`_RouterLineError`
    with ``cli/serve.py``'s messages: the fleet serves LM exports only)."""
    if line.startswith("{"):
        req = json.loads(line)
        if not isinstance(req, dict):
            raise ValueError("request must be a JSON object")
    else:
        req = {"prompt": line}
    if "src" in req:
        raise _RouterLineError("LM export serves 'prompt', not 'src'")
    if "prompt" not in req:
        if "fill" in req:
            raise _RouterLineError("LM export serves 'prompt', not 'fill'")
        raise _RouterLineError(
            "request needs 'src' (seq2seq), 'prompt' (LM) or "
            "'fill' (masked-LM)"
        )
    return req


# A worker's ``prefix_state`` line (``serve/replica.py`` ``export_state``,
# written by ``json.dumps``) starts with this. The reader delivers it
# unparsed, as ``{"type": "prefix_state", "line": <the line>}``, the one
# form the supervisor takes, which forwards it to the replacement as its
# ``inject_state`` (``inject_state_line``). The port's worker puts the
# warm-up's KV in a file the line names; a line in the JAX worker's form
# carries it inline (hundreds of MB for long prompts in fp32), and parsing
# it here and encoding it again would cost seconds on the router's thread.
PREFIX_STATE_HEAD = '{"type": "prefix_state", '


def inject_state_line(prefix_state_line: str) -> str:
    """A worker's raw ``prefix_state`` line as the ``inject_state`` message
    for another worker: the same JSON, the type renamed."""
    return '{"type": "inject_state", ' + prefix_state_line[len(PREFIX_STATE_HEAD):]


@dataclasses.dataclass
class _Tracked:
    """One accepted request, from submit to its one answer."""

    order: int
    req: dict
    ctx: SpanContext            # router-minted, the same on every redispatch
    t_submit: float
    deadline: float | None      # absolute perf_counter, or None
    affinity: int | None
    attempts: int = 0           # dispatches (the prefill -> decode stage too)
    redispatches: int = 0       # failover redispatches: what max_redispatch bounds
    refailed: bool = False      # the next dispatch is a failover redispatch
    replica: int | None = None  # current assignment (None = pending)
    t_dispatch: float | None = None   # first dispatch
    stage: str = "decode"       # disaggregation: "prefill" -> "decode"
    blocks: object = None       # the prefill handoff's payload
    blocks_tokens: int = 0
    span_root: object = None    # the route.request span (None without a tracer)


class ReplicaLink:
    """The router's handle on one replica worker: ``send`` plus liveness
    and load bookkeeping. The subprocess transport is
    :class:`ReplicaProcess`; tests substitute in-process fakes with the
    same surface (``send`` / ``alive`` / ``close`` / ``kill``)."""

    def __init__(self, index: int, name: str, role: str = "both"):
        self.index = index
        self.name = name
        self.role = role            # "both" | "prefill" | "decode"
        # Router-thread bookkeeping, fed by heartbeats and topped up by the
        # router's own assignment counts between beats.
        self.inflight = 0
        self.hb_backlog = 0
        self.hb_free = 0
        self.hb_active = 0
        self.last_hb: float | None = None
        self.dispatched = 0
        self.answered = 0
        self.dead = False
        self.died_at: float | None = None  # only a newer heartbeat revives
        # Supervision: a warming replacement takes no traffic yet; a
        # draining one finishes its in-flight work, then retires for good.
        self.warming = False
        self.draining = False
        self.retired = False
        # Live weights: an upgrading link takes no new dispatches; ``wv``
        # is the replica's last confirmed weight_version (None untagged).
        self.upgrading = False
        self.wv: str | None = None
        self.control_port: int | None = None  # the worker's --ha takeover socket
        self.final_stats: dict | None = None  # the replica's shutdown report
        self.final_perf: dict | None = None   # ... and its profiler's rows, if armed
        self.flight_record: dict | None = None  # the last ``dump`` reply's record
        # Where the worker's event log (and so its flight dumps) lives: the
        # supervisor salvages <metrics_jsonl>.flight.json after a hard kill.
        self.metrics_jsonl: str | None = None

    def send(self, msg: dict) -> None:
        raise NotImplementedError

    def send_line(self, line: str) -> None:
        """Send a message that is already one JSON line (the warm-up's
        forwarded ``inject_state``)."""
        raise NotImplementedError

    def alive(self) -> bool:
        """Transport liveness only (does the worker process still run?);
        the failover policy lives in ``dead``, which a revival clears."""
        return True

    def close(self) -> None:
        pass

    def kill(self) -> None:
        """Force the worker down (the supervisor's slot reclaim)."""

    def serves(self, stage: str) -> bool:
        return self.role == "both" or self.role == stage


class ReplicaProcess(ReplicaLink):
    """A replica worker as a subprocess speaking JSON lines over its pipes.
    The reader thread only parses stdout lines into the router's inbox
    (and puts an ``exit`` sentinel there at EOF)."""

    def __init__(self, index: int, name: str, argv: list[str], role: str = "both"):
        super().__init__(index, name, role=role)
        self._proc = subprocess.Popen(
            argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=sys.stderr, text=True, bufsize=1,
        )
        self._reader: threading.Thread | None = None

    @classmethod
    def spawn(cls, index: int, worker_args: list[str], role: str = "both",
              name: str | None = None) -> "ReplicaProcess":
        """Launch ``python -m transformer_tpu_torch.serve.replica`` with
        ``worker_args`` and the replica's identity flags."""
        name = name or f"replica{index}"
        argv = [
            sys.executable, "-m", "transformer_tpu_torch.serve.replica",
            "--replica_name", name, "--role", role, *worker_args,
        ]
        link = cls(index, name, argv, role=role)
        for i, arg in enumerate(worker_args):
            if arg == "--metrics_jsonl" and i + 1 < len(worker_args):
                link.metrics_jsonl = worker_args[i + 1] or None
            elif arg.startswith("--metrics_jsonl="):
                link.metrics_jsonl = arg.split("=", 1)[1] or None
        return link

    def start_reader(self, inbox: "queue.Queue") -> None:
        self._reader = threading.Thread(
            target=self._read_loop, args=(inbox, self._proc.stdout),
            name=f"router-read-{self.name}", daemon=True,
        )
        self._reader.start()

    def _read_loop(self, inbox: "queue.Queue", stdout) -> None:
        for line in stdout:
            line = line.strip()
            if not line:
                continue
            if line.startswith(PREFIX_STATE_HEAD):
                if line.endswith("}"):  # else torn by a dying replica
                    inbox.put((self.index, {"type": "prefix_state", "line": line}))
                continue
            try:
                msg = json.loads(line)
            except ValueError:
                continue  # the torn last line of a dying replica
            if isinstance(msg, dict):
                inbox.put((self.index, msg))
        # The pid marks the sentinel, so that a respawned replacement at
        # this index is never failed over by its predecessor's EOF.
        inbox.put((self.index, {"type": "exit", "pid": self._proc.pid}))

    def send(self, msg: dict) -> None:
        self.send_line(json.dumps(msg))

    def send_line(self, line: str) -> None:
        stdin = self._proc.stdin
        if stdin is None or self._proc.poll() is not None:
            raise BrokenPipeError(f"replica {self.name} is gone")
        stdin.write(line + "\n")
        stdin.flush()

    def alive(self) -> bool:
        return self._proc.poll() is None

    def pid(self) -> int:
        return self._proc.pid

    def kill(self) -> None:
        if self._proc.poll() is None:
            self._proc.kill()

    def close(self, timeout: float = 10.0) -> None:
        try:
            self.send({"type": "shutdown"})
        except (OSError, ValueError):
            pass
        try:
            self._proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait()
        if self._reader is not None:
            self._reader.join(timeout=timeout)  # its last lines reach the inbox


class Router:
    """Front-end dispatcher over N replica links.

    Client surface (any thread, under the intake lock): :meth:`submit`,
    :meth:`submit_done`, :meth:`drain_ready` and the ``busy`` /
    ``has_ready`` / ``backlog`` properties: the scheduler's own shape.
    Control surface (the one router thread): :meth:`pump` drains the inbox
    (answers, heartbeats, prefill handoffs, exits), sweeps liveness and
    dispatches pending requests. :meth:`run` serves a list to completion."""

    def __init__(
        self,
        links: "list[ReplicaLink]",
        *,
        encode=None,
        bos_id: int = 1,
        affinity_block: int = 16,
        affinity_slack: int = 4,
        max_redispatch: int = 2,
        heartbeat_timeout_s: float = 0.0,
        breaker_threshold: int = 1,
        breaker_cooldown_s: float = 30.0,
        disaggregate: bool = False,
        telemetry=None,
        supervisor=None,
        scaler=None,
        upgrader=None,
        slos=None,
        ha: bool = False,
        epoch: int = 1,
        ha_heartbeat_s: float = 0.5,
    ):
        if not links:
            raise ValueError("router needs at least one replica link")
        self.links = list(links)
        self.encode = encode          # str -> token ids (affinity only; None = least-loaded)
        self.bos_id = bos_id
        self.affinity_block = affinity_block
        self.affinity_slack = affinity_slack
        self.max_redispatch = max(0, max_redispatch)
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.disaggregate = disaggregate
        if disaggregate:
            if not any(l.serves("prefill") for l in links) or not any(
                l.serves("decode") for l in links
            ):
                raise ValueError(
                    "disaggregate mode needs at least one prefill-capable "
                    "and one decode-capable replica"
                )
        # The one channel from the reader threads (and fakes) into the
        # router thread: (replica_index, msg) tuples.
        self.inbox: queue.Queue = queue.Queue()
        # Intake state (client threads + router thread, under this lock).
        self._intake_lock = threading.Lock()
        self._next_order = 0
        self._done: dict[int, dict] = {}
        self._emit_next = 0
        self._pending: deque[_Tracked] = deque()
        # Router-thread tables.
        self._inflight: dict[int, _Tracked] = {}
        # Per-replica breakers: a death opens one, so the dispatcher stops
        # offering traffic; a half-open probe after the cooldown lets a
        # recovered link earn its way back.
        self._breaker_threshold = breaker_threshold
        self._breaker_cooldown_s = breaker_cooldown_s
        self.breakers = [self._breaker(l) for l in links]
        self.stats = {
            "submitted": 0, "dispatched": 0, "redispatched": 0,
            "answered": 0, "failovers": 0, "revivals": 0,
            "duplicate_answers": 0, "expired": 0, "exhausted": 0,
            "no_replica": 0, "prefill_handoffs": 0, "dropped_heartbeats": 0,
        }
        self._tel = telemetry
        self._sup = supervisor
        self._scaler = scaler
        # Live weights: the rollout coordinator, and the fleet's target
        # (ckpt_dir, weight_version) once a rollout starts (None before and
        # after a rollback); the supervisor's spawn recipe reads it.
        self._upgrader = upgrader
        self.weight_target: "tuple[str, str] | None" = None
        # Router HA: journal intake, delivery and a beacon for a standby.
        self.ha = ha
        self.epoch = epoch
        self.ha_heartbeat_s = ha_heartbeat_s
        self._last_ha_hb = 0.0
        # The router's own SLO engine over the answer funnel (the
        # replicas' per-answer "slo" side channel): the FleetScaler's
        # signal.
        self._slo_engine = None
        if slos is not None and hasattr(slos, "maybe_evaluate"):
            self._slo_engine = slos  # a prebuilt engine
        elif slos:
            specs = parse_slo_spec(slos) if isinstance(slos, str) else tuple(slos)
            if specs:
                self._slo_engine = SLOEngine(
                    specs, registry=getattr(telemetry, "registry", None),
                    emit=telemetry.emit if telemetry is not None else None,
                )
        # submit -> first dispatch, bounded.
        self.queue_latencies: "deque[float]" = deque(maxlen=65536)
        self._tracer = getattr(telemetry, "tracer", None)
        self._reg = getattr(telemetry, "registry", None)
        if self._reg is not None:
            reg = self._reg
            self._m_dispatch = reg.counter("router_dispatch_total",
                                           "requests dispatched to replicas")
            self._m_redispatch = reg.counter("router_redispatch_total",
                                             "failover re-dispatches of in-flight requests")
            self._m_failover = reg.counter("router_failover_total", "replica failures handled")
            self._m_answers = reg.counter("router_answers_total", "replica answers accepted")
            self._m_dup = reg.counter("router_duplicate_answers_total",
                                      "late/duplicate replica answers dropped by the funnel")
            self._m_queue_s = reg.histogram("router_queue_seconds", "submit -> first dispatch")
            self._m_replicas = reg.gauge("router_replicas_live", "replica links currently usable")
            self._m_replicas.set(len(links))
            self._m_fleet = reg.gauge("route_fleet_size",
                                      "healthy serving replicas (live, admitted, not draining)")
            self._m_fleet.set(len(links))
        if supervisor is not None:
            supervisor.attach(self)
        if scaler is not None:
            if supervisor is None:
                raise ValueError("a FleetScaler needs a Supervisor to act")
            scaler.bind(self, supervisor)
        if upgrader is not None:
            upgrader.attach(self)

    def _breaker(self, link: ReplicaLink) -> CircuitBreaker:
        return CircuitBreaker(
            f"replica_{link.name}", threshold=self._breaker_threshold,
            cooldown_s=self._breaker_cooldown_s,
        )

    # ---- client intake (any thread) ---------------------------------------

    def submit(self, req: dict) -> int:
        """Accept one LM request; returns its output order. Affinity and
        trace identity are minted here, so a failover redispatches with
        both."""
        now = time.perf_counter()
        parent = SpanContext.from_traceparent(req.get("traceparent"))
        span_root = None
        if self._tracer is not None:
            span_root = self._tracer.start_span("route.request", parent=parent, lane="router")
            ctx = span_root.ctx
        else:
            ctx = parent.child() if parent is not None else SpanContext.new()
        affinity = None
        if self.encode is not None:
            try:
                ids = [self.bos_id, *self.encode(str(req.get("prompt", "")))]
                affinity = affinity_key(ids, self.affinity_block)
            except Exception:  # noqa: BLE001 — affinity is a hint: the replica answers the bad request
                affinity = None
        deadline = None
        try:
            d = req.get("deadline_ms")
            if d is not None:
                deadline = now + float(d) / 1e3
        except (TypeError, ValueError):
            pass  # the replica's admission answers the validation error
        with self._intake_lock:
            rr = _Tracked(
                order=self._next_order, req=req, ctx=ctx, t_submit=now, deadline=deadline,
                affinity=affinity, stage="prefill" if self.disaggregate else "decode",
                span_root=span_root,
            )
            self._next_order += 1
            self.stats["submitted"] += 1
            self._pending.append(rr)
        if self.ha:
            self._journal_intake(rr, now)
        return rr.order

    def _journal_intake(self, rr: _Tracked, now: float) -> None:
        """The standby's replayable record of an accepted order: enough to
        re-own or redispatch it after adopting the fleet (the request, its
        trace identity, the deadline budget left at ``now``)."""
        self.emit_event(
            "route.intake", order=rr.order, req=rr.req, traceparent=rr.ctx.to_traceparent(),
            deadline_ms=None if rr.deadline is None else round((rr.deadline - now) * 1e3, 3),
        )

    def submit_done(self, resp: dict) -> int:
        """Reserve an output position for an already-answered response
        (parse and routing errors): order holds across both."""
        with self._intake_lock:
            order = self._next_order
            self._next_order += 1
            self.stats["submitted"] += 1
            self._done[order] = resp
        if self.ha:
            # A pre-answered order carries its response: the standby answers
            # it from the log alone.
            self.emit_event("route.intake", order=order, resp=resp)
        if self._tracer is not None:
            span = self._tracer.start_span("route.request", lane="router")
            extra = {}
            if "error" in resp:
                extra = {"error": resp["error"]}
                if "code" in resp:
                    extra["code"] = resp["code"]
            span.end(order=order, **extra)
        return order

    def drain_ready(self) -> list[dict]:
        """Responses completed, in arrival order (the stdout contract)."""
        out = []
        with self._intake_lock:
            first = self._emit_next
            while self._emit_next in self._done:
                out.append(self._done.pop(self._emit_next))
                self._emit_next += 1
            last = self._emit_next
        if self.ha and out:
            # Delivery marks, not completion marks: an answer waiting out of
            # order in ``_done`` dies with this process and the standby
            # recovers it from the workers, while a delivered order must
            # never reach the client twice.
            self.emit_event("route.answered", first=first, upto=last - 1, n=len(out))
        return out

    @property
    def busy(self) -> bool:
        with self._intake_lock:
            return self._emit_next < self._next_order

    @property
    def has_ready(self) -> bool:
        with self._intake_lock:
            return self._emit_next in self._done

    @property
    def backlog(self) -> int:
        """Accepted, unanswered requests (pending + in flight)."""
        with self._intake_lock:
            return (self._next_order - self._emit_next) - len(self._done)

    # ---- the router thread -------------------------------------------------

    def pump(self, timeout: float = 0.05) -> bool:
        """One turn of the control loop: drain the inbox (waiting up to
        ``timeout`` only when nothing is pending), sweep liveness,
        dispatch, then advance the supervisor, the rollout and the scaler.
        Returns whether anything happened."""
        progressed = self._drain_inbox(timeout)
        self._sweep_liveness()
        progressed |= self._dispatch_pending()
        if self._sup is not None:
            progressed |= self._sup.poll()
            progressed |= self._sup.reap_draining()
        if self._upgrader is not None:
            progressed |= self._upgrader.poll()
        slo_result = None
        if self._slo_engine is not None:
            slo_result = self._slo_engine.maybe_evaluate()
        if self._scaler is not None:
            progressed |= self._scaler.poll(slo_result)
        if self.ha:
            self._ha_heartbeat()
        return progressed

    def run(self, reqs: "list[dict]") -> "list[dict]":
        """Submit ``reqs`` and pump until each is answered; the answers in
        request order."""
        for req in reqs:
            self.submit(req)
        out: list[dict] = []
        while self.busy:
            self.pump()
            out.extend(self.drain_ready())
        out.extend(self.drain_ready())
        self._flush()
        return out

    def shutdown(self) -> None:
        """Close every replica link (a graceful drain where the transport
        has one), keep each replica's final ``stats`` report, and flush
        telemetry."""
        for link in self.links:
            link.close()
        while True:
            try:
                index, msg = self.inbox.get_nowait()
            except queue.Empty:
                break
            if msg.get("type") == "stats":
                self.links[index].final_stats = msg.get("stats")
                self.links[index].final_perf = msg.get("perf")
        self._flush()

    def _flush(self) -> None:
        if hasattr(self._tel, "maybe_flush"):
            self._tel.maybe_flush(force=True)

    # -- fleet management (the supervisor's and the rollout's outlets) --------

    def emit_event(self, kind: str, **fields) -> None:
        if self._tel is not None:
            self._tel.emit(kind, **fields)

    def replace_link(self, index: int, link: ReplicaLink) -> None:
        """Put a respawned replacement in under its predecessor's index and
        name: rendezvous hashing offers it the keys the dead replica
        owned. It arrives ``warming``; the supervisor admits it."""
        self.links[index] = link
        link.last_hb = None
        if hasattr(link, "start_reader"):
            link.start_reader(self.inbox)
        self.on_fleet_change()

    def on_fleet_change(self) -> None:
        """Refresh the fleet-size gauges after a membership change."""
        if self._reg is not None:
            self._m_replicas.set(sum(1 for l in self.links if not l.dead))
            self._m_fleet.set(len(self.healthy_links))

    def append_link(self, link: ReplicaLink) -> None:
        """Grow the fleet by one (a scale-up): a fresh breaker, a fresh
        rendezvous name."""
        self.links.append(link)
        self.breakers.append(self._breaker(link))
        if hasattr(link, "start_reader"):
            link.start_reader(self.inbox)
        self.on_fleet_change()

    def start_upgrade(self, ckpt: str) -> dict:
        """Begin a rolling weight swap to ``ckpt`` (``--upgrade`` and the
        control line both land here); the coordinator's status dict, or a
        structured refusal when the router has none."""
        if self._upgrader is None:
            return {
                "ok": False, "code": "upgrade",
                "error": "this router has no UpgradeCoordinator attached",
            }
        return self._upgrader.start(ckpt)

    def reset_breaker(self, index: int) -> None:
        """A freshly admitted replacement process gets a fresh breaker (an
        open one ignores stray successes, so re-arming is explicit)."""
        self.breakers[index] = self._breaker(self.links[index])

    @property
    def healthy_links(self) -> "list[ReplicaLink]":
        """Links serving now: live, admitted, not draining, not upgrading."""
        return [
            l for l in self.links
            if not l.dead and not l.warming and not l.draining and not l.upgrading
        ]

    def seed_takeover(
        self,
        *,
        next_order: int,
        emit_next: int,
        done: "dict[int, dict]",
        inflight: "list[tuple[int, _Tracked]]",
        pending: "list[_Tracked]",
    ) -> None:
        """Install a warm standby's adopted state (``serve/standby.py``):
        the order clock resumes past every order the primary minted,
        delivery at the client's floor ``emit_next``; recovered answers go
        to the funnel, orders a worker claimed are re-owned in the in-flight
        table once, the unknown ones queue for dispatch. Called before the
        pump thread starts. In ``ha`` mode the adopted orders are journaled
        again, since a chained standby reads only this router's log."""
        with self._intake_lock:
            self._next_order = max(self._next_order, next_order)
            self._emit_next = emit_next
            self._done.update(done)
            self._pending.extend(pending)
        for index, rr in inflight:
            rr.replica = index
            self._inflight[rr.order] = rr
            self.links[index].inflight += 1
        if not self.ha:
            return
        if emit_next > 0:
            # The floor (n 0): orders below it reached the client through a
            # predecessor.
            self.emit_event("route.answered", first=emit_next, upto=emit_next - 1, n=0)
        now = time.perf_counter()
        for order in sorted(done):
            self.emit_event("route.intake", order=order, resp=done[order])
        for rr in sorted([rr for _, rr in inflight] + list(pending), key=lambda r: r.order):
            self._journal_intake(rr, now)

    def _ha_heartbeat(self) -> None:
        """The beacon a warm standby watches: a ``route.hb`` event every
        ``ha_heartbeat_s`` with the epoch and the workers' takeover ports.
        The in-flight table is not in it (the standby rebuilds that from
        the intake and delivery records), so it stays O(fleet)."""
        now = time.monotonic()
        if now - self._last_ha_hb < self.ha_heartbeat_s:
            return
        self._last_ha_hb = now
        self.emit_event(
            "route.hb", epoch=self.epoch,
            ports={l.name: l.control_port for l in self.links
                   if l.control_port is not None and not l.retired},
        )

    # -- inbox --------------------------------------------------------------

    def _drain_inbox(self, timeout: float) -> bool:
        with self._intake_lock:
            idle = not self._pending
        try:
            if idle and timeout > 0:
                item = self.inbox.get(timeout=timeout)
            else:
                item = self.inbox.get_nowait()
        except queue.Empty:
            return False
        while True:
            self._handle_msg(*item)
            try:
                item = self.inbox.get_nowait()
            except queue.Empty:
                break
        return True

    def _handle_msg(self, index: int, msg: dict) -> None:
        link = self.links[index]
        kind = msg.get("type")
        if kind == "answer":
            self._on_answer(link, msg)
        elif kind == "hb":
            try:
                # route.hb: swallow replica heartbeats, for heartbeat-loss
                # drills without real stalls.
                maybe_fail("route.hb")
            except InjectedFault:
                self.stats["dropped_heartbeats"] += 1
                return
            link.last_hb = time.monotonic()
            link.hb_backlog = int(msg.get("backlog", 0))
            link.hb_free = int(msg.get("free", 0))
            link.hb_active = int(msg.get("active", 0))
            if msg.get("wv") is not None:
                link.wv = msg["wv"]
        elif kind == "prefilled":
            self._on_prefilled(link, msg)
        elif kind == "exit":
            # A respawned replacement at this index is never failed over by
            # its predecessor's EOF: the sentinel's pid must be the current
            # process's.
            pid = msg.get("pid")
            cur = getattr(link, "pid", None)
            cur = cur() if callable(cur) else None
            if pid is not None and cur is not None and pid != cur:
                return
            if not link.dead:
                self._fail_replica(index, "pipe closed")
        elif kind == "ready":
            link.last_hb = time.monotonic()
            if isinstance(msg.get("control_port"), int):
                link.control_port = msg["control_port"]
            if msg.get("weight_version") is not None:
                # A replica bootstrapped from --init_ckpt announces the
                # verified version it serves.
                link.wv = msg["weight_version"]
            if self._sup is not None and link.warming:
                self._sup.on_ready(link)
        elif kind in ("upgrade_staged", "upgraded"):
            if kind == "upgraded" and msg.get("ok", True):
                link.wv = msg.get("version")
            if self._upgrader is not None:
                self._upgrader.on_msg(link, msg)
        elif kind == "prefix_state":
            if self._sup is not None:
                self._sup.on_prefix_state(link, msg)
        elif kind == "state_injected":
            if self._sup is not None:
                self._sup.on_state_injected(link, msg)
        elif kind == "stats":
            link.final_stats = msg.get("stats")
            link.final_perf = msg.get("perf")
        elif kind == "flight":
            link.flight_record = msg.get("record")

    def _on_answer(self, link: ReplicaLink, msg: dict) -> None:
        order = msg.get("rid")
        rr = self._inflight.pop(order, None)
        if rr is None:
            # At most once: already answered (a failover raced a finishing
            # replica), already drained, or never ours.
            self.stats["duplicate_answers"] += 1
            if self._reg is not None:
                self._m_dup.inc()
            return
        # Unload the replica the order is assigned to now, not the one that
        # answered: a failed-over victim's late answer releases the
        # survivor's slot.
        assigned = self.links[rr.replica] if rr.replica is not None else link
        assigned.inflight = max(0, assigned.inflight - 1)
        link.answered += 1
        resp = msg.get("resp")
        if not isinstance(resp, dict):
            resp = error_answer("internal", f"replica {link.name} returned a malformed answer")
        self._answer(rr, resp, replica=link.name, slo=msg.get("slo"))
        self.breakers[link.index].record_success()

    def _on_prefilled(self, link: ReplicaLink, msg: dict) -> None:
        """Disaggregation stage 1 done: the prefill replica handed the
        prompt's KV blocks back; forward the request and the blocks to a
        decode replica."""
        order = msg.get("rid")
        rr = self._inflight.pop(order, None)
        if rr is None:
            self.stats["duplicate_answers"] += 1
            return
        assigned = self.links[rr.replica] if rr.replica is not None else link
        assigned.inflight = max(0, assigned.inflight - 1)
        self.breakers[link.index].record_success()
        rr.stage = "decode"
        rr.replica = None
        rr.blocks = msg.get("blocks")
        rr.blocks_tokens = int(msg.get("tokens", 0))
        self.stats["prefill_handoffs"] += 1
        with self._intake_lock:
            self._pending.appendleft(rr)

    # -- liveness + failover -------------------------------------------------

    def _sweep_liveness(self) -> None:
        now = time.monotonic()
        for link in self.links:
            if link.dead:
                self._maybe_revive(link)
                continue
            if not link.alive():
                self._fail_replica(link.index, "process exited")
            elif (
                self.heartbeat_timeout_s > 0
                and link.last_hb is not None
                and now - link.last_hb > self.heartbeat_timeout_s
            ):
                self._fail_replica(link.index, "heartbeat timeout")

    def _maybe_revive(self, link: ReplicaLink) -> None:
        """The breaker's half-open arm: a failed-over link whose process
        still runs comes back once a heartbeat newer than its death mark
        arrives and the cooldown has passed; its first answer closes the
        breaker. Exited workers fail ``alive()`` and stay dead."""
        if link.retired or not link.alive():
            return
        if link.last_hb is None or link.died_at is None or link.last_hb <= link.died_at:
            return
        if not self.breakers[link.index].allow():
            return
        link.dead = False
        link.died_at = None
        self.stats["revivals"] += 1
        self.on_fleet_change()
        self.emit_event("route.revive", replica=link.name)

    def _fail_replica(self, index: int, reason: str) -> None:
        """Zero-loss failover: every in-flight request of the dead replica
        goes back to the front of the pending queue in its order, with its
        trace id and deadline. If the victim's answer for one of them still
        arrives, the first of answer and redispatch wins and the funnel
        drops the other."""
        link = self.links[index]
        if link.retired:
            return  # a drained retiree's EOF is not a failure
        link.dead = True
        link.died_at = time.monotonic()
        self.breakers[index].record_failure()
        victims = sorted(
            (rr for rr in self._inflight.values() if rr.replica == index),
            key=lambda rr: rr.order,
        )
        for rr in victims:
            del self._inflight[rr.order]
            rr.replica = None
            rr.refailed = True
            if self.disaggregate and rr.stage == "prefill":
                rr.blocks = None
        link.inflight = 0
        with self._intake_lock:
            self._pending.extendleft(reversed(victims))
        self.stats["failovers"] += 1
        if self._reg is not None:
            self._m_failover.inc()
        self.on_fleet_change()
        self.emit_event(
            "route.failover", replica=link.name, reason=reason,
            orders=[rr.order for rr in victims], traces=[rr.ctx.trace_id for rr in victims],
        )
        if self._sup is not None:
            self._sup.on_death(link)
        if self._upgrader is not None:
            self._upgrader.on_death(link)

    # -- dispatch ------------------------------------------------------------

    def _usable(self, stage: str) -> "list[ReplicaLink]":
        out = []
        for link in self.links:
            if link.dead or not link.serves(stage):
                continue
            if link.warming or link.draining or link.upgrading:
                continue
            if not self.breakers[link.index].allow():
                continue
            out.append(link)
        return out

    def _load(self, link: ReplicaLink) -> int:
        return link.inflight + link.hb_backlog

    def _pick(self, rr: _Tracked) -> "tuple[ReplicaLink, str] | None":
        stage = rr.stage if self.disaggregate else "decode"
        usable = self._usable(stage)
        if not usable and self.disaggregate and stage == "prefill":
            # No prefill worker left: a decode replica serves the whole
            # request (a full prefill), losing only the handoff.
            rr.stage = "decode"
            rr.blocks = None
            usable = self._usable("decode")
        elif not usable and self.disaggregate and stage == "decode":
            # No decode replica left: a live prefill worker runs the same
            # scheduler and serves the whole request.
            usable = self._usable("prefill")
        if not usable:
            return None
        if self._upgrader is not None:
            # The canary pin: during the canary window a deterministic
            # slice of orders goes to the first upgraded replica.
            forced = self._upgrader.route(rr, usable)
            if forced is not None:
                return forced, "canary"
        least = min(usable, key=lambda l: (self._load(l), l.index))
        if rr.affinity is None:
            return least, "least_loaded"
        affine = max(usable, key=lambda l: _rendezvous(rr.affinity, l.name))
        if self._load(affine) - self._load(least) > self.affinity_slack:
            return least, "least_loaded"
        return affine, "affinity"

    def _dispatch_pending(self) -> bool:
        progressed = False
        while True:
            with self._intake_lock:
                if not self._pending:
                    return progressed
                rr = self._pending.popleft()
            now = time.perf_counter()
            if rr.deadline is not None and now >= rr.deadline:
                self.stats["expired"] += 1
                self._answer(rr, error_answer(
                    "deadline",
                    "deadline_ms elapsed in the router queue after "
                    f"{round((now - rr.t_submit) * 1e3)}ms",
                ))
                progressed = True
                continue
            if rr.refailed and rr.redispatches >= self.max_redispatch:
                self.stats["exhausted"] += 1
                self._answer(rr, error_answer(
                    "transient",
                    f"request redispatched {self.max_redispatch} time(s) "
                    "after replica failures and still unanswered",
                ))
                progressed = True
                continue
            picked = self._pick(rr)
            if picked is None:
                if any(not l.dead for l in self.links):
                    # Breakers cooling or replicas warming: park the request
                    # at the front; the next pump retries.
                    with self._intake_lock:
                        self._pending.appendleft(rr)
                    return progressed
                self.stats["no_replica"] += 1
                self._answer(rr, error_answer(
                    "transient",
                    f"no live replica to serve the request (all {len(self.links)} failed)",
                ))
                progressed = True
                continue
            link, policy = picked
            fwd = dict(rr.req)
            fwd["traceparent"] = rr.ctx.to_traceparent()
            if rr.deadline is not None:
                fwd["deadline_ms"] = max(0.0, round((rr.deadline - now) * 1e3, 3))
            msg = {"type": "req", "rid": rr.order, "req": fwd}
            if self.disaggregate and rr.stage == "prefill":
                msg["type"] = "prefill"
            elif rr.blocks is not None:
                msg["blocks"] = rr.blocks
                msg["tokens"] = rr.blocks_tokens
            try:
                link.send(msg)
            except (OSError, ValueError):
                with self._intake_lock:
                    self._pending.appendleft(rr)
                self._fail_replica(link.index, "send failed")
                progressed = True
                continue
            # Only failover redispatches count against max_redispatch; the
            # prefill -> decode progression is normal flow.
            redispatch = rr.refailed
            rr.refailed = False
            rr.attempts += 1
            if redispatch:
                rr.redispatches += 1
            rr.replica = link.index
            if rr.t_dispatch is None:
                rr.t_dispatch = now
                self.queue_latencies.append(now - rr.t_submit)
            self._inflight[rr.order] = rr
            link.inflight += 1
            link.dispatched += 1
            self.stats["dispatched"] += 1
            if redispatch:
                self.stats["redispatched"] += 1
            progressed = True
            if self._reg is not None:
                self._m_dispatch.inc()
                if redispatch:
                    self._m_redispatch.inc()
                self._m_queue_s.observe(now - rr.t_submit)
            self.emit_event(
                "route.dispatch", order=rr.order, replica=link.name, policy=policy,
                stage=rr.stage if self.disaggregate else None,
                redispatch=rr.redispatches, weight_version=link.wv, trace=rr.ctx.trace_id,
            )

    # -- the answer funnel ---------------------------------------------------

    def _answer(self, rr: _Tracked, resp: dict, replica: str = "", slo=None) -> None:
        with self._intake_lock:
            self._done[rr.order] = resp
        self.stats["answered"] += 1
        if self._upgrader is not None:
            # The per-weight_version split the canary verdict reads.
            self._upgrader.observe(rr, resp, slo)
        if self._slo_engine is not None:
            # Replicas' answers carry their latency numbers in "slo";
            # router-local answers (queue deadline, redispatch exhaustion,
            # no replica) count for availability and deadlines only.
            sample = dict(slo) if isinstance(slo, dict) else {}
            sample["order"] = rr.order
            sample.setdefault("total_s", round(time.perf_counter() - rr.t_submit, 6))
            if "error" in resp:
                sample["error"] = resp["error"]
                if "code" in resp:
                    sample["code"] = resp["code"]
            self._slo_engine.record(sample)
        if rr.span_root is not None:
            extra = {}
            if "error" in resp:
                extra["error"] = resp["error"]
                if "code" in resp:
                    extra["code"] = resp["code"]
            rr.span_root.end(order=rr.order, replica=replica,
                             redispatches=rr.redispatches, **extra)
            rr.span_root = None
        if self._reg is not None:
            self._m_answers.inc()
