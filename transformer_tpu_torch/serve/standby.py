"""The warm-standby router: tail the primary's log, adopt its fleet when it dies.

Port of ``transformer_tpu/serve/standby.py`` (standard library only). The
router is the fleet's single point of failure until a :class:`Standby`
process tails the primary router's JSONL event log and rebuilds, from the
three kinds of event a primary writes in ``ha`` mode
(``serve/router.py``), all it needs to take over:

- ``route.intake``: one per accepted order, with the request, its W3C
  traceparent (the trace goes on across the cutover) and its remaining
  deadline budget; a pre-answered order (a bad line) carries its response.
- ``route.answered``: delivery marks from ``drain_ready``, the orders the
  client has seen. Completion is not delivery: an answer waiting out of
  order in the dead primary's funnel is recovered from the workers, while
  a delivered order must never reach the client twice.
- ``route.hb``: the primary's beacon, with its authority epoch and the
  workers' takeover ports (``serve/replica.py --ha``). The in-flight
  table is rebuilt from the two kinds above, which an adopting router
  journals again for its own successor (``Router.seed_takeover``), so
  chained takeovers work from each primary's log alone.

**Death** is silence: when no new ``route.hb`` has landed for
``takeover_after_s`` on the local monotonic clock (the file's growth, not
the events' timestamps, so the two hosts' clocks need not agree), the
standby declares the primary dead and adopts.

**The handshake**, per worker, over its localhost control socket::

    -> {"type": "takeover", "epoch": E+1, "inflight": [order, ...]}
    <- {"type": "adopted", "statuses": {...}, "messages": {...}}

A worker reports each undelivered order ``done`` (its answer replayed from
the worker's re-delivery cache), ``inflight`` (it answers on the standby's
channel) or ``unknown`` (the standby redispatches it). ``rejected`` means a
higher epoch owns the worker: another standby won, and this one stands
down (:class:`TakeoverRejected`). That is the split-brain guard: the epoch
orders authority, and the workers drop and count what the old primary
still sends. The ``route.takeover`` fault point fires inside each
handshake, so a ``--fault_spec`` can drill a partial adoption.

:meth:`Standby.adopt` returns a seeded
:class:`~transformer_tpu_torch.serve.router.Router` at epoch E+1 in ``ha``
mode (its own beacon on, for the next standby): delivered orders left out,
recovered answers in its funnel, claimed orders re-owned once, unknown
ones queued for dispatch. The delivery floor, the workers' epoch guard and
the funnel's duplicate drop keep every answer at most once across the
cutover.

Threads: the standby is single-threaded until it adopts (tail and poll);
then the router's contract holds (reader threads feed the inbox, one pump
thread owns the tables).
"""

from __future__ import annotations

import json
import socket
import threading
import time

from transformer_tpu_torch.obs.trace import SpanContext
from transformer_tpu_torch.serve.resilience import maybe_fail
from transformer_tpu_torch.serve.router import ReplicaLink, Router, _Tracked

# A worker's claims on an asked order, strongest first: a computed answer
# is replayed rather than re-owned, and an early peer's "unknown" (every
# worker reports every asked order) never hides the owner's claim.
_CLAIM_RANK = {"done": 2, "inflight": 1}


class TakeoverRejected(RuntimeError):
    """A worker answered the handshake with a higher epoch: another standby
    has adopted the fleet, and this one must not serve."""


class TakeoverLink(ReplicaLink):
    """A replica link over the worker's ``--ha`` control socket, the
    adopting router's transport. ``alive()`` is the socket's health: the
    worker outlives its primary by design, so there is no process of ours
    to poll."""

    def __init__(self, index: int, name: str, sock, rfile, wfile, role: str = "both"):
        super().__init__(index, name, role=role)
        self._sock = sock
        self._rf = rfile
        self._wf = wfile
        self._broken = False
        self._reader: threading.Thread | None = None

    def send(self, msg: dict) -> None:
        self.send_line(json.dumps(msg))

    def send_line(self, line: str) -> None:
        if self._broken:
            raise BrokenPipeError(f"replica {self.name} control socket gone")
        try:
            self._wf.write(line + "\n")
            self._wf.flush()
        except (OSError, ValueError) as e:
            self._broken = True
            raise BrokenPipeError(str(e)) from e

    def alive(self) -> bool:
        return not self._broken

    def start_reader(self, inbox) -> None:
        self._reader = threading.Thread(target=self._read_loop, args=(inbox,),
                                        name=f"standby-read-{self.name}", daemon=True)
        self._reader.start()

    def _read_loop(self, inbox) -> None:
        try:
            for line in self._rf:
                line = line.strip()
                if not line:
                    continue
                try:
                    msg = json.loads(line)
                except ValueError:
                    continue
                if isinstance(msg, dict):
                    inbox.put((self.index, msg))
        except (OSError, ValueError):
            pass
        self._broken = True
        inbox.put((self.index, {"type": "exit"}))

    def kill(self) -> None:
        self._broken = True
        try:
            self._sock.close()
        except OSError:
            pass

    def close(self, timeout: float = 10.0) -> None:
        """Ask the worker to drain and exit; its final ``stats`` reach the
        inbox before the socket closes (the worker's exit ends the
        reader)."""
        try:
            self.send({"type": "shutdown"})
        except (OSError, ValueError):
            pass
        if self._reader is not None:
            self._reader.join(timeout=timeout)
        try:
            self._sock.close()
        except OSError:
            pass


class Standby:
    """Tail the primary's event log; adopt its fleet when it goes silent.

    ``router_kwargs`` go to the adopted :class:`Router` (supervisor,
    scaler, SLOs, dispatch settings): the standby becomes a primary like
    any other. ``clock`` is injectable so that tests drive the death
    detector.
    """

    def __init__(
        self,
        log_path: str,
        *,
        takeover_after_s: float = 2.0,
        connect_timeout_s: float = 5.0,
        encode=None,
        bos_id: int = 1,
        telemetry=None,
        clock=time.monotonic,
        router_kwargs: "dict | None" = None,
    ):
        self.log_path = log_path
        self.takeover_after_s = takeover_after_s
        self.connect_timeout_s = connect_timeout_s
        self.encode = encode
        self.bos_id = bos_id
        self._tel = telemetry
        self._clock = clock
        self._router_kwargs = dict(router_kwargs or {})
        self._offset = 0
        self._partial = ""
        # The primary's state, rebuilt from the tail.
        self.epoch = 1
        self.ports: "dict[str, int]" = {}
        self.intake: "dict[int, dict]" = {}
        self.max_order = -1      # the highest order seen: intake is pruned at
        #                          delivery, the order clock resumes past all
        self.delivered_upto = 0  # the client has seen orders [0, upto)
        self._last_hb_local: "float | None" = None
        self.stats = {
            "hb_seen": 0, "intake_seen": 0, "recovered_answers": 0,
            "reowned_inflight": 0, "redispatched": 0, "skipped_replicas": 0,
        }
        self._m_state = None
        registry = getattr(telemetry, "registry", None)
        if registry is not None:
            self._m_state = registry.gauge(
                "route_standby_state", "0 = tailing the primary, 1 = adopting, 2 = primary")
            self._m_state.set(0)

    # -- the tail ------------------------------------------------------------

    def _read_new_events(self) -> "list[dict]":
        try:
            with open(self.log_path) as f:
                f.seek(self._offset)
                chunk = f.read()
                self._offset = f.tell()
        except OSError:
            return []
        if not chunk:
            return []
        lines = (self._partial + chunk).split("\n")
        # The last piece is "" (the chunk ended on a newline) or a line torn
        # mid-write: kept for the next read either way.
        self._partial = lines.pop()
        out = []
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                continue
            if isinstance(ev, dict):
                out.append(ev)
        return out

    def _ingest(self, ev: dict) -> None:
        kind = ev.get("kind")
        if kind == "route.hb":
            self.stats["hb_seen"] += 1
            self._last_hb_local = self._clock()
            self.epoch = max(self.epoch, int(ev.get("epoch", 1)))
            ports = ev.get("ports")
            if isinstance(ports, dict):
                self.ports = {str(k): int(v) for k, v in ports.items() if isinstance(v, int)}
        elif kind == "route.intake":
            order = ev.get("order")
            if isinstance(order, int):
                self.stats["intake_seen"] += 1
                self.max_order = max(self.max_order, order)
                if order >= self.delivered_upto:
                    self.intake[order] = ev
        elif kind == "route.answered":
            upto = ev.get("upto")
            if isinstance(upto, int):
                self.delivered_upto = max(self.delivered_upto, upto + 1)
                # A delivered order is never re-owned or answered again: its
                # record goes, so the standby's memory is bounded by the
                # in-flight window, not by every request ever accepted.
                for order in [o for o in self.intake if o < self.delivered_upto]:
                    del self.intake[order]

    def poll(self) -> float:
        """Take in the log's new lines; returns the seconds of beacon
        silence (0.0 on the first poll, which starts the clock)."""
        for ev in self._read_new_events():
            self._ingest(ev)
        now = self._clock()
        if self._last_hb_local is None:
            # The silence clock starts at the first look: a standby pointed
            # at the log of a primary already dead must still time out.
            self._last_hb_local = now
            return 0.0
        return now - self._last_hb_local

    @property
    def primary_dead(self) -> bool:
        return (self._last_hb_local is not None
                and self._clock() - self._last_hb_local > self.takeover_after_s)

    def run_until_takeover(self, poll_s: float = 0.1, timeout: "float | None" = None,
                           sleep=time.sleep) -> Router:
        """Tail until the primary goes silent, then :meth:`adopt`;
        ``timeout`` bounds the wait (None: forever)."""
        t0 = self._clock()
        self.poll()
        while not self.primary_dead:
            if timeout is not None and self._clock() - t0 > timeout:
                raise TimeoutError(f"primary still alive after {timeout}s of standby")
            sleep(poll_s)
            self.poll()
        return self.adopt()

    # -- the takeover --------------------------------------------------------

    def _handshake(self, index: int, name: str, port: int,
                   ask: "list[int]") -> "tuple[TakeoverLink, dict, dict]":
        maybe_fail("route.takeover")
        sock = socket.create_connection(("127.0.0.1", port), timeout=self.connect_timeout_s)
        wf = sock.makefile("w", encoding="utf-8", buffering=1)
        rf = sock.makefile("r", encoding="utf-8")
        wf.write(json.dumps({"type": "takeover", "epoch": self.epoch + 1, "inflight": ask})
                 + "\n")
        wf.flush()
        line = rf.readline()
        if not line:
            sock.close()
            raise OSError(f"replica {name} closed the control socket")
        reply = json.loads(line)
        if reply.get("type") == "rejected":
            sock.close()
            raise TakeoverRejected(
                f"replica {name} is owned by epoch {reply.get('epoch')} >= {self.epoch + 1}: "
                "another standby adopted the fleet")
        if reply.get("type") != "adopted":
            sock.close()
            raise OSError(f"replica {name} answered {reply.get('type')!r}")
        sock.settimeout(None)
        link = TakeoverLink(index, name, sock, rf, wf, role=str(reply.get("role", "both")))
        # The adopting router's beacon must name the ports (the workers
        # announce them once, at start), so that a second standby adopts
        # from this one's journal.
        link.control_port = port
        return link, reply.get("statuses") or {}, reply.get("messages") or {}

    def _rebuild_tracked(self, order: int, now: float) -> _Tracked:
        ev = self.intake.get(order) or {}
        req = ev.get("req")
        if not isinstance(req, dict):
            req = {"prompt": ""}
        ctx = SpanContext.from_traceparent(ev.get("traceparent")) or SpanContext.new()
        deadline = None
        d, ts = ev.get("deadline_ms"), ev.get("ts")
        if isinstance(d, (int, float)) and isinstance(ts, (int, float)):
            # The budget left, against the wall time since the record was
            # written: an order whose budget died with the primary answers a
            # deadline error, not a late success.
            deadline = now + (ts + d / 1e3) - time.time()
        return _Tracked(order=order, req=req, ctx=ctx, t_submit=now, deadline=deadline,
                        affinity=None)

    def _set_state(self, value: int) -> None:
        if self._m_state is not None:
            self._m_state.set(value)

    def adopt(self) -> Router:
        """Take over: handshake each known worker, re-own the in-flight
        table once, and return the seeded router (epoch + 1, ``ha`` on: the
        next standby tails it)."""
        self._set_state(1)
        now = time.perf_counter()
        done: "dict[int, dict]" = {}
        ask: "list[int]" = []
        for order in sorted(o for o in self.intake if o >= self.delivered_upto):
            resp = self.intake[order].get("resp")
            if isinstance(resp, dict):
                done[order] = resp  # answered at the primary: the log has it
            else:
                ask.append(order)
        links: "list[TakeoverLink]" = []
        claims: "dict[int, tuple[str, int]]" = {}
        messages: "dict[int, dict]" = {}
        failed: "list[str]" = []
        for name in sorted(self.ports):
            index = len(links)
            try:
                link, statuses, msgs = self._handshake(index, name, self.ports[name], ask)
            except TakeoverRejected:
                raise
            except (OSError, ValueError):
                # A route.takeover fault, a dead worker, a torn reply: a
                # partial adoption. What that worker held surfaces as
                # "unknown" and is redispatched.
                self.stats["skipped_replicas"] += 1
                failed.append(name)
                continue
            links.append(link)
            for rid_s, status in statuses.items():
                try:
                    rid = int(rid_s)
                except (TypeError, ValueError):
                    continue
                cur = claims.get(rid)
                if cur is None or _CLAIM_RANK.get(status, 0) > _CLAIM_RANK.get(cur[0], 0):
                    claims[rid] = (status, index)
                if status == "done" and isinstance(msgs.get(rid_s), dict):
                    messages[rid] = msgs[rid_s]
        if not links:
            self._set_state(0)
            raise RuntimeError(
                f"takeover adopted zero replicas (ports={self.ports}, failed={failed})")
        inflight: "list[tuple[int, _Tracked]]" = []
        pending: "list[_Tracked]" = []
        for order in ask:
            status, index = claims.get(order, ("unknown", -1))
            msg = messages.get(order)
            if status == "done" and isinstance(msg, dict) and isinstance(msg.get("resp"), dict):
                # Recovered: the answer died in the primary's pipe but lives
                # in the worker's re-delivery cache.
                done[order] = msg["resp"]
                self.stats["recovered_answers"] += 1
            elif status == "inflight":
                inflight.append((index, self._rebuild_tracked(order, now)))
                self.stats["reowned_inflight"] += 1
            else:
                # Unknown everywhere (or a replay that is no answer, such as a
                # prefill handoff that died with the primary): redispatched
                # from the intake record.
                pending.append(self._rebuild_tracked(order, now))
                self.stats["redispatched"] += 1
        router = Router(links, encode=self.encode, bos_id=self.bos_id, telemetry=self._tel,
                        ha=True, epoch=self.epoch + 1, **self._router_kwargs)
        router.seed_takeover(
            next_order=max(self.max_order + 1, self.delivered_upto),
            emit_next=self.delivered_upto, done=done, inflight=inflight, pending=pending,
        )
        for link in links:
            link.start_reader(router.inbox)
        self._set_state(2)
        if self._tel is not None:
            self._tel.emit(
                "route.takeover", epoch=self.epoch + 1, adopted=[l.name for l in links],
                failed=failed, recovered_answers=self.stats["recovered_answers"],
                reowned_inflight=self.stats["reowned_inflight"],
                redispatched=self.stats["redispatched"], delivered_upto=self.delivered_upto,
            )
        return router
