"""Fleet supervision: replica respawn, warm-up, and SLO-driven scaling.

Port of ``transformer_tpu/serve/supervisor.py``. Two objects, both owned by
the router thread:

- :class:`Supervisor`: replica lifecycle. When the router fails a replica
  over, the supervisor re-bootstraps a replacement from the same spawn
  recipe under the replica's old name (rendezvous hashing hands it the
  affinity keys it owned), at the fleet's target weights when a rollout
  set them (``Router.weight_target``). Before the replacement takes
  traffic, its ``PrefixCache`` is warmed from a survivor over the
  ``export_blocks`` / ``inject_blocks`` wire format (``export_state`` /
  ``inject_state``). Respawns are budgeted (``max_restarts`` within
  ``restart_window_s``, exponential backoff between attempts): a
  crash-looping bootstrap spends its budget and leaves the replica's
  breaker open, the fleet serving at N-1, with a ``route.spawn`` event
  carrying ``gave_up=true``. ``route.spawn`` (the fault plane) fires
  inside every attempt. Before a slot is recycled the victim's last
  flight record, shipped over the wire (a ``dump`` reply) or salvaged from
  its ``<metrics_jsonl>.flight.json`` autodump, becomes a
  ``route.postmortem`` event.
- :class:`FleetScaler`: fleet size from the burn rates of the router's
  :class:`~transformer_tpu_torch.obs.slo.SLOEngine`: the watched signal
  (default ``ttft_p95``) burning above 1 for ``sustain_s`` spawns a
  replica (up to ``max_replicas``); a fleet idle for ``idle_s`` drains
  its youngest replica (down to ``min_replicas``). Every decision is a
  ``route.scale`` event with the burn windows that justified it.

Every method runs on the router thread (``Router.pump`` calls
:meth:`Supervisor.poll` and :meth:`FleetScaler.poll`; the message
handlers come from the router's inbox). Nothing here takes a lock or
touches the card.
"""

from __future__ import annotations

import inspect
import time

from transformer_tpu_torch.serve.resilience import maybe_fail
from transformer_tpu_torch.serve.router import inject_state_line


class _SlotState:
    """Respawn bookkeeping of one replica index (router thread)."""

    __slots__ = (
        "index", "name", "role", "phase", "next_try", "attempts",
        "restarts", "died_at", "warm_deadline", "warm_source", "postmortem_ts",
    )

    def __init__(self, index: int, name: str, role: str):
        self.index = index
        self.name = name
        self.role = role
        self.phase = "up"  # up | waiting | booting | warming | gave_up | retired
        self.next_try = 0.0
        self.attempts = 0          # consecutive failed respawns
        self.restarts: list[float] = []  # attempt times (the budget window)
        self.died_at: float | None = None
        self.warm_deadline = 0.0
        self.warm_source: int | None = None
        self.postmortem_ts: float | None = None  # the last captured record's ts


class Supervisor:
    """Respawn dead replicas, warm them from survivors, admit them back.

    ``spawn(index, name, role[, weight_target]) -> ReplicaLink`` is the
    re-bootstrap recipe (``cli/router.py`` builds it over
    ``ReplicaProcess.spawn``; tests pass fakes). A recipe with a fourth
    parameter receives the router's ``weight_target``. A spawn that raises,
    or a replacement that dies before admission, counts against the
    restart budget."""

    def __init__(
        self,
        spawn,
        *,
        max_restarts: int = 3,
        restart_window_s: float = 120.0,
        backoff_ms: float = 200.0,
        backoff_max_ms: float = 10_000.0,
        boot_timeout_s: float = 60.0,
        warm_prefixes: int = 8,
        warm_timeout_s: float = 10.0,
        clock=time.monotonic,
    ):
        self._spawn = spawn
        try:
            self._spawn_takes_target = len(inspect.signature(spawn).parameters) >= 4
        except (TypeError, ValueError):
            self._spawn_takes_target = False
        self.max_restarts = max(1, max_restarts)
        self.restart_window_s = restart_window_s
        self.backoff_ms = backoff_ms
        self.backoff_max_ms = backoff_max_ms
        self.boot_timeout_s = boot_timeout_s
        self.warm_prefixes = warm_prefixes
        self.warm_timeout_s = warm_timeout_s
        self._clock = clock
        self._router = None
        self._slots: dict[int, _SlotState] = {}
        self.stats = {
            "respawns": 0, "spawn_attempts": 0, "spawn_failures": 0,
            "gave_up": 0, "warmed_tokens": 0, "scale_ups": 0, "retired": 0,
            "postmortems": 0,
        }
        self.heal_times: list[float] = []  # death -> admitted, seconds

    # -- wiring (router thread) ---------------------------------------------

    def attach(self, router) -> None:
        self._router = router
        for link in router.links:
            self._slots[link.index] = _SlotState(link.index, link.name, link.role)

    def _slot(self, index: int) -> _SlotState:
        if index not in self._slots:
            link = self._router.links[index]
            self._slots[index] = _SlotState(index, link.name, link.role)
        return self._slots[index]

    # -- lifecycle events (router thread) -----------------------------------

    def on_death(self, link) -> None:
        """A replica the router just failed over: schedule its respawn,
        after the breaker's cooldown when the process still runs (the
        half-open revival gets the first claim on a stalled worker), after
        the backoff otherwise."""
        if getattr(link, "retired", False):
            return
        slot = self._slot(link.index)
        if slot.phase == "gave_up":
            return  # the budget is spent
        self._capture_postmortem(slot, link)
        now = self._clock()
        if slot.phase == "up":
            slot.died_at = now
        was_booting = slot.phase in ("booting", "warming")
        slot.phase = "waiting"
        if was_booting:
            # The replacement died before admission: a crash loop.
            self._count_failure(slot, now)
            if slot.phase == "gave_up":
                return
        delay = self._backoff_s(slot.attempts)
        if link.alive():
            delay = max(delay, self._router.breakers[link.index].cooldown_s)
        slot.next_try = now + delay

    def _fleet_changed(self) -> None:
        """The router's fleet-size gauges follow an admission or a retire."""
        hook = getattr(self._router, "on_fleet_change", None)
        if hook is not None:
            hook()

    def _capture_postmortem(self, slot: _SlotState, link) -> None:
        """The victim's final flight record (``obs/flight.py``) as a
        ``route.postmortem`` event, once per record: the record it shipped
        over the wire (a ``dump`` reply) when there is one, else the
        on-disk autodump next to its ``--metrics_jsonl``, the only trace a
        SIGKILL leaves. Best-effort: no recorder, no file or a torn dump
        captures nothing and never delays the respawn."""
        record = getattr(link, "flight_record", None)
        origin = "wire"
        if record is None:
            jsonl = getattr(link, "metrics_jsonl", None)
            if jsonl:
                from transformer_tpu_torch.obs.flight import flight_path_for, load_flight_record

                record = load_flight_record(flight_path_for(jsonl))
                origin = "file"
        if record is None:
            return
        ts = record.get("ts")
        if ts is not None and ts == slot.postmortem_ts:
            return  # this incident's record was captured already
        slot.postmortem_ts = ts
        self.stats["postmortems"] += 1
        self._router.emit_event(
            "route.postmortem", replica=slot.name, origin=origin,
            reason=record.get("reason"), record=record,
        )

    def _bootstrap(self, index: int, name: str, role: str):
        """One (re)spawn through the recipe, at the fleet's target weights
        when a rollout set them."""
        if self._spawn_takes_target:
            return self._spawn(index, name, role, getattr(self._router, "weight_target", None))
        return self._spawn(index, name, role)

    def _backoff_s(self, attempts: int) -> float:
        return min(self.backoff_ms * (2 ** attempts), self.backoff_max_ms) / 1e3

    def _count_failure(self, slot: _SlotState, now: float) -> None:
        slot.attempts += 1
        slot.restarts.append(now)
        self.stats["spawn_failures"] += 1
        self._router.breakers[slot.index].record_failure()
        window = [t for t in slot.restarts if now - t <= self.restart_window_s]
        slot.restarts = window
        if len(window) >= self.max_restarts:
            # A crash loop: stop. The breaker stays open and the fleet
            # serves at N-1.
            slot.phase = "gave_up"
            self.stats["gave_up"] += 1
            self._router.emit_event(
                "route.spawn", replica=slot.name, gave_up=True, attempts=len(window),
                window_s=self.restart_window_s,
            )

    # -- the poll loop (router thread, from Router.pump) --------------------

    def poll(self) -> bool:
        """Advance every slot's respawn and warm-up one turn; returns
        whether anything progressed."""
        if self._router is None:
            return False
        progressed = False
        now = self._clock()
        for slot in list(self._slots.values()):
            link = self._router.links[slot.index]
            if slot.phase == "waiting" and now >= slot.next_try:
                if not link.dead:
                    # The half-open revival won while we backed off.
                    slot.phase = "up"
                    slot.attempts = 0
                    continue
                progressed |= self._try_spawn(slot, now)
            elif slot.phase == "booting" and now >= slot.warm_deadline:
                # No ready within the boot timeout: a failed attempt (the
                # straggler is killed so the next spawn owns the name).
                link.kill()
                self._count_failure(slot, now)
                if slot.phase != "gave_up":
                    slot.phase = "waiting"
                    slot.next_try = now + self._backoff_s(slot.attempts)
                progressed = True
            elif slot.phase == "warming" and now >= slot.warm_deadline:
                # Warm-up is best-effort: a slow survivor does not keep a
                # healthy replacement out.
                self._admit(link, warmed_tokens=0, timed_out=True)
                progressed = True
        return progressed

    def _try_spawn(self, slot: _SlotState, now: float) -> bool:
        link = self._router.links[slot.index]
        if link.alive():
            link.kill()  # stalled past its cooldown and never revived
        self.stats["spawn_attempts"] += 1
        try:
            maybe_fail("route.spawn")
            new_link = self._bootstrap(slot.index, slot.name, slot.role)
        except Exception:  # noqa: BLE001 — every spawn failure is one budgeted attempt, never a router crash
            self._count_failure(slot, now)
            if slot.phase != "gave_up":
                slot.next_try = now + self._backoff_s(slot.attempts)
            return True
        new_link.warming = True
        self._router.replace_link(slot.index, new_link)
        slot.phase = "booting"
        slot.warm_deadline = now + self.boot_timeout_s
        return True

    def on_ready(self, link) -> None:
        """The replacement is up: warm its PrefixCache from the healthy
        survivor with the least in flight, then admit it (cold at once when
        there is no survivor)."""
        slot = self._slot(link.index)
        if slot.phase != "booting":
            return
        survivor = self._pick_survivor(link.index)
        if survivor is None:
            self._admit(link, warmed_tokens=0)
            return
        try:
            survivor.send({"type": "export_state", "limit": self.warm_prefixes})
        except (OSError, ValueError):
            self._admit(link, warmed_tokens=0)
            return
        slot.phase = "warming"
        slot.warm_source = survivor.index
        slot.warm_deadline = self._clock() + self.warm_timeout_s

    def _pick_survivor(self, exclude: int):
        best = None
        for link in self._router.healthy_links:
            if link.index == exclude:
                continue
            if best is None or link.inflight < best.inflight:
                best = link
        return best

    def on_prefix_state(self, from_link, msg: dict) -> None:
        """A survivor answered ``export_state``: forward its payload to the
        replacement warming from it."""
        for slot in self._slots.values():
            if slot.phase != "warming" or slot.warm_source != from_link.index:
                continue
            newbie = self._router.links[slot.index]
            # The reply is the worker's line, unparsed (``serve/router.py``
            # ``PREFIX_STATE_HEAD``). An empty export goes on too: the
            # replacement answers ``state_injected`` with 0 tokens.
            try:
                newbie.send_line(inject_state_line(msg["line"]))
            except (OSError, ValueError):
                pass  # the replacement died mid-warm: the liveness sweep sees it
            return

    def on_state_injected(self, link, msg: dict) -> None:
        slot = self._slot(link.index)
        if slot.phase != "warming":
            return
        self._admit(link, warmed_tokens=int(msg.get("tokens", 0)))

    def _admit(self, link, warmed_tokens: int, timed_out: bool = False) -> None:
        """The replacement joins the fleet under its old name."""
        slot = self._slot(link.index)
        scale_up = slot.died_at is None  # a FleetScaler spawn, not a heal
        heal_s = None
        if slot.died_at is not None:
            heal_s = self._clock() - slot.died_at
            self.heal_times.append(heal_s)
        slot.phase = "up"
        slot.attempts = 0
        slot.died_at = None
        link.warming = False
        self._fleet_changed()
        link.dead = False
        link.died_at = None
        # The dead process's breaker dies with it: the replacement starts
        # closed.
        self._router.reset_breaker(link.index)
        self.stats["respawns"] += 0 if scale_up else 1
        self.stats["warmed_tokens"] += warmed_tokens
        self._router.emit_event(
            "route.spawn", replica=slot.name, scale_up=scale_up,
            heal_s=None if heal_s is None else round(heal_s, 6),
            warmed_tokens=warmed_tokens, warm_timed_out=timed_out or None,
        )

    # -- fleet sizing (FleetScaler / operator surface) ----------------------

    def spawn_new(self, role: str = "both") -> bool:
        """Grow the fleet by one replica under a fresh name; it warms like
        a respawn."""
        index = len(self._router.links)
        name = f"replica{index}"
        self.stats["spawn_attempts"] += 1
        try:
            maybe_fail("route.spawn")
            link = self._bootstrap(index, name, role)
        except Exception:  # noqa: BLE001 — a failed scale-up is a skipped decision
            self.stats["spawn_failures"] += 1
            return False
        link.warming = True
        self._router.append_link(link)
        slot = _SlotState(index, name, role)
        slot.phase = "booting"
        slot.warm_deadline = self._clock() + self.boot_timeout_s
        self._slots[index] = slot
        self.stats["scale_ups"] += 1
        return True

    def retire(self, link) -> None:
        """Begin draining ``link``: no new traffic; :meth:`reap_draining`
        ships its shutdown once its in-flight work is answered."""
        link.draining = True

    def reap_draining(self) -> bool:
        progressed = False
        for link in self._router.links:
            if not getattr(link, "draining", False) or link.dead:
                continue
            if link.inflight > 0:
                continue
            try:
                link.send({"type": "shutdown"})
            except (OSError, ValueError):
                pass
            link.draining = False
            link.dead = True
            link.retired = True
            self._fleet_changed()
            self._slot(link.index).phase = "retired"
            self.stats["retired"] += 1
            self._router.emit_event("route.retire", replica=link.name)
            progressed = True
        return progressed


class FleetScaler:
    """Fleet size from SLO burn: ``signal`` burning above 1 for
    ``sustain_s`` spawns a replica through the supervisor (up to
    ``max_replicas``); a fleet idle for ``idle_s`` (no backlog, nothing in
    flight, burn 0) retires its youngest replica (down to
    ``min_replicas``). ``cooldown_s`` separates two decisions. Each
    decision emits ``route.scale`` with the burn windows behind it."""

    def __init__(
        self,
        *,
        signal: str = "ttft_p95",
        sustain_s: float = 5.0,
        idle_s: float = 30.0,
        max_replicas: int = 4,
        min_replicas: int = 1,
        cooldown_s: float = 15.0,
        clock=time.monotonic,
    ):
        self.signal = signal
        self.sustain_s = sustain_s
        self.idle_s = idle_s
        self.max_replicas = max(1, max_replicas)
        self.min_replicas = max(1, min_replicas)
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._router = None
        self._sup = None
        self._burn_since: float | None = None
        self._idle_since: float | None = None
        self._last_action = 0.0
        self._last_eval: dict = {}
        self.stats = {"scale_up": 0, "scale_down": 0, "skipped_at_max": 0}

    def bind(self, router, supervisor: Supervisor) -> None:
        self._router = router
        self._sup = supervisor

    def poll(self, slo_result: "dict | None") -> bool:
        """One scaling turn, after an SLO evaluation (``slo_result`` is
        ``SLOEngine.evaluate()``'s payload, or None when none ran)."""
        if self._router is None or self._sup is None:
            return False
        now = self._clock()
        if slo_result is not None:
            self._last_eval = slo_result
        sig = self._last_eval.get(self.signal)
        burn = sig["burn_rate"] if sig else 0.0
        healthy = len(self._router.healthy_links)
        # ---- scale up: sustained burn > 1 on the watched signal ----------
        if burn > 1.0:
            self._idle_since = None
            if self._burn_since is None:
                self._burn_since = now
            sustained = now - self._burn_since
            if sustained >= self.sustain_s and now - self._last_action >= self.cooldown_s:
                if healthy >= self.max_replicas:
                    self.stats["skipped_at_max"] += 1
                    self._last_action = now
                    return False
                if self._sup.spawn_new():
                    self._last_action = now
                    self.stats["scale_up"] += 1
                    self._router.emit_event(
                        "route.scale", direction="up", signal=self.signal,
                        burn_rate=burn, sustained_s=round(sustained, 3),
                        fleet_size=healthy + 1,
                        evidence=sig.get("windows") if sig else None,
                    )
                    return True
                # A failed spawn re-arms the cooldown too: one attempt per
                # cooldown, not one per pump.
                self._last_action = now
            return False
        self._burn_since = None
        # ---- scale down: sustained idleness ------------------------------
        idle = (
            self._router.backlog == 0
            and all(l.inflight == 0 for l in self._router.links)
            and burn == 0.0
        )
        if not idle:
            self._idle_since = None
            return False
        if self._idle_since is None:
            self._idle_since = now
            return False
        sustained = now - self._idle_since
        if (
            sustained >= self.idle_s
            and now - self._last_action >= self.cooldown_s
            and healthy > self.min_replicas
        ):
            victim = None
            for link in self._router.healthy_links:  # the youngest
                if victim is None or link.index > victim.index:
                    victim = link
            if victim is None:
                return False
            self._sup.retire(victim)
            self._last_action = now
            self._idle_since = None
            self.stats["scale_down"] += 1
            self._router.emit_event(
                "route.scale", direction="down", signal=self.signal,
                burn_rate=burn, sustained_idle_s=round(sustained, 3),
                replica=victim.name, fleet_size=healthy - 1,
                evidence=sig.get("windows") if sig else None,
            )
            return True
        return False
