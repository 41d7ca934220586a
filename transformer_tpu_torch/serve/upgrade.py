"""Live weights: rolling checkpoint swaps across the fleet, with no restart.

Port of ``transformer_tpu/serve/upgrade.py``:

- **Integrity at the door**: :func:`verify_checkpoint` checks the target
  checkpoint's per-array crc32 manifest (``train/checkpoint.py``) before
  any replica is touched; a torn, bit-rotted or mixed checkpoint is
  refused fleet-wide with a structured ``upgrade`` error. The manifest
  digest is the rollout's ``weight_version`` tag. Each replica verifies
  again and matches the arrays against its running tree (flat names,
  shapes, stored dtypes) before anything is staged
  (:func:`load_checkpoint_params`, numpy only).
- **Rolling swap** (:class:`UpgradeCoordinator`, owned by the router
  thread): one replica at a time is quiesced through the dispatch policy
  (``link.upgrading``: no new dispatches; requests in flight finish on
  their admission-time weights), told to stage the verified params (the
  scheduler's two-version slot flips in place at a drained step
  boundary, its CUDA graphs untouched), then re-admitted.
- **Canary**: the first upgraded replica is the canary. The router pins
  every ``canary_every``-th accepted order to it, and an
  :class:`~transformer_tpu_torch.obs.slo.SLOEngine` per weight version
  judges its burn (availability and ttft_p95 over short windows). Burn
  above 1 on every window rolls the canary back (the old weights are
  the resident second buffer, so the rollback re-stages them); a clean
  window promotes the rollout to the rest of the fleet.
- **Respawn at the target**: a rollout sets ``Router.weight_target``, and
  the supervisor's spawn recipe passes ``--init_ckpt`` /
  ``--weight_version``, so a replica that dies mid- or post-rollout comes
  back at the version the fleet is converging to. A rollback clears it.

Fault plane: ``route.upgrade`` fires in the coordinator's per-replica swap
dispatch (the rollout aborts and upgraded replicas roll back),
``route.canary`` marks canary answers bad (a burn rollback on demand),
and ``ckpt.swap`` fires in the scheduler's flip (the flip aborts with the
old weights serving).

Every method of the coordinator runs on the router thread (``Router.pump``
drives :meth:`UpgradeCoordinator.poll`; ``observe`` / ``on_msg`` /
``on_death`` come from the router's inbox and answer funnel).
"""

from __future__ import annotations

import os
import re
import time

import numpy as np

from transformer_tpu_torch.obs.slo import SLOEngine, SLOSpec, parse_slo_spec
from transformer_tpu_torch.serve.resilience import fired, maybe_fail


class UpgradeError(RuntimeError):
    """A checkpoint failed verification or structure matching: the rollout
    (or the replica's load) refuses it before any swap is scheduled."""


def resolve_checkpoint_dir(path: str) -> str:
    """Accept either one checkpoint directory (holding ``arrays.npz``) or
    a CheckpointManager directory (the newest ``ckpt_*`` step)."""
    if os.path.exists(os.path.join(path, "arrays.npz")):
        return path
    if os.path.isdir(path):
        steps = sorted(name for name in os.listdir(path) if re.fullmatch(r"ckpt_\d{8}", name))
        if steps:
            return os.path.join(path, steps[-1])
    raise UpgradeError(f"no checkpoint at {path!r}: expected arrays.npz or ckpt_* steps")


def verify_checkpoint(path: str) -> tuple[str, str]:
    """The fleet-wide admission check of an upgrade target: resolve the
    checkpoint directory and verify its bytes against its manifest.
    Returns ``(ckpt_dir, weight_version digest)``; raises
    :class:`UpgradeError` on any integrity failure (a torn manifest, a crc
    mismatch, no manifest: an unmanifested checkpoint cannot prove that N
    replicas load the same bytes)."""
    from transformer_tpu_torch.train.checkpoint import verify_manifest

    ckpt_dir = resolve_checkpoint_dir(path)
    try:
        return ckpt_dir, verify_manifest(ckpt_dir)
    except Exception as e:  # noqa: BLE001 — every failure shape becomes one structured refusal
        raise UpgradeError(
            f"checkpoint at {ckpt_dir} failed integrity verification: "
            f"{type(e).__name__}: {e}"
        ) from e


def load_checkpoint_params(path: str, template) -> tuple[object, str]:
    """The replica's verified load: verify the checkpoint's bytes, then
    match its arrays against the running tree ``template`` (nested dicts
    and lists of tensors or arrays, in the stored form): the same flat
    names, and per leaf the same shape and dtype. Returns ``(params,
    digest)``, the params as numpy arrays in ``template``'s structure;
    raises :class:`UpgradeError` on any mismatch, before anything is
    staged."""
    from transformer_tpu_torch.models.transformer import flatten, unflatten
    from transformer_tpu_torch.serve.scheduler import dtype_name as tensor_dtype
    from transformer_tpu_torch.train.checkpoint import dtype_name, verify_manifest

    ckpt_dir = resolve_checkpoint_dir(path)
    with np.load(os.path.join(ckpt_dir, "arrays.npz")) as data:
        flat = {k: data[k] for k in data.files}
    try:
        version = verify_manifest(ckpt_dir, flat)
    except Exception as e:  # noqa: BLE001 — the same refusal as verify_checkpoint's
        raise UpgradeError(
            f"checkpoint at {ckpt_dir} failed integrity verification: "
            f"{type(e).__name__}: {e}"
        ) from e
    running = flatten(template)
    problems = []
    for key, leaf in running.items():
        if key not in flat:
            problems.append(f"missing {key!r}")
            continue
        arr = flat[key]
        shape = tuple(leaf.shape)
        dtype = tensor_dtype(leaf.dtype) if hasattr(leaf, "numpy") else dtype_name(leaf)
        if arr.shape != shape or dtype_name(arr) != dtype:
            problems.append(
                f"{key}: checkpoint {arr.shape}/{dtype_name(arr)} != running {shape}/{dtype}"
            )
    extra = sorted(set(flat) - set(running))
    if extra:
        problems.append(f"{len(extra)} extra array(s), e.g. {extra[0]!r}")
    if problems:
        raise UpgradeError(
            f"checkpoint {version} at {ckpt_dir} does not match the running "
            f"model spec ({'; '.join(problems[:3])}) — swap refused"
        )
    return unflatten({key: flat[key] for key in running}), version


def _default_canary_slos() -> tuple[SLOSpec, ...]:
    """Short-window availability and TTFT objectives for the canary
    verdict (a canary window is seconds, not hours)."""
    return (
        SLOSpec("availability", "availability", 0.99, windows=(5.0, 30.0)),
        SLOSpec("ttft_p95", "ttft_p95", 0.95, threshold_s=2.0, windows=(5.0, 30.0)),
    )


class UpgradeCoordinator:
    """The router thread's rollout state machine (see the module
    docstring).

    ``verify`` maps an upgrade path to ``(ckpt_dir, weight_version)``
    (default :func:`verify_checkpoint`; tests inject their own).
    ``canary_slos`` is an ``--slo_spec``-grammar string or a spec tuple
    for the per-version burn; ``canary_every`` pins every N-th accepted
    order to the canary (0 = the live fleet's size at rollout start)."""

    def __init__(
        self,
        *,
        canary_window_s: float = 5.0,
        canary_min_requests: int = 4,
        canary_every: int = 0,
        canary_slos=None,
        quiesce_timeout_s: float = 60.0,
        swap_timeout_s: float = 60.0,
        verify=None,
        clock=time.monotonic,
    ):
        self.canary_window_s = canary_window_s
        self.canary_min_requests = max(1, canary_min_requests)
        self._canary_every_cfg = canary_every
        if canary_slos is None:
            self._canary_specs = _default_canary_slos()
        elif isinstance(canary_slos, str):
            self._canary_specs = parse_slo_spec(canary_slos)
        else:
            self._canary_specs = tuple(canary_slos)
        self.quiesce_timeout_s = quiesce_timeout_s
        self.swap_timeout_s = swap_timeout_s
        self._verify = verify if verify is not None else verify_checkpoint
        self._clock = clock
        self._router = None
        self.state = "idle"
        # Rollout-scoped state (reset by start()).
        self._ckpt: str | None = None
        self.target_version: str | None = None
        self._queue: list[int] = []          # replica indices still to do
        self._current: int | None = None     # the index being quiesced/swapped
        self._phase_t0 = 0.0
        self._quiesce_t0 = 0.0
        self._started_at = 0.0
        self._canary: int | None = None
        self._canary_every = 2
        self._canary_t0 = 0.0
        self._canary_seen = 0
        self._promoted = False
        self._rolling_back: set[int] = set()
        self._rollback_reason: str | None = None
        self._engines: dict = {}             # weight_version -> SLOEngine
        self.stats = {
            "started": 0, "completed": 0, "rejected": 0, "rollbacks": 0,
            "aborted": 0, "replicas_upgraded": 0, "canary_requests": 0,
            "injected_canary_burn": 0,
        }

    # -- wiring (router thread) ---------------------------------------------

    def attach(self, router) -> None:
        self._router = router

    def _emit(self, kind: str, **fields) -> None:
        self._router.emit_event(kind, **fields)

    # -- rollout admission -----------------------------------------------------

    @property
    def active(self) -> bool:
        return self.state in ("quiesce", "swap", "canary", "rolling", "rolling_back")

    def start(self, path: str) -> dict:
        """Begin a rollout to the checkpoint at ``path``. Integrity is
        checked here, for the whole fleet, before any replica is touched:
        a torn or mismatched checkpoint answers a structured ``upgrade``
        refusal and serving is not disturbed. Returns a status dict (the
        control line answers it as it is)."""
        if self._router is None:
            return {"ok": False, "code": "upgrade", "error": "no router attached"}
        if self.active:
            return {
                "ok": False, "code": "upgrade",
                "error": f"a rollout to {self.target_version} is already "
                         f"in flight (state {self.state})",
            }
        try:
            ckpt_dir, version = self._verify(path)
        except Exception as e:  # noqa: BLE001 — any verification failure is one structured refusal
            self.stats["rejected"] += 1
            self._emit("route.upgrade", phase="rejected", ckpt=path,
                       error=f"{type(e).__name__}: {e}")
            return {"ok": False, "code": "upgrade", "error": f"{type(e).__name__}: {e}"}
        roster = [
            l.index for l in self._router.links
            if not l.dead and not l.retired and l.wv != version
        ]
        if not roster:
            self.stats["rejected"] += 1
            self._emit("route.upgrade", phase="rejected", ckpt=ckpt_dir, version=version,
                       error="no live replica needs this version")
            return {"ok": False, "code": "upgrade", "version": version,
                    "error": "no live replica needs this version"}
        self._ckpt = ckpt_dir
        self.target_version = version
        self._queue = roster
        self._current = None
        self._canary = None
        self._canary_seen = 0
        self._promoted = False
        self._rolling_back = set()
        self._rollback_reason = None
        self._engines = {}
        # The default slice: 1 / the live fleet's size.
        fleet = sum(1 for l in self._router.links if not l.dead and not l.retired)
        self._canary_every = self._canary_every_cfg or max(2, fleet)
        self._started_at = self._clock()
        self.stats["started"] += 1
        # Respawns from here on come up at the target version.
        self._router.weight_target = (ckpt_dir, version)
        self.state = "quiesce"
        self._emit(
            "route.upgrade", phase="started", ckpt=ckpt_dir, version=version,
            canary_every=self._canary_every,
            replicas=[self._router.links[i].name for i in roster],
        )
        return {"ok": True, "version": version, "replicas": len(roster)}

    # -- the poll loop (router thread, from Router.pump) ----------------------

    def poll(self) -> bool:
        if self._router is None or not self.active:
            return False
        now = self._clock()
        if self.state == "rolling_back":
            return self._poll_rollback(now)
        if self.state == "canary":
            return self._poll_canary(now)
        # quiesce / swap / rolling: drive the current replica forward.
        if self._current is None:
            return self._pick_next(now)
        link = self._router.links[self._current]
        if link.dead:
            # Died mid-swap: failover re-queued its work and the supervisor
            # respawns it at the target version; go on with the rest.
            link.upgrading = False
            self._current = None
            return True
        if self.state == "quiesce":
            if link.inflight == 0:
                return self._send_swap(link, now)
            if now - self._quiesce_t0 > self.quiesce_timeout_s:
                self._abort(
                    f"replica {link.name} did not drain within {self.quiesce_timeout_s:g}s"
                )
                return True
            return False
        if self.state == "swap" and now - self._phase_t0 > self.swap_timeout_s:
            self._abort(
                f"replica {link.name} did not confirm the swap within {self.swap_timeout_s:g}s"
            )
            return True
        return False

    def _pick_next(self, now: float) -> bool:
        while self._queue:
            index = self._queue.pop(0)
            link = self._router.links[index]
            if link.dead or link.retired or link.wv == self.target_version:
                # Dead replicas respawn at the target; converged ones need
                # nothing.
                continue
            self._current = index
            link.upgrading = True
            self._quiesce_t0 = now
            self.state = "quiesce"
            return True
        self._complete(now)
        return True

    def _send_swap(self, link, now: float) -> bool:
        try:
            maybe_fail("route.upgrade")  # the mid-rollout abort drill
            link.send({"type": "upgrade", "ckpt": self._ckpt, "version": self.target_version})
        except (OSError, ValueError) as e:
            self._abort(f"upgrade dispatch to {link.name} failed: {type(e).__name__}: {e}")
            return True
        self._phase_t0 = now
        self.state = "swap"
        return True

    def _complete(self, now: float) -> None:
        self._current = None
        self.stats["completed"] += 1
        self.state = "done"
        # weight_target stays set: later respawns and scale-ups bootstrap
        # at the converged version.
        self._emit(
            "route.upgrade", phase="completed", version=self.target_version,
            time_to_upgrade_s=round(now - self._started_at, 6),
            replicas_upgraded=self.stats["replicas_upgraded"],
        )

    # -- canary ---------------------------------------------------------------

    def _canary_engine(self, version: str) -> SLOEngine:
        if version not in self._engines:
            self._engines[version] = SLOEngine(self._canary_specs, interval=0.0, clock=time.time)
        return self._engines[version]

    def _poll_canary(self, now: float) -> bool:
        link = self._router.links[self._canary]
        if link.dead:
            # A dead canary is not a clean window: one that stays dead
            # (the new weights crash it, the respawn budget runs out) reads
            # as a rollback signal, never as a traffic-starved promotion.
            if now - self._canary_t0 >= 4 * max(self.canary_window_s, 0.5):
                self._begin_rollback(
                    "canary replica died on the new weights and did not recover"
                )
                return True
            return False
        result = self._canary_engine(self.target_version).maybe_evaluate()
        breached = [name for name, r in (result or {}).items() if r["breached"]]
        if breached:
            evidence = {
                name: {k: w["burn_rate"] for k, w in (result or {})[name]["windows"].items()}
                for name in breached
            }
            self._begin_rollback(
                f"canary burn > 1 sustained on {'+'.join(breached)}", evidence=evidence,
            )
            return True
        elapsed = now - self._canary_t0
        if elapsed >= self.canary_window_s and (
            self._canary_seen >= self.canary_min_requests
            or elapsed >= 4 * self.canary_window_s
        ):
            # A clean window (or 4 windows with too little traffic: an idle
            # fleet must not wedge its own upgrade) promotes the rollout.
            self._promoted = True
            self._emit(
                "route.canary", phase="promoted",
                replica=self._router.links[self._canary].name,
                version=self.target_version,
                window_s=round(elapsed, 3), requests=self._canary_seen,
            )
            self.state = "rolling"
            return True
        return False

    def route(self, rr, usable):
        """The router's canary pin: during the canary window every
        ``canary_every``-th accepted order goes to the canary (when it can
        serve the stage), a deterministic slice."""
        if self.state != "canary" or self._canary is None:
            return None
        if rr.order % self._canary_every != 0:
            return None
        link = self._router.links[self._canary]
        return link if link in usable else None

    def observe(self, rr, resp: dict, slo) -> None:
        """The answer-funnel tap (router thread): every tagged answer goes
        into its weight_version's SLO engine, the per-version burn the
        canary verdict reads. ``route.canary`` marks canary answers bad
        here."""
        if not self.active or self.target_version is None:
            return
        version = resp.get("weight_version")
        if version is None:
            return
        sample = dict(slo) if isinstance(slo, dict) else {}
        sample.setdefault("total_s", 0.0)
        if "error" in resp:
            sample["error"] = resp["error"]
            if "code" in resp:
                sample["code"] = resp["code"]
        if version == self.target_version:
            if self.state == "canary":
                self._canary_seen += 1
                self.stats["canary_requests"] += 1
            if fired("route.canary"):
                # An availability failure (and a TTFT bust) in the canary's
                # split: the burn rollback, on demand.
                self.stats["injected_canary_burn"] += 1
                sample["error"] = "injected canary burn (route.canary)"
                sample["ttft_s"] = 1e9
        self._canary_engine(version).record(sample)

    # -- replica messages (router inbox, router thread) ----------------------

    def on_msg(self, link, msg: dict) -> None:
        kind = msg.get("type")
        if kind == "upgrade_staged":
            if not msg.get("ok"):
                # The replica refused the checkpoint: refuse fleet-wide.
                self._abort(f"replica {link.name} refused the checkpoint: {msg.get('error')}")
            return
        if kind != "upgraded":
            return
        version = msg.get("version")
        if not msg.get("ok", True):
            if self._rolling_back or self.state == "rolling_back":
                # A rollback flip that failed leaves the replica on the new
                # weights; the final state and the versions show it.
                self._rolling_back.discard(link.index)
                return
            if not self.active:
                return  # a stale abort outside any rollout
            self._abort(f"replica {link.name} swap aborted: {msg.get('error')}")
            return
        link.wv = version
        if self._rolling_back or self.state in ("rolling_back", "rolled_back", "failed"):
            if version == self.target_version and self.target_version is not None \
                    and not link.dead:
                # A flip that landed after the rollback decision: roll this
                # replica back too (never leave a half-upgraded fleet).
                try:
                    link.upgrading = True
                    link.send({"type": "rollback"})
                    self._rolling_back.add(link.index)
                    if self.state in ("rolled_back", "failed"):
                        self.state = "rolling_back"
                except (OSError, ValueError):
                    link.upgrading = False  # failover handles it
            else:
                self._rolling_back.discard(link.index)
                link.upgrading = False
            return
        if not self.active or version != self.target_version:
            return  # a stale or rollback confirmation outside a rollout
        link.upgrading = False
        self.stats["replicas_upgraded"] += 1
        now = self._clock()
        self._emit(
            "route.upgrade", phase="swapped", replica=link.name, version=version,
            quiesce_s=round(self._phase_t0 - self._quiesce_t0, 6),
            swap_s=round(now - self._phase_t0, 6),
        )
        if self._current == link.index:
            self._current = None
        if self._canary is None and not self._promoted:
            # The first upgraded replica is the canary: pin its slice, start
            # the window, hold the rollout until the verdict.
            self._canary = link.index
            self._canary_t0 = now
            self._canary_seen = 0
            self.state = "canary"
            self._emit(
                "route.canary", phase="started", replica=link.name, version=version,
                every=self._canary_every, window_s=self.canary_window_s,
            )
        else:
            self.state = "rolling"

    def on_death(self, link) -> None:
        """A failover during a rollout: un-pin the replica; the supervisor
        respawns the index at ``weight_target`` and the roster skips the
        converged replacement."""
        if not self.active:
            return
        link.upgrading = False
        if self._current == link.index:
            self._current = None
        if self.state == "canary" and self._canary == link.index:
            # The replacement (same index, target version) inherits the
            # slice; the window restarts on its traffic.
            self._canary_t0 = self._clock()
            self._canary_seen = 0
        self._rolling_back.discard(link.index)

    # -- rollback / abort -----------------------------------------------------

    def _begin_rollback(self, reason: str, evidence=None) -> None:
        """Swap every upgraded replica back to the resident old params and
        surrender the rollout: the canary-burn path and the abort path
        both land here."""
        self.stats["rollbacks"] += 1
        self._rollback_reason = reason
        self._rolling_back = set()
        self._queue = []  # a surrendered rollout never resumes
        router = self._router
        router.weight_target = None  # respawns revert to the argv weights
        for link in router.links:
            if link.dead or link.retired:
                continue
            if link.wv == self.target_version:
                link.upgrading = True  # quiesce for the rollback flip too
                try:
                    link.send({"type": "rollback"})
                    self._rolling_back.add(link.index)
                except (OSError, ValueError):
                    link.upgrading = False  # failover will handle it
            else:
                link.upgrading = False
        self._current = None
        self.state = "rolling_back"
        self._emit(
            "route.upgrade", phase="rolled_back", rolled_back=True,
            version=self.target_version, reason=reason, evidence=evidence,
            replicas=[router.links[i].name for i in sorted(self._rolling_back)],
        )

    def _poll_rollback(self, now: float) -> bool:
        self._rolling_back = {
            i for i in self._rolling_back
            if not self._router.links[i].dead
            and self._router.links[i].wv == self.target_version
        }
        if self._rolling_back:
            return False
        self.state = "rolled_back" if self._rollback_reason else "failed"
        return True

    def _abort(self, reason: str) -> None:
        """A structural failure (a refused checkpoint, a swap fault, a
        dispatch failure, a drain timeout): emit it and converge the fleet
        back to the old version."""
        self.stats["aborted"] += 1
        self._emit("route.upgrade", phase="failed", version=self.target_version, error=reason)
        self._begin_rollback(reason)
        self._rollback_reason = None  # the final state is "failed", not "rolled_back"
