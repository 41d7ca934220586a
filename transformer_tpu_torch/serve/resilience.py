"""Fault-tolerant serving: deterministic fault injection, circuit breakers
and the continuous scheduler's error taxonomy.

Port of ``transformer_tpu/serve/resilience.py`` (standard library only):

- **Fault plane** (:class:`FaultPlane`): named, seeded injection points.
  ``FAULT_POINTS`` is the JAX package's whole set, so a spec that parses
  there parses here. The points with a site in the port are
  ``serve.prefill`` (the scheduler's admission), ``prefix.match`` /
  ``prefix.corrupt`` / ``prefix.insert`` (the prefix cache),
  ``draft.propose`` / ``draft.slow`` (both drafters), ``ckpt.swap`` (the
  scheduler's weight flip), and the fleet's ``route.spawn`` (the
  supervisor's respawn), ``route.hb`` (a heartbeat at the router),
  ``route.upgrade`` (the rollout's per-replica swap), ``route.canary``
  (the canary's per-version SLO split) and ``route.takeover`` (each
  per-replica handshake of the warm standby, ``serve/standby.py``), and
  ``obs.emit`` (the event log's write, ``obs/events.py``, through its
  ``fault_hook`` slot); ``ckpt.write`` and ``data.prefetch`` parse but
  fire nowhere until the modules that hold them are ported (the port's
  checkpoint writer and prefetch thread). Armed by
  ``cli.serve --fault_spec``, ``cli.router --fault_spec`` (in the router
  and in every worker it spawns) or :func:`active`; a disarmed plane
  costs one module-global ``None`` check per site.
- **Deterministic schedules**: every rule fires as a pure function of
  ``(seed, point, call index)``, the JAX plane's function, so one spec
  fires at the same calls in both packages.
- **Circuit breakers** (:class:`CircuitBreaker`, ``obs/breaker.py``).
- **Error taxonomy**: ``error_answer`` / ``classify_error`` /
  ``backoff_ms`` and ``TransientError``, the marker of a retryable
  admission failure.

Injected faults subclass ``OSError`` and :class:`TransientError`, as the
JAX package's do: the scheduler's bounded admission retry sees them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import threading
import time
from typing import Iterator

from transformer_tpu_torch.obs.breaker import BREAKER_STATE_VALUE, CircuitBreaker

__all__ = [
    "BREAKER_STATE_VALUE", "CircuitBreaker", "ERROR_CODES", "FAULT_POINTS", "FaultPlane",
    "FaultRule", "InjectedFault", "TransientError", "active", "backoff_ms",
    "classify_error", "error_answer", "fired", "install", "installed", "maybe_fail",
]

#: Every injection point the plane recognizes: a typo'd ``--fault_spec``
#: fails at parse time instead of silently never firing.
FAULT_POINTS = frozenset({
    "serve.prefill",    # raise inside slot admission, before the prefill pick
    "prefix.match",     # raise inside PrefixCache.match (trie walk)
    "prefix.corrupt",   # flip a byte of a matched host KV block (checksum catches)
    "prefix.insert",    # raise inside PrefixCache.insert / insert_device
    "draft.propose",    # raise inside the drafter's propose
    "draft.slow",       # sleep inside the drafter's propose (ms=N)
    "obs.emit",         # raise inside EventLog.emit's write
    "ckpt.write",       # a checkpoint commit (no site in the port yet)
    "data.prefetch",    # the prefetch worker (no site in the port yet)
    "route.spawn",      # raise inside the supervisor's replica (re)spawn
    "route.hb",         # swallow a replica heartbeat at the router
    "route.takeover",   # raise inside the standby's per-replica takeover handshake
    "ckpt.swap",        # abort the scheduler's step-boundary weight flip
    "route.upgrade",    # raise inside the rollout's per-replica swap dispatch
    "route.canary",     # mark a canary answer bad in the per-version SLO split
})


class TransientError(RuntimeError):
    """An admission failure worth a bounded, jittered retry (pool
    pressure, an injected fault), as opposed to a validation error, which
    no retry fixes."""


class InjectedFault(OSError, TransientError):
    """A fault the plane fired."""

    def __init__(self, point: str, index: int):
        super().__init__(f"injected fault at {point} (call #{index})")
        self.point = point
        self.index = index


@dataclasses.dataclass
class FaultRule:
    """When one injection point fires. One trigger shape applies: ``at``
    (1-based call indices) > ``every`` (every n-th call) > ``p`` (a seeded
    Bernoulli draw per call; the default, p=1.0). ``times`` caps the total
    fires; ``delay_ms`` turns the fault into a stall (sleep) instead of an
    exception."""

    point: str
    p: float = 1.0
    seed: int = 0
    at: frozenset[int] = frozenset()
    every: int = 0
    times: int = 0
    delay_ms: float = 0.0

    def should_fire(self, index: int, fired_so_far: int) -> bool:
        if self.times and fired_so_far >= self.times:
            return False
        if self.at:
            return index in self.at
        if self.every:
            return index % self.every == 0
        if self.p >= 1.0:
            return True
        # A str-seeded Random is sha512-based: the same draws on every run,
        # platform and package.
        return random.Random(f"{self.seed}|{self.point}|{index}").random() < self.p


class FaultPlane:
    """A set of :class:`FaultRule` with per-point call counters and a fired
    log (``episodes`` counts injected faults, ``fired_log`` lists (point,
    call index) pairs). Thread-safe: one lock around the counters."""

    def __init__(self, rules: Iterator[FaultRule] | list[FaultRule] = ()):
        self._rules: dict[str, FaultRule] = {}
        for rule in rules:
            if rule.point not in FAULT_POINTS:
                raise ValueError(
                    f"unknown fault point {rule.point!r}; valid points: "
                    f"{', '.join(sorted(FAULT_POINTS))}"
                )
            if rule.point in self._rules:
                raise ValueError(f"fault point {rule.point!r} appears twice in the spec")
            self._rules[rule.point] = rule
        self._lock = threading.Lock()
        self.calls: dict[str, int] = {}
        self.fired: dict[str, int] = {}
        self.fired_log: list[tuple[str, int]] = []

    @classmethod
    def parse(cls, spec: str) -> "FaultPlane":
        """The ``--fault_spec`` grammar::

            spec   := clause (';' clause)*
            clause := point ':' param (',' param)*   |   point
            param  := 'p=' float | 'seed=' int | 'at=' int('+' int)*
                    | 'every=' int | 'times=' int | 'ms=' float

        e.g. ``serve.prefill:p=0.25,seed=7;draft.slow:every=3,ms=40``."""
        rules = []
        for clause in spec.split(";"):
            clause = clause.strip()
            if not clause:
                continue
            point, _, params = clause.partition(":")
            kw: dict = {"point": point.strip()}
            for param in params.split(",") if params else []:
                key, sep, value = param.partition("=")
                key, value = key.strip(), value.strip()
                if not sep:
                    raise ValueError(f"fault_spec param {param!r} is not key=value")
                if key == "p":
                    kw["p"] = float(value)
                elif key == "seed":
                    kw["seed"] = int(value)
                elif key == "at":
                    kw["at"] = frozenset(int(v) for v in value.split("+"))
                elif key == "every":
                    kw["every"] = int(value)
                elif key == "times":
                    kw["times"] = int(value)
                elif key == "ms":
                    kw["delay_ms"] = float(value)
                else:
                    raise ValueError(
                        f"unknown fault_spec key {key!r} (valid: p, seed, "
                        "at, every, times, ms)"
                    )
            rules.append(FaultRule(**kw))
        return cls(rules)

    @property
    def episodes(self) -> int:
        with self._lock:
            return len(self.fired_log)

    def fire(self, point: str) -> FaultRule | None:
        """Count one call at ``point``; return its rule iff it fires."""
        with self._lock:
            rule = self._rules.get(point)
            n = self.calls.get(point, 0) + 1
            self.calls[point] = n
            if rule is None or not rule.should_fire(n, self.fired.get(point, 0)):
                return None
            self.fired[point] = self.fired.get(point, 0) + 1
            self.fired_log.append((point, n))
            return rule

    def hook(self, point: str) -> None:
        """Raise (or stall) iff ``point`` fires."""
        rule = self.fire(point)
        if rule is None:
            return
        if rule.delay_ms:
            time.sleep(rule.delay_ms / 1e3)
            return
        raise InjectedFault(point, self.calls[point])


_PLANE: FaultPlane | None = None


def installed() -> FaultPlane | None:
    return _PLANE


def install(plane: FaultPlane | None) -> None:
    """Make ``plane`` the process-wide fault plane (None = disarm). The
    event log cannot import this module (obs stays serve-free), so it
    exposes a ``fault_hook`` slot instead, which installation fills and
    uninstallation clears. Install before serving starts (``cli.serve``
    arms ``--fault_spec`` before it builds the scheduler; tests use
    :func:`active`)."""
    global _PLANE
    _PLANE = plane
    from transformer_tpu_torch.obs import events

    events.fault_hook = None if plane is None else plane.hook


@contextlib.contextmanager
def active(plane: FaultPlane):
    """Scoped installation::

        with resilience.active(FaultPlane.parse("serve.prefill:p=0.3")):
            scheduler.run(reqs)
    """
    install(plane)
    try:
        yield plane
    finally:
        install(None)


def maybe_fail(point: str) -> None:
    """An injection site: a no-op without a plane, else raise or stall per
    the point's rule."""
    plane = _PLANE
    if plane is None:
        return
    plane.hook(point)


def fired(point: str) -> bool:
    """A non-raising consultation for corruption-shaped points: the site
    mutates its own state when True (``prefix.corrupt`` flips a stored
    byte so the checksum proves detection)."""
    plane = _PLANE
    if plane is None:
        return False
    return plane.fire(point) is not None


#: code -> meaning. Every error the continuous scheduler answers carries
#: one of these under ``"code"``; the grouped path's errors carry none.
ERROR_CODES = {
    "validation": "the request itself is unservable (bad field, over-length)",
    "routing": "request kind does not match what this export serves",
    "deadline": "the request's deadline_ms elapsed before completion",
    "cancelled": "the client (or operator) cancelled the request",
    "backpressure": "the admission queue is full (max_backlog)",
    "transient": "a transient fault persisted through the bounded retries",
    "resource": "a device resource budget (paged KV pool) was exhausted "
                "mid-flight; the partial continuation rides along",
    "upgrade": "a live-weights rollout command was refused",
    "internal": "an unexpected failure; the request was isolated",
}


def classify_error(exc: BaseException) -> str:
    """Exception -> error code for admission-time failures."""
    if isinstance(exc, TransientError):
        return "transient"
    if isinstance(exc, (ValueError, TypeError, KeyError)):
        return "validation"
    return "internal"


def error_answer(code: str, message: str, **extra) -> dict:
    if code not in ERROR_CODES:
        raise ValueError(f"unknown error code {code!r}")
    return {"error": message, "code": code, **extra}


def backoff_ms(base_ms: float, attempt: int, order: int) -> float:
    """The wait before admission retry ``attempt`` (0-based) of request
    ``order``: ``base_ms`` doubled per attempt, times a jitter in [0.5,
    1.5) drawn from (order, attempt), so same-tick failures do not retry
    in lockstep and a run replays exactly."""
    jitter = 0.5 + random.Random(f"backoff|{order}|{attempt}").random()
    return base_ms * (2 ** attempt) * jitter
