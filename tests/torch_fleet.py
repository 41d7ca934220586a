"""Shared pieces of the fleet tests (``tests/test_torch_router.py``,
``test_torch_supervisor.py``, ``test_torch_upgrade.py``,
``test_torch_standby.py``): the JAX tests'
tiny spec model, the same weights for both packages (a JAX-written
checkpoint the port's workers load through ``--init_ckpt``), subprocess
fleets of the port's workers, and the two packages' router tiers side by
side for the in-process fake-link drills."""

from __future__ import annotations

import io
import json
import types

import jax  # noqa: F401 — the conftest has put JAX on the CPU

# The JAX fleet tests' deterministic test model.
SPEC = {
    "config": {
        "num_layers": 1, "d_model": 16, "num_heads": 2, "dff": 32,
        "max_position": 32, "decoder_only": True, "tie_output": True,
        "dtype": "float32", "dropout_rate": 0.0,
    },
    "seed": 0,
    "corpus": ["ab cd ef gh ij kl mn"] * 3,
    "target_vocab_size": 300,
}
PROMPT_A = "ab cd ef gh ij"
PROMPT_B = "kl mn ef cd"


def jax_model(spec=SPEC):
    """(params, cfg, tok) of the JAX package's ``build_model_from_spec``."""
    from transformer_tpu.serve.replica import build_model_from_spec

    return build_model_from_spec(spec)


def jax_checkpoint(root, params) -> str:
    """``params`` saved through the JAX package's CheckpointManager (with
    its manifest); returns the checkpoint directory."""
    from transformer_tpu.train.checkpoint import CheckpointManager

    return CheckpointManager(str(root), is_primary=True).save(params, step=1)


def jax_reference(model, reqs, num_slots=2, **kw):
    """JAX's single ContinuousScheduler over ``reqs``."""
    from transformer_tpu.serve import ContinuousScheduler

    params, cfg, tok = model
    return ContinuousScheduler(params, cfg, tok, num_slots=num_slots, **kw).run(
        [dict(r) for r in reqs]
    )


def port_model(model):
    """The JAX model's weights as the port's (params, cfg, tok) on the CPU."""
    from transformer_tpu.train.checkpoint import _flatten
    from transformer_tpu_torch.convert import params_from_numpy
    from transformer_tpu_torch.serve.replica import build_model_from_spec

    _, cfg, tok = build_model_from_spec(SPEC, device="cpu")
    return params_from_numpy(_flatten(model[0]), cfg, device="cpu"), cfg, tok


def continuations(answers):
    return [a.get("continuation") for a in answers]


class Events:
    """The port router's event sink: ``emit(kind, **fields)`` into a list."""

    def __init__(self):
        self.events: list[dict] = []

    def emit(self, kind, **fields):
        self.events.append({"kind": kind, **fields})

    def of(self, kind):
        return [e for e in self.events if e["kind"] == kind]


def spawn_fleet(n, worker_args, *, disaggregate=False, telemetry=None, roles=None,
                per_replica=None, **kw):
    """A port Router over ``n`` port worker processes on the CPU;
    ``per_replica(i)`` adds replica ``i``'s own flags."""
    from transformer_tpu_torch.serve.router import ReplicaProcess, Router
    from transformer_tpu_torch.serve.replica import build_model_from_spec

    _, _, tok = build_model_from_spec(SPEC, device="cpu")
    links = []
    for i in range(n):
        role = "both"
        if disaggregate:
            role = "prefill" if i == 0 else "decode"
        if roles:
            role = roles[i]
        own = per_replica(i) if per_replica else []
        links.append(ReplicaProcess.spawn(i, [*worker_args, *own, "--device", "cpu"], role=role))
    kw.setdefault("affinity_block", 4)
    kw.setdefault("heartbeat_timeout_s", 30.0)
    router = Router(links, encode=tok.encode, bos_id=tok.bos_id,
                    disaggregate=disaggregate, telemetry=telemetry, **kw)
    for link in links:
        link.start_reader(router.inbox)
    return router


def write_spec(path) -> str:
    path.write_text(json.dumps(SPEC))
    return str(path)


# --------------------------------------------------------------------------
# the two packages' router tiers, for the same drill on each


def _prefix_state_parsed(entries):
    """A worker's ``prefix_state`` reply as JAX's reader delivers it."""
    return {"type": "prefix_state", "entries": entries}


def _prefix_state_line(entries):
    """... and as the port's: the worker's line, unparsed."""
    return {"type": "prefix_state", "line": json.dumps({"type": "prefix_state",
                                                        "entries": entries})}


def _ns(prefix):
    router = __import__(f"{prefix}.serve.router", fromlist=["Router"])
    sup = __import__(f"{prefix}.serve.supervisor", fromlist=["Supervisor"])
    up = __import__(f"{prefix}.serve.upgrade", fromlist=["UpgradeCoordinator"])
    res = __import__(f"{prefix}.serve.resilience", fromlist=["FaultPlane"])
    standby = __import__(f"{prefix}.serve.standby", fromlist=["Standby"])
    return types.SimpleNamespace(
        name=prefix, Router=router.Router, ReplicaLink=router.ReplicaLink,
        Standby=standby.Standby, TakeoverRejected=standby.TakeoverRejected,
        Supervisor=sup.Supervisor, FleetScaler=sup.FleetScaler,
        UpgradeCoordinator=up.UpgradeCoordinator, FaultPlane=res.FaultPlane,
        install=res.install,
        prefix_state=(_prefix_state_line if hasattr(router, "PREFIX_STATE_HEAD")
                      else _prefix_state_parsed),
    )


PACKAGES = {"jax": _ns("transformer_tpu"), "torch": _ns("transformer_tpu_torch")}


class EventLogOf:
    """An event sink for either package's router: JAX's ``Telemetry`` over
    an ``EventLog``, the port's list sink; ``route()`` lists the ``route.*``
    events as dicts without their timestamps."""

    def __init__(self, pkg):
        self.pkg = pkg.name
        if self.pkg == "transformer_tpu":
            from transformer_tpu.obs import EventLog, Telemetry

            self.buf = io.StringIO()
            self.telemetry = Telemetry(events=EventLog(self.buf))
        else:
            self.telemetry = Events()

    def route(self) -> list[dict]:
        if self.pkg == "transformer_tpu":
            self.telemetry.maybe_flush(force=True)
            events = [json.loads(line) for line in self.buf.getvalue().splitlines()]
        else:
            events = list(self.telemetry.events)
        return [
            {k: v for k, v in e.items() if k != "ts"}
            for e in events if str(e.get("kind", "")).startswith("route.")
        ]


def telemetry_of(pkg, sink, trace=True):
    """``pkg``'s ``obs.Telemetry`` over an ``EventLog`` on ``sink`` (a path
    or a text stream), with its tracer when ``trace``."""
    obs = __import__(f"{pkg.name}.obs", fromlist=["Telemetry"])
    return obs.Telemetry(events=obs.EventLog(sink), interval=1e9, trace=trace)


def fake_link_class(pkg):
    """The JAX tests' ``_FakeLink`` (echoes an answer per request unless
    muted; ``ok = False`` is a dead process) over ``pkg``'s ReplicaLink."""

    class FakeLink(pkg.ReplicaLink):
        def __init__(self, index, name, answer=True):
            super().__init__(index, name)
            self.sent = []
            self.answer_back = answer
            self.ok = True
            self.router = None

        def alive(self):
            return self.ok

        def kill(self):
            self.ok = False

        def send(self, msg):
            if not self.ok:
                raise BrokenPipeError("dead")
            self.sent.append(msg)
            if msg.get("type") == "prefill":
                self.router.inbox.put((self.index, {
                    "type": "prefilled", "rid": msg["rid"], "tokens": 0, "blocks": [],
                }))
            elif msg.get("type") == "req" and self.answer_back:
                self.router.inbox.put((self.index, {
                    "type": "answer", "rid": msg["rid"], "resp": {"continuation": self.name},
                }))
            elif msg.get("type") == "export_state":
                self.router.inbox.put((self.index, pkg.prefix_state([])))
            elif msg.get("type") == "inject_state":
                self.router.inbox.put((self.index, {"type": "state_injected", "tokens": 0}))

        def send_line(self, line):
            self.send(json.loads(line))

    return FakeLink


def fake_replica_class(pkg):
    """The JAX upgrade tests' ``_FakeReplica``: answers carry its current
    version, upgrade / rollback messages flip it and confirm."""

    class FakeReplica(pkg.ReplicaLink):
        def __init__(self, index, name, version="vOLD"):
            super().__init__(index, name)
            self.wv = version
            self.cur = version
            self.router = None
            self.ok = True
            self.die_on_upgrade = False
            self.upgrades_seen = []

        def alive(self):
            return self.ok

        def kill(self):
            self.ok = False

        def send(self, msg):
            if not self.ok:
                raise BrokenPipeError("dead")
            kind = msg.get("type")
            if kind == "req":
                self.router.inbox.put((self.index, {
                    "type": "answer", "rid": msg["rid"],
                    "resp": {"continuation": f"{self.name}:{self.cur}",
                             "weight_version": self.cur},
                    "slo": {"ttft_s": 0.01, "total_s": 0.02},
                }))
            elif kind == "upgrade":
                self.upgrades_seen.append(dict(msg))
                if self.die_on_upgrade:
                    self.ok = False
                    self.router.inbox.put((self.index, {"type": "exit"}))
                    return
                self.cur = msg["version"]
                self.router.inbox.put((self.index, {
                    "type": "upgrade_staged", "ok": True, "version": msg["version"],
                }))
                self.router.inbox.put((self.index, {
                    "type": "upgraded", "ok": True, "version": msg["version"],
                }))
            elif kind == "rollback":
                self.cur = "vOLD"
                self.router.inbox.put((self.index, {
                    "type": "upgraded", "ok": True, "version": "vOLD",
                }))
            elif kind == "export_state":
                self.router.inbox.put((self.index, pkg.prefix_state([])))
            elif kind == "inject_state":
                self.router.inbox.put((self.index, {"type": "state_injected", "tokens": 0}))

        def send_line(self, line):
            self.send(json.loads(line))

    return FakeReplica


def both(drill):
    """Run ``drill(pkg)`` for each package; returns {name: result}."""
    return {name: drill(pkg) for name, pkg in PACKAGES.items()}
