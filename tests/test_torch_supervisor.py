"""The port's fleet supervision (``serve/supervisor.py``), its fault points
and its CLI (``cli/router.py``) against the JAX package's, ported from
``tests/test_supervisor.py`` (less the mesh shape check, whose module is
a later slice; the standby / HA cases are in ``test_torch_standby.py``).

The supervisor's and the scaler's drills run on both packages' routers
over fake links fed the same messages and must make the same decisions.
A SIGKILLed port worker heals back: the replacement comes up under its
old name, is warmed from the survivor's prefix cache and answers as JAX's
single scheduler does. Each fault point the fleet adds (``route.spawn``,
``route.hb``, ``route.upgrade``, ``route.canary``, ``ckpt.swap``) fires at
JAX's call indices, and ``ckpt.swap`` through a fleet's ``--fault_spec``
aborts the flip with the old weights serving. ``cli.router`` takes every
flag of JAX's with JAX's defaults, takes ``--ha`` and ``--standby`` as
JAX's does (with its two warnings without ``--metrics_jsonl``), refuses
``--mesh``, and raises without a card before spawning.
"""

import io
import json
import os
import signal
import subprocess
import sys
import time

import pytest

from torch_fleet import (
    PACKAGES,
    PROMPT_A,
    SPEC,
    EventLogOf,
    Events,
    both,
    continuations,
    fake_link_class,
    jax_checkpoint,
    jax_model,
    jax_reference,
    port_model,
    spawn_fleet,
    write_spec,
)


@pytest.fixture(autouse=True)
def _one_thread_workers(monkeypatch):
    """CPU workers of one intra-op thread each: a fleet's processes must
    not crowd out other tests running beside it on the machine."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(scope="module")
def lm():
    return jax_model()


@pytest.fixture(scope="module")
def fleet_files(tmp_path_factory, lm):
    root = tmp_path_factory.mktemp("supervisor")
    return write_spec(root / "spec.json"), jax_checkpoint(root / "ckpt", lm[0])


def _fake_fleet(pkg, n=2, *, supervisor=None, scaler=None, slos=None, telemetry=None, **kw):
    Fake = fake_link_class(pkg)
    links = [Fake(i, f"f{i}") for i in range(n)]
    router = pkg.Router(links, encode=None, supervisor=supervisor, scaler=scaler, slos=slos,
                        telemetry=telemetry, **kw)
    for link in links:
        link.router = router
    return router, links


class _ScriptedSLO:
    """A duck-typed SLOEngine: ``maybe_evaluate`` returns the burn the test
    scripts next (None = no evaluation this pump)."""

    def __init__(self):
        self.next_burn = None
        self.recorded = []

    def maybe_evaluate(self):
        if self.next_burn is None:
            return None
        return {"ttft_p95": {"burn_rate": self.next_burn, "breached": self.next_burn > 1.0,
                             "windows": {"60s": {"burn_rate": self.next_burn}}}}

    def record(self, span):
        self.recorded.append(span)


# --------------------------------------------------------------------------
# the supervisor and the scaler over fake links, both packages


def test_crash_loop_exhausts_budget_and_serves_n_minus_1():
    def drill(pkg):
        clk = [0.0]
        calls = []

        def spawn(index, name, role):
            calls.append(index)
            raise RuntimeError("bootstrap faults every time")

        sup = pkg.Supervisor(spawn, max_restarts=3, restart_window_s=1000.0, backoff_ms=0.0,
                             clock=lambda: clk[0])
        log = EventLogOf(pkg)
        router, links = _fake_fleet(pkg, 2, supervisor=sup, telemetry=log.telemetry)
        links[0].ok = False
        router.inbox.put((0, {"type": "exit"}))
        router.pump(timeout=0)
        for _ in range(20):
            clk[0] += 1.0
            router.pump(timeout=0)
        out = router.run([{"prompt": "p"} for _ in range(4)])
        gave_up = [e for e in log.route() if e["kind"] == "route.spawn" and e.get("gave_up")]
        return (calls, dict(sup.stats), sup._slots[0].phase, router.breakers[0].state,
                continuations(out), gave_up)

    got = both(drill)
    assert got["torch"] == got["jax"]
    calls, stats, phase, state, out, gave_up = got["torch"]
    assert calls == [0, 0, 0] and stats["gave_up"] == 1 and phase == "gave_up"
    assert state == "open" and out == ["f1"] * 4
    assert len(gave_up) == 1 and gave_up[0]["attempts"] == 3


def test_warm_up_forwards_the_survivor_line_to_the_replacement():
    """The port's supervisor takes a ``prefix_state`` reply in its one form,
    the worker's line, and sends the replacement that line as its
    ``inject_state``, the same JSON retyped; the replacement's
    ``state_injected`` admits it with its tokens."""
    pkg = PACKAGES["torch"]
    from transformer_tpu_torch.serve.router import inject_state_line

    Fake = fake_link_class(pkg)
    entries = [{"ids": [1, 5, 9, 2], "tokens": 4, "blocks": [[{"k": {"dtype": "<f4"}}]]}]
    line = json.dumps({"type": "prefix_state", "entries": entries})
    forwarded = []

    class Survivor(Fake):
        def send(self, msg):
            if msg.get("type") == "export_state":
                self.router.inbox.put((self.index, {"type": "prefix_state", "line": line}))
            else:
                super().send(msg)

    class Replacement(Fake):
        def send_line(self, got):
            forwarded.append(got)
            self.router.inbox.put((self.index, {"type": "state_injected", "tokens": 4}))

    def spawn(index, name, role):
        link = Replacement(index, name)
        link.router = router
        router.inbox.put((index, {"type": "ready", "replica": name}))
        return link

    clk = [0.0]
    sup = pkg.Supervisor(spawn, backoff_ms=0.0, clock=lambda: clk[0])
    links = [Fake(0, "f0"), Survivor(1, "f1")]
    router = pkg.Router(links, encode=None, supervisor=sup)
    for link in links:
        link.router = router
    links[0].ok = False
    router.inbox.put((0, {"type": "exit"}))
    router.pump(timeout=0)
    for _ in range(4):
        clk[0] += 40.0
        router.pump(timeout=0)
    assert forwarded == [inject_state_line(line)]
    assert json.loads(forwarded[0]) == {"type": "inject_state", "entries": entries}
    assert sup.stats["respawns"] == 1 and sup.stats["warmed_tokens"] == 4
    assert sup._slots[0].phase == "up" and len(router.healthy_links) == 2


def test_respawn_storm_via_fault_plane():
    def drill(pkg):
        clk = [0.0]
        spawned = []
        Fake = fake_link_class(pkg)

        def spawn(index, name, role):
            link = Fake(index, name)
            link.router = router
            spawned.append(link)
            router.inbox.put((index, {"type": "ready", "replica": name}))
            return link

        sup = pkg.Supervisor(spawn, max_restarts=5, backoff_ms=0.0, clock=lambda: clk[0])
        router, links = _fake_fleet(pkg, 2, supervisor=sup)
        pkg.install(pkg.FaultPlane.parse("route.spawn:p=1,times=2,seed=7"))
        try:
            links[0].ok = False
            router.inbox.put((0, {"type": "exit"}))
            router.pump(timeout=0)
            for _ in range(10):
                clk[0] += 1.0
                router.pump(timeout=0)
                if sup.stats["respawns"] == 1:
                    break
        finally:
            pkg.install(None)
        return (dict(sup.stats), sup._slots[0].phase, router.links[0] is spawned[0],
                router.links[0].dead)

    got = both(drill)
    assert got["torch"] == got["jax"]
    stats = got["torch"][0]
    assert (stats["spawn_failures"], stats["spawn_attempts"], stats["respawns"]) == (2, 3, 1)
    assert got["torch"][1:] == ("up", True, False)


def test_route_hb_fault_swallows_heartbeats():
    def drill(pkg):
        router, links = _fake_fleet(pkg, 1)
        pkg.install(pkg.FaultPlane.parse("route.hb:p=1,times=2,seed=3"))
        try:
            for _ in range(3):
                router.inbox.put((0, {"type": "hb", "backlog": 0, "free": 2, "active": 0}))
            router.pump(timeout=0)
        finally:
            pkg.install(None)
        return router.stats["dropped_heartbeats"], links[0].last_hb is not None

    assert both(drill) == {"jax": (2, True), "torch": (2, True)}


def test_autoscale_burn_spawns_idle_drains():
    def drill(pkg):
        clk = [0.0]
        spawned = []
        Fake = fake_link_class(pkg)

        def spawn(index, name, role):
            link = Fake(index, name)
            link.router = router
            spawned.append(link)
            router.inbox.put((index, {"type": "ready", "replica": name}))
            return link

        sup = pkg.Supervisor(spawn, backoff_ms=0.0, clock=lambda: clk[0])
        scaler = pkg.FleetScaler(sustain_s=2.0, idle_s=3.0, max_replicas=2, min_replicas=1,
                                 cooldown_s=0.0, clock=lambda: clk[0])
        slo = _ScriptedSLO()
        log = EventLogOf(pkg)
        router, links = _fake_fleet(pkg, 1, supervisor=sup, scaler=scaler, slos=slo,
                                    telemetry=log.telemetry)
        trail = []
        slo.next_burn = 2.5
        router.pump(timeout=0)
        clk[0] += 2.5
        router.pump(timeout=0)
        trail.append((len(spawned), scaler.stats["scale_up"]))
        router.pump(timeout=0)
        trail.append(sup._slots[1].phase)
        clk[0] += 5.0
        router.pump(timeout=0)
        trail.append(scaler.stats["scale_up"])
        slo.next_burn = 0.0
        router.pump(timeout=0)
        clk[0] += 3.5
        router.pump(timeout=0)
        router.pump(timeout=0)
        trail.append((scaler.stats["scale_down"], router.links[1].retired, sup.stats["retired"]))
        clk[0] += 10.0
        router.pump(timeout=0)
        router.inbox.put((1, {"type": "exit"}))
        router.pump(timeout=0)
        clk[0] += 10.0
        router.pump(timeout=0)
        trail.append((scaler.stats["scale_down"], router.stats["failovers"], len(spawned)))
        out = router.run([{"prompt": "p"}] * 3)
        scales = [(e["direction"], e["signal"], e["burn_rate"], bool(e["evidence"]))
                  for e in log.route() if e["kind"] == "route.scale"]
        kinds = [e["kind"] for e in log.route()]
        return trail, continuations(out), scales, kinds.count("route.retire")

    got = both(drill)
    assert got["torch"] == got["jax"]
    trail, out, scales, retires = got["torch"]
    assert trail == [(1, 1), "up", 1, (1, True, 1), (1, 0, 1)]
    assert out == ["f0"] * 3 and retires == 1
    assert scales == [("up", "ttft_p95", 2.5, True), ("down", "ttft_p95", 0.0, True)]


def test_router_answer_funnel_feeds_slo_engine():
    def drill(pkg):
        slo = _ScriptedSLO()
        router, links = _fake_fleet(pkg, 1, slos=slo)
        links[0].answer_back = False
        order = router.submit({"prompt": "p"})
        router.pump(timeout=0)
        router.inbox.put((0, {"type": "answer", "rid": order, "resp": {"continuation": "x"},
                              "slo": {"ttft_s": 0.25, "total_s": 0.5}}))
        router.pump(timeout=0)
        return router.drain_ready(), slo.recorded

    got = both(drill)
    assert got["torch"] == got["jax"]
    assert got["torch"][1] == [{"ttft_s": 0.25, "total_s": 0.5, "order": 0}]


def test_failed_scale_up_respects_cooldown():
    def drill(pkg):
        clk = [100.0]
        calls = []

        def spawn(index, name, role):
            calls.append(clk[0])
            raise RuntimeError("fork fails under pressure")

        sup = pkg.Supervisor(spawn, backoff_ms=0.0, clock=lambda: clk[0])
        scaler = pkg.FleetScaler(sustain_s=1.0, max_replicas=2, cooldown_s=10.0,
                                 clock=lambda: clk[0])
        slo = _ScriptedSLO()
        router, _ = _fake_fleet(pkg, 1, supervisor=sup, scaler=scaler, slos=slo)
        slo.next_burn = 3.0
        router.pump(timeout=0)
        clk[0] += 1.5
        router.pump(timeout=0)
        trail = [len(calls)]
        for _ in range(5):
            clk[0] += 0.5
            router.pump(timeout=0)
        trail.append(len(calls))
        clk[0] += 10.0
        router.pump(timeout=0)
        return trail + [len(calls), sup.stats["spawn_failures"]]

    assert both(drill) == {"jax": [1, 1, 2, 2], "torch": [1, 1, 2, 2]}


def test_scheduler_span_tap_carries_latency(lm):
    """The span tap (the replica's side channel) hands each answer's span
    to host code: JAX's span keys, the order, and positive latencies."""
    from transformer_tpu.serve import ContinuousScheduler as JScheduler
    from transformer_tpu_torch.serve.prefix_cache import PrefixCache
    from transformer_tpu_torch.serve.scheduler import ContinuousScheduler

    params, cfg, tok = port_model(lm)
    reqs = [{"prompt": PROMPT_A, "max_new": 3}, {"prompt": PROMPT_A, "max_new": 0}]
    taps, jtaps = [], []
    sched = ContinuousScheduler(params, cfg, tok, num_slots=1, span_tap=taps.append,
                                weight_version="v1", device="cpu",
                                prefix_cache=PrefixCache(cfg, block_tokens=4, budget_mb=8))
    out = sched.run([dict(r) for r in reqs])
    from transformer_tpu.serve import PrefixCache as JCache

    want = JScheduler(*lm, num_slots=1, span_tap=jtaps.append, weight_version="v1",
                      prefix_cache=JCache(lm[1], block_tokens=4, budget_mb=8)).run(
        [dict(r) for r in reqs])
    assert out == want
    assert [sorted(t) for t in taps] == [sorted(t) for t in jtaps]
    assert [t["order"] for t in taps] == [0, 1]
    assert taps[0]["total_s"] > 0 and taps[0]["ttft_s"] > 0
    for key in ("prompt_tokens", "new_tokens", "forwards", "prefix_hit_tokens",
                "weight_version"):
        assert [t.get(key) for t in taps] == [t.get(key) for t in jtaps], key


# --------------------------------------------------------------------------
# the fault points the fleet adds: JAX's call indices, and each site


@pytest.mark.parametrize("spec", [
    "route.spawn:at=2+3", "route.hb:p=0.5,seed=11", "route.upgrade:every=3,times=2",
    "route.canary:p=0.3,seed=5", "ckpt.swap:at=1",
])
def test_fleet_fault_points_fire_at_jax_call_indices(spec):
    point = spec.split(":")[0]
    fired = {}
    for name, pkg in PACKAGES.items():
        plane = pkg.FaultPlane.parse(spec)
        fired[name] = [plane.fire(point) is not None for _ in range(24)]
    assert fired["torch"] == fired["jax"] and any(fired["torch"])


def test_ckpt_swap_aborts_the_flip_as_jax_does(lm):
    """ckpt.swap in the scheduler's flip: the swap reports ok=false with
    the injected fault, the old weights keep serving, and the next stage
    flips; JAX's scheduler reports and answers the same."""
    from transformer_tpu.serve import ContinuousScheduler as JScheduler
    from transformer_tpu.serve import resilience as jres
    from transformer_tpu.train.checkpoint import _flatten
    from transformer_tpu_torch.models.transformer import unflatten
    from transformer_tpu_torch.serve import resilience as tres
    from transformer_tpu_torch.serve.scheduler import ContinuousScheduler

    params, cfg, tok = port_model(lm)
    new = jax_model({**SPEC, "seed": 1})[0]
    req = [{"prompt": PROMPT_A, "max_new": 5}]

    def drill(sched, res, staged):
        res.install(res.FaultPlane.parse("ckpt.swap:at=1"))
        try:
            sched.stage_params(staged, "vNEW")
            sched.step()
            events = sched.consume_swap_events()
            first = sched.run([dict(r) for r in req])
            sched.stage_params(staged, "vNEW")
            sched.step()
            return events, first, sched.consume_swap_events(), sched.run([dict(r) for r in req])
        finally:
            res.install(None)

    got = drill(ContinuousScheduler(params, cfg, tok, num_slots=2, weight_version="vOLD",
                                    device="cpu"), tres,
                unflatten({k: __import__("numpy").asarray(v) for k, v in _flatten(new).items()}))
    want = drill(JScheduler(*lm, num_slots=2, weight_version="vOLD"), jres, new)
    assert got == want
    assert got[0][0]["ok"] is False and "injected fault at ckpt.swap" in got[0][0]["error"]
    assert got[1][0]["weight_version"] == "vOLD" and got[3][0]["weight_version"] == "vNEW"


def test_ckpt_swap_through_a_fleet_fault_spec(tmp_path, lm, fleet_files):
    """--fault_spec ckpt.swap:at=1 forwarded to the workers: the canary's
    flip aborts, the rollout fails, every worker keeps its version, and
    the fleet serves JAX's old-weight answers."""
    from transformer_tpu_torch.serve.upgrade import UpgradeCoordinator, verify_checkpoint

    spec, old_dir = fleet_files
    new_dir = jax_checkpoint(tmp_path / "new", jax_model({**SPEC, "seed": 1})[0])
    old_version = verify_checkpoint(old_dir)[1]
    events = Events()
    up = UpgradeCoordinator(canary_window_s=0.5, canary_min_requests=1)
    router = spawn_fleet(2, ["--model_spec", spec, "--init_ckpt", old_dir, "--serve_slots", "2",
                             "--heartbeat_ms", "50", "--fault_spec", "ckpt.swap:at=1"],
                         telemetry=events, upgrader=up)
    deadline = time.time() + 60
    try:
        assert router.start_upgrade(new_dir)["ok"]
        while up.state not in ("failed", "rolled_back", "done") and time.time() < deadline:
            router.pump()
        out = router.run([{"prompt": PROMPT_A, "max_new": 6}] * 3)
    finally:
        router.shutdown()
    assert up.state == "failed" and up.stats["aborted"] == 1
    failed = [e for e in events.of("route.upgrade") if e["phase"] == "failed"]
    assert "swap aborted" in failed[0]["error"] and "ckpt.swap" in failed[0]["error"]
    assert all(l.wv == old_version for l in router.links)
    assert continuations(out) == continuations(
        jax_reference(lm, [{"prompt": PROMPT_A, "max_new": 6}])) * 3
    assert all(a["weight_version"] == old_version for a in out)
    assert all(l.final_stats["swaps"] == 0 for l in router.links)


# --------------------------------------------------------------------------
# the acceptance drill: SIGKILL a worker, the fleet heals back to N


def test_sigkill_heal_soak(lm, fleet_files):
    """SIGKILL one of two port workers under a Supervisor: the replacement
    re-bootstraps from the same recipe under the old name, warms its
    PrefixCache from the survivor, and serves; no request is lost and the
    answers are JAX's single scheduler's."""
    from transformer_tpu_torch.serve.router import ReplicaProcess
    from transformer_tpu_torch.serve.supervisor import Supervisor

    spec, ckpt = fleet_files
    worker = ["--model_spec", spec, "--init_ckpt", ckpt, "--serve_slots", "2",
              "--heartbeat_ms", "50", "--prefix_cache_mb", "8", "--prefix_block", "4",
              "--device", "cpu"]

    def spawn(index, name, role):
        return ReplicaProcess.spawn(index, list(worker), role=role, name=name)

    events = Events()
    sup = Supervisor(spawn, backoff_ms=50.0)
    router = spawn_fleet(2, worker[:-2], telemetry=events, supervisor=sup,
                         heartbeat_timeout_s=10.0)
    reqs = [{"prompt": PROMPT_A, "max_new": 6}] * 6
    want = continuations(jax_reference(lm, reqs))
    deadline = time.time() + 60
    try:
        assert continuations(router.run([dict(r) for r in reqs])) == want
        victim = max(router.links, key=lambda l: l.answered)
        os.kill(victim.pid(), signal.SIGKILL)
        while time.time() < deadline:
            router.pump()
            if len(router.healthy_links) == 2 and sup.stats["respawns"] == 1:
                break
        assert sup.stats["respawns"] == 1 and sup.stats["gave_up"] == 0, sup.stats
        assert sup.stats["warmed_tokens"] > 0, sup.stats
        assert sup.heal_times and sup.heal_times[0] > 0
        assert continuations(router.run([dict(r) for r in reqs])) == want
        replacement = router.links[victim.index]
        assert replacement is not victim and replacement.name == victim.name
        assert replacement.answered > 0, "the replacement took no traffic"
    finally:
        router.shutdown()
    spawns = events.of("route.spawn")
    assert len(spawns) == 1 and spawns[0]["replica"] == victim.name
    assert spawns[0]["heal_s"] > 0 and spawns[0]["warmed_tokens"] == sup.stats["warmed_tokens"]
    assert replacement.final_stats["prefix_hit_tokens"] > 0


# --------------------------------------------------------------------------
# cli.router: JAX's flags and defaults, the refusals, the card check


def _jax_router_defaults() -> dict:
    """Every flag JAX's ``define_router_flags`` defines, with its default
    (in a fresh process: absl's flags are global)."""
    code = (
        "import json; from absl import flags; F = flags.FLAGS; "
        "from transformer_tpu.cli import router; before = set(F); "
        "router.define_router_flags(); F(['x']); "
        "print(json.dumps({n: F[n].default for n in F if n not in before}))"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_cli_router_takes_jax_flags_with_jax_defaults():
    from transformer_tpu_torch.cli.router import build_parser

    want = _jax_router_defaults()
    got = vars(build_parser().parse_args([]))
    assert "replicas" in want and "canary_window" in want and "standby" in want
    assert {k: got[k] for k in want} == want
    assert set(got) - set(want) == {"device"} and got["device"] == "cuda"


@pytest.mark.parametrize("flag", [
    ["--ha"], ["--standby", "p.jsonl"], ["--mesh", "2"], ["--metrics_jsonl", "m.jsonl"],
    ["--metrics_port", "9100"], ["--trace"],
    # JAX's two warnings: --ha and --standby without an event log.
    ["--ha", "--metrics_jsonl", ""], ["--standby", "p.jsonl", "--metrics_jsonl", ""],
])
def test_cli_router_refuses_the_later_slices(flag, fleet_files, tmp_path, monkeypatch, capsys):
    """Only ``--mesh`` is refused now. ``--ha`` reaches every worker's
    argv and the Router (without an event log it warns and is off for
    both); ``--standby`` takes the standby path with a primary's
    supervision kwargs (without an event log it warns and goes on)."""
    from transformer_tpu_torch.cli import router as cli
    from transformer_tpu_torch.serve import router as srouter
    from transformer_tpu_torch.serve import standby as sstandby

    argv = ["--model_spec", fleet_files[0], "--device", "cpu", *flag]
    if flag[0] in ("--metrics_jsonl", "--metrics_port", "--trace"):
        # The port's telemetry is accepted: each replica logs to <path>.r<i>.
        args = cli.build_parser().parse_args(argv)
        cli.refuse_later_slices(args)
        tail = cli.worker_args(args, cli.replica_jsonl(args, 1))
        if flag[0] == "--metrics_jsonl":
            assert tail[tail.index("--metrics_jsonl") + 1] == "m.jsonl.r1"
        else:
            assert "--metrics_jsonl" not in tail and "--trace" not in tail
        return
    if flag[0] == "--mesh":
        with pytest.raises(SystemExit, match="later slice"):
            cli.main(argv, stdin=io.StringIO(""))
        return
    warned = "--metrics_jsonl" in flag
    if not warned:
        argv += ["--metrics_jsonl", str(tmp_path / "m.jsonl"), "--flight_recorder=false"]
    Fake = fake_link_class(PACKAGES["torch"])

    class Link(Fake):
        def start_reader(self, inbox):
            pass

    spawned = []

    def spawn(cls, index, worker_argv, role="both", name=None):
        spawned.append(list(worker_argv))
        return Link(index, name or f"replica{index}")

    monkeypatch.setattr(srouter.ReplicaProcess, "spawn", classmethod(spawn))
    if flag[0] == "--ha":
        args = cli.build_parser().parse_args(argv)
        assert "--ha" in cli.worker_args(args)
        sink = None if warned else Events()
        router = cli.build_router(args, telemetry=sink)
        err = capsys.readouterr().err
        assert ("--ha needs --metrics_jsonl" in err) is warned
        assert router.ha is not warned and args.ha is not warned
        assert all(("--ha" in a) is not warned for a in spawned) and len(spawned) == 2
        return
    taken = []

    def run_until_takeover(self, *a, **k):
        taken.append(self)
        links = [Link(0, "replica0")]
        return srouter.Router(links, telemetry=self._tel, ha=True, epoch=self.epoch + 1,
                              **self._router_kwargs)

    monkeypatch.setattr(sstandby.Standby, "run_until_takeover", run_until_takeover)
    router = cli.main(argv, stdin=io.StringIO(""))
    err = capsys.readouterr().err
    assert ("--standby without --metrics_jsonl" in err) is warned
    assert spawned == [] and len(taken) == 1 and router.epoch == 2
    st = taken[0]
    assert st.log_path == "p.jsonl" and st.takeover_after_s == 2.0
    assert (st._tel is None) is warned
    kw = st._router_kwargs
    assert kw["affinity_block"] == 16 and kw["heartbeat_timeout_s"] == 5.0
    assert {"supervisor", "upgrader"} <= set(kw)
    # A respawn under the adopting router starts its worker with --ha.
    assert "--ha" in cli.worker_args(cli.build_parser().parse_args(argv))


def test_cli_router_raises_without_a_card_before_spawning(fleet_files, monkeypatch):
    from transformer_tpu_torch.cli import router as cli
    from transformer_tpu_torch.serve import router as srouter

    spawned = []
    monkeypatch.setattr(srouter.ReplicaProcess, "spawn",
                        classmethod(lambda cls, *a, **k: spawned.append(a)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--model_spec", fleet_files[0]], stdin=io.StringIO(""))
    assert spawned == []
    from transformer_tpu_torch.serve.replica import main as replica_main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        replica_main(["--model_spec", fleet_files[0]])


def test_cli_router_serves_lines_and_the_upgrade_control_line(tmp_path, fleet_files):
    """The CLI on the CPU: answers in request order, the routing error
    byte for byte cli.serve's, and {"upgrade": dir} answering the
    coordinator's status at its order (a refused checkpoint: ok false)."""
    from transformer_tpu_torch.cli.router import main
    from transformer_tpu_torch.serve.replica import build_model_from_spec
    from transformer_tpu_torch.serve.scheduler import ContinuousScheduler

    spec, _ = fleet_files
    bad = tmp_path / "nothing"
    bad.mkdir()
    lines = [PROMPT_A, '{"src": "x"}', json.dumps({"upgrade": str(bad)}),
             json.dumps({"prompt": "kl mn ef cd", "max_new": 4})]
    out = io.StringIO()
    router = main(["--device", "cpu", "--replicas", "2", "--model_spec", spec,
                   "--serve_slots", "2", "--prefix_block", "4", "--heartbeat_ms", "50"],
                  stdin=io.StringIO("\n".join(lines) + "\n"), stdout=out)
    answers = [json.loads(line) for line in out.getvalue().splitlines()]
    params, cfg, tok = build_model_from_spec(SPEC, device="cpu")
    want = ContinuousScheduler(params, cfg, tok, num_slots=2, device="cpu").run(
        [{"prompt": PROMPT_A}, {"prompt": "kl mn ef cd", "max_new": 4}])
    assert answers[0] == want[0] and answers[3] == want[1]
    assert answers[1] == {"error": "LM export serves 'prompt', not 'src'", "code": "routing"}
    assert answers[2]["upgrade"] == str(bad) and answers[2]["ok"] is False
    assert answers[2]["code"] == "upgrade" and "no checkpoint" in answers[2]["error"]
    assert all(l.final_stats is not None for l in router.links)


def test_postmortem_salvages_the_flight_dump_of_a_killed_worker(tmp_path):
    """A worker that died without a wire record leaves its autodump at
    ``<metrics_jsonl>.flight.json``: the supervisor salvages it into a
    ``route.postmortem`` event of origin ``file``, once, as JAX's does."""

    def drill(pkg):
        flight = __import__(f"{pkg.name}.obs.flight", fromlist=["FlightRecorder"])
        jsonl = str(tmp_path / f"{pkg.name}.r0")
        rec = flight.FlightRecorder(flight.flight_path_for(jsonl), source="f0")
        for i in range(3):
            rec.record("serve.request", {"order": i, "ts": 100.0 + i})
        rec.dump("auto")
        clk = [0.0]
        sup = pkg.Supervisor(lambda index, name, role: (_ for _ in ()).throw(
            RuntimeError("no respawn here")), max_restarts=1, restart_window_s=1000.0,
            backoff_ms=0.0, clock=lambda: clk[0])
        log = EventLogOf(pkg)
        router, links = _fake_fleet(pkg, 2, supervisor=sup, telemetry=log.telemetry)
        links[0].metrics_jsonl = jsonl
        links[0].ok = False
        router.inbox.put((0, {"type": "exit"}))
        for _ in range(5):
            clk[0] += 1.0
            router.pump(timeout=0)
        posts = [e for e in log.route() if e["kind"] == "route.postmortem"]
        return [(e["replica"], e["origin"], e["reason"], [x["order"] for x in
                 e["record"]["events"]]) for e in posts], sup.stats["postmortems"]

    got = both(drill)
    assert got["torch"] == got["jax"] == ([("f0", "file", "auto", [0, 1, 2])], 1)
