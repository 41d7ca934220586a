"""Live weights in the port (``serve/upgrade.py``, the scheduler's
two-version param slot) against the JAX package's, ported from
``tests/test_upgrade.py`` (less its ``--mesh`` and retrace cases).

The checkpoint side: manifests, the fleet-wide verification and the
replica's verified load give JAX's versions and refusals on checkpoints
either package wrote. The scheduler side: requests admitted before a
stage answer on their admission-time weights, the flip lands at a
drained step boundary and copies in place (every serving tensor keeps
its identity and storage), a rollback exchanges the two sets, and the
answers equal JAX's scheduler's, tags included; a prefix cached before
a flip is served from the old weights' KV after it, as in JAX. The
coordinator runs the JAX fake-fleet drills on both packages and must
reach the same states and events. The subprocess fleet rolls an upgrade
through two port workers under traffic (answers per tag equal to JAX's
on each version's weights), heals a SIGKILL at the target version, and
rolls a canary back on ``route.canary``.
"""

import io
import json
import os
import signal
import time

import numpy as np
import pytest

from torch_fleet import (
    PACKAGES,
    PROMPT_A,
    SPEC,
    EventLogOf,
    Events,
    both,
    continuations,
    fake_replica_class,
    jax_checkpoint,
    jax_model,
    jax_reference,
    port_model,
    spawn_fleet,
    write_spec,
)
from transformer_tpu.serve import upgrade as jupgrade
from transformer_tpu.train import checkpoint as jckpt
from transformer_tpu_torch.serve import upgrade as tupgrade
from transformer_tpu_torch.train import checkpoint as tckpt


@pytest.fixture(autouse=True)
def _one_thread_workers(monkeypatch):
    """CPU workers of one intra-op thread each: a fleet's processes must
    not crowd out other tests running beside it on the machine."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(scope="module")
def lm():
    return jax_model()


@pytest.fixture(scope="module")
def lm_new():
    """The upgrade target: the same architecture from another seed."""
    return jax_model({**SPEC, "seed": 1})


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory, lm, lm_new):
    root = tmp_path_factory.mktemp("ckpts")
    return jax_checkpoint(root / "old", lm[0]), jax_checkpoint(root / "new", lm_new[0])


# --------------------------------------------------------------------------
# checkpoints: manifests, verification, the verified load


def test_manifest_digest_names_bytes(tmp_path):
    state = {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}
    p1 = tckpt.CheckpointManager(str(tmp_path / "t"), is_primary=True).save(state, step=1)
    j1 = jckpt.CheckpointManager(str(tmp_path / "j"), is_primary=True).save(state, step=1)
    v1 = tckpt.verify_manifest(p1)
    assert v1 == jckpt.verify_manifest(j1) == jckpt.checkpoint_version(p1)
    mgr = tckpt.CheckpointManager(str(tmp_path / "t"), is_primary=True)
    assert tckpt.verify_manifest(mgr.save(state, step=2)) == v1
    assert tckpt.verify_manifest(mgr.save({"w": state["w"] + 1}, step=3)) != v1


def test_manifest_catches_what_the_structural_probe_cannot(tmp_path, capsys):
    mgr = tckpt.CheckpointManager(str(tmp_path), is_primary=True)
    good = {"w": np.full((2, 3), 7.0, np.float32)}
    mgr.save(good, step=1)
    p2 = mgr.save({"w": np.full((2, 3), 9.0, np.float32)}, step=2)
    donor = tckpt.CheckpointManager(str(tmp_path / "donor"), is_primary=True)
    dpath = donor.save({"w": np.full((2, 3), 5.0, np.float32)}, step=9)
    os.replace(os.path.join(dpath, "arrays.npz"), os.path.join(p2, "arrays.npz"))
    with pytest.raises(tckpt.CheckpointIntegrityError):
        tckpt.verify_manifest(p2)
    with pytest.raises(jckpt.CheckpointIntegrityError):
        jckpt.verify_manifest(p2)
    restored = mgr.restore_latest({"w": np.zeros((2, 3), np.float32)})
    np.testing.assert_array_equal(restored["w"], good["w"])
    assert "falling back" in capsys.readouterr().err


def test_torn_manifest_falls_back(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), is_primary=True)
    mgr.save({"w": np.full((2,), 1.0, np.float32)}, step=1)
    p2 = mgr.save({"w": np.full((2,), 2.0, np.float32)}, step=2)
    with open(os.path.join(p2, "manifest.json"), "w") as f:
        f.write('{"format": "manifest-v1", "arrays": {"w"')
    with pytest.raises(tckpt.CheckpointIntegrityError):
        tckpt.load_manifest(p2)
    fallbacks = []
    restored = mgr.restore_latest({"w": np.zeros((2,), np.float32)},
                                  on_fallback=lambda step, exc: fallbacks.append(step))
    np.testing.assert_array_equal(restored["w"], np.full((2,), 1.0))
    assert fallbacks == [2]


def test_load_checkpoint_params_verifies_and_matches(lm, lm_new, ckpts):
    """The port's verified load of a JAX-written checkpoint: JAX's version
    tag, JAX's arrays, in the port's tree (a meta-tensor template will do)."""
    from transformer_tpu.train.checkpoint import _flatten
    from transformer_tpu_torch.models.transformer import flatten

    params, _, _ = port_model(lm)
    _, new_dir = ckpts
    loaded, version = tupgrade.load_checkpoint_params(new_dir, params)
    assert version == tupgrade.verify_checkpoint(new_dir)[1] == \
        jupgrade.verify_checkpoint(new_dir)[1] == jupgrade.load_checkpoint_params(
            new_dir, lm[0])[1]
    want = _flatten(lm_new[0])
    got = flatten(loaded)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    meta = {k: v.to("meta") for k, v in flatten(params).items()}
    from transformer_tpu_torch.models.transformer import unflatten

    assert tupgrade.load_checkpoint_params(new_dir, unflatten(meta))[1] == version


def test_load_checkpoint_params_refuses_wrong_spec(tmp_path, lm):
    other = jax_model({**SPEC, "config": {**SPEC["config"], "d_model": 32, "dff": 64}})
    path = jax_checkpoint(tmp_path, other[0])
    params, _, _ = port_model(lm)
    with pytest.raises(tupgrade.UpgradeError, match="does not match the running") as got:
        tupgrade.load_checkpoint_params(path, params)
    with pytest.raises(jupgrade.UpgradeError, match="does not match the running") as want:
        jupgrade.load_checkpoint_params(path, lm[0])
    assert str(got.value).split(" (")[0] == str(want.value).split(" (")[0]


def test_verify_checkpoint_refuses_unmanifested_and_flipped_bytes(tmp_path, ckpts):
    path = tckpt.CheckpointManager(str(tmp_path / "a"), is_primary=True).save(
        {"w": np.zeros((2,), np.float32)}, step=1)
    os.unlink(os.path.join(path, "manifest.json"))
    with pytest.raises(tupgrade.UpgradeError, match="no manifest"):
        tupgrade.verify_checkpoint(path)
    with pytest.raises(jupgrade.UpgradeError, match="no manifest"):
        jupgrade.verify_checkpoint(path)
    # One byte flipped in the arrays of a real checkpoint: both refuse.
    import shutil

    bad = str(tmp_path / "flipped")
    shutil.copytree(ckpts[1], bad)
    npz = os.path.join(bad, "arrays.npz")
    raw = bytearray(open(npz, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(npz, "wb").write(bytes(raw))
    with pytest.raises(tupgrade.UpgradeError, match="failed integrity verification"):
        tupgrade.verify_checkpoint(bad)
    with pytest.raises(jupgrade.UpgradeError):
        jupgrade.verify_checkpoint(bad)


# --------------------------------------------------------------------------
# the scheduler's two-version param slot


PROMPT_REQS = [{"prompt": PROMPT_A, "max_new": 6}] * 2


def _straddle(sched, new_params):
    """Admit two on the old weights, stage the new ones, queue a third
    (quiesced), run to the end; then roll back and serve again."""
    for r in PROMPT_REQS:
        sched.submit(dict(r))
    sched.admit()
    trail = [sched.active_count]
    sched.stage_params(new_params, "vNEW")
    sched.submit({"prompt": PROMPT_A, "max_new": 6})
    sched.admit()
    trail.append(sched.active_count)
    while sched.busy:
        sched.admit()
        sched.step()
    trail += [sched.drain_ready(), sched.weight_version, sched.consume_swap_events()]
    trail.append(sched.stage_rollback())
    sched.step()
    trail += [sched.weight_version, sched.run([dict(r) for r in PROMPT_REQS])]
    return trail


def test_scheduler_swap_admission_time_weights(lm, lm_new):
    """The straddle on both schedulers: the first two answer on their
    admission-time weights, the quiesced third on the new ones, the
    rollback restores the old pair; the answers (and tags) are JAX's."""
    from transformer_tpu.serve import ContinuousScheduler as JScheduler
    from transformer_tpu.train.checkpoint import _flatten
    from transformer_tpu_torch.models.transformer import unflatten
    from transformer_tpu_torch.serve.scheduler import ContinuousScheduler

    params, cfg, tok = port_model(lm)
    jparams, jcfg, jtok = lm
    want_old = jax_reference(lm, PROMPT_REQS)
    want_new = jax_reference(lm_new, PROMPT_REQS)
    assert want_old[0] != want_new[0], "old and new weights answer alike: the test is vacuous"
    port = ContinuousScheduler(params, cfg, tok, num_slots=2, weight_version="vOLD",
                               device="cpu")
    new_np = unflatten({k: np.asarray(v) for k, v in _flatten(lm_new[0]).items()})
    got = _straddle(port, new_np)
    want = _straddle(JScheduler(jparams, jcfg, jtok, num_slots=2, weight_version="vOLD"),
                     lm_new[0])
    assert got == want
    assert [o["weight_version"] for o in got[2]] == ["vOLD", "vOLD", "vNEW"]
    assert continuations(got[2]) == continuations(want_old) + continuations(want_new)[:1]
    assert got[4] == [{"ok": True, "version": "vNEW"}]
    assert continuations(got[7]) == continuations(want_old)
    assert port.stats["swaps"] == 2


def test_flip_copies_in_place(lm, lm_new):
    """Every serving tensor keeps its identity and its storage through a
    flip and a rollback (the captured graphs read those addresses), and the
    caller's params are never written."""
    from transformer_tpu.train.checkpoint import _flatten
    from transformer_tpu_torch.models.transformer import flatten, unflatten
    from transformer_tpu_torch.serve.scheduler import ContinuousScheduler

    params, cfg, tok = port_model(lm)
    before_caller = {k: v.clone() for k, v in flatten(params).items()}
    sched = ContinuousScheduler(params, cfg, tok, num_slots=2, device="cpu")
    serving = flatten(sched.params)
    ids = {k: id(t) for k, t in serving.items()}
    ptrs = {k: t.data_ptr() for k, t in serving.items()}
    assert sched.forward.params is sched.params
    new = {k: np.asarray(v) for k, v in _flatten(lm_new[0]).items()}
    sched.stage_params(unflatten(new), "vNEW")
    sched.step()
    assert sched.weight_version == "vNEW"
    for key, t in flatten(sched.params).items():
        assert id(t) == ids[key] and t.data_ptr() == ptrs[key], key
        np.testing.assert_array_equal(t.numpy(), new[key])
    sched.stage_rollback()
    sched.step()
    for key, t in flatten(sched.params).items():
        assert id(t) == ids[key] and t.data_ptr() == ptrs[key], key
        assert np.array_equal(t.numpy(), before_caller[key].numpy()), key
    for key, t in flatten(params).items():
        assert np.array_equal(t.numpy(), before_caller[key].numpy()), key
    assert sched.forward.captures == []  # eager on the CPU; nothing re-captured


def test_stage_params_refuses_structural_mismatch(lm):
    from transformer_tpu.serve import ContinuousScheduler as JScheduler
    from transformer_tpu.train.checkpoint import _flatten
    from transformer_tpu_torch.models.transformer import unflatten
    from transformer_tpu_torch.serve.scheduler import ContinuousScheduler

    params, cfg, tok = port_model(lm)
    sched = ContinuousScheduler(params, cfg, tok, num_slots=1, device="cpu")
    other = jax_model({**SPEC, "config": {**SPEC["config"], "d_model": 32, "dff": 64}})
    with pytest.raises(ValueError, match="mismatch") as got:
        sched.stage_params(unflatten({k: np.asarray(v) for k, v in _flatten(other[0]).items()}),
                           "vBAD")
    with pytest.raises(ValueError, match="mismatch") as want:
        JScheduler(*lm, num_slots=1).stage_params(other[0], "vBAD")
    # The same count of mismatched leaves, in JAX's message.
    assert str(got.value).split(" (")[0] == str(want.value).split(" (")[0]
    assert not sched.swap_pending
    with pytest.raises(ValueError, match="structure"):
        sched.stage_params({"w": np.zeros(2, np.float32)}, "vBAD")
    with pytest.raises(ValueError, match="no resident previous weights"):
        sched.stage_rollback()


def test_stale_prefix_hit_after_a_swap_matches_jax(lm, lm_new):
    """The prefix cache's keys name no weight version: a prompt cached on
    the old weights is restored from their KV after the flip, in JAX and
    in the port alike (the reference's behaviour, kept)."""
    from transformer_tpu.serve import ContinuousScheduler as JScheduler
    from transformer_tpu.serve import PrefixCache as JCache
    from transformer_tpu.train.checkpoint import _flatten
    from transformer_tpu_torch.models.transformer import unflatten
    from transformer_tpu_torch.serve.prefix_cache import PrefixCache
    from transformer_tpu_torch.serve.scheduler import ContinuousScheduler

    params, cfg, tok = port_model(lm)
    jparams, jcfg, jtok = lm
    prompt = {"prompt": "ab cd ef gh ij kl mn ab", "max_new": 6}

    def drill(sched, new):
        first = sched.run([dict(prompt)])
        sched.stage_params(new, "vNEW")
        sched.step()
        hits = sched.stats["prefix_hit_tokens"]
        second = sched.run([dict(prompt)])
        return first, second, sched.stats["prefix_hit_tokens"] - hits

    got = drill(
        ContinuousScheduler(params, cfg, tok, num_slots=1, device="cpu",
                            prefix_cache=PrefixCache(cfg, block_tokens=4, budget_mb=8)),
        unflatten({k: np.asarray(v) for k, v in _flatten(lm_new[0]).items()}),
    )
    want = drill(JScheduler(jparams, jcfg, jtok, num_slots=1,
                            prefix_cache=JCache(jcfg, block_tokens=4, budget_mb=8)),
                 lm_new[0])
    assert got == want
    assert got[2] > 0 and got[1][0]["weight_version"] == "vNEW"


# --------------------------------------------------------------------------
# the coordinator's drills over fake fleets, both packages


def _fake_fleet(pkg, n=2, *, upgrader, supervisor=None, telemetry=None, **kw):
    Fake = fake_replica_class(pkg)
    links = [Fake(i, f"f{i}") for i in range(n)]
    router = pkg.Router(links, encode=None, upgrader=upgrader, supervisor=supervisor,
                        telemetry=telemetry, **kw)
    for link in links:
        link.router = router
    return router, links


def _drive(router, up, until, max_iters=200):
    for _ in range(max_iters):
        router.pump(timeout=0)
        if until():
            return
    raise AssertionError(f"coordinator stuck in state {up.state}")


def _phases(events):
    return [(e["kind"], e.get("phase")) for e in events]


def test_corrupt_checkpoint_rejected_before_any_replica_swaps(tmp_path):
    path = tckpt.CheckpointManager(str(tmp_path), is_primary=True).save(
        {"w": np.zeros((2,), np.float32)}, step=1)
    mpath = os.path.join(path, "manifest.json")
    manifest = json.load(open(mpath))
    manifest["arrays"]["w"]["crc32"] ^= 0xFF
    json.dump(manifest, open(mpath, "w"))

    def drill(pkg):
        log = EventLogOf(pkg)
        up = pkg.UpgradeCoordinator()
        router, links = _fake_fleet(pkg, 2, upgrader=up, telemetry=log.telemetry)
        status = router.start_upgrade(str(tmp_path))
        out = router.run([{"prompt": "p"}] * 3)
        return (status["ok"], status["code"], up.state, up.stats["rejected"],
                [l.upgrades_seen for l in links], router.weight_target, out,
                _phases(log.route()))

    got = both(drill)
    assert got["torch"] == got["jax"]
    assert got["torch"][:4] == (False, "upgrade", "idle", 1)
    assert ("route.upgrade", "rejected") in got["torch"][-1]


def test_canary_rollback_on_injected_burn():
    def drill(pkg):
        log = EventLogOf(pkg)
        up = pkg.UpgradeCoordinator(canary_window_s=30.0, canary_min_requests=2,
                                    verify=lambda p: (p, "vNEW"))
        router, links = _fake_fleet(pkg, 2, upgrader=up, telemetry=log.telemetry)
        first = router.run([{"prompt": "p"}] * 2)
        pkg.install(pkg.FaultPlane.parse("route.canary:p=1,seed=7"))
        try:
            assert router.start_upgrade("/ckpt")["ok"]
            _drive(router, up, lambda: up.state == "canary")
            during = router.run([{"prompt": "p"}] * 8)
            _drive(router, up, lambda: up.state in ("rolled_back", "failed"))
        finally:
            pkg.install(None)
        after = router.run([{"prompt": "p"}] * 3)
        rb = [e for e in log.route() if e.get("rolled_back")]
        return (first, during, after, up.state, dict(up.stats),
                [(l.wv, l.cur) for l in links], router.weight_target,
                _phases(log.route()), [(e["version"], e["reason"], e["evidence"]) for e in rb])

    got = both(drill)
    assert got["torch"] == got["jax"]
    first, during, after, state, stats, versions, target, _, rb = got["torch"]
    assert state == "rolled_back" and stats["rollbacks"] == 1
    assert stats["injected_canary_burn"] > 0 and stats["canary_requests"] > 0
    assert versions == [("vOLD", "vOLD")] * 2 and target is None
    assert all(o["weight_version"] == "vOLD" for o in after)
    assert len(rb) == 1 and rb[0][2] and "burn" in rb[0][1]


def test_mid_swap_death_respawns_at_target_version():
    def drill(pkg):
        clk = [0.0]
        spawn_targets = []
        Fake = fake_replica_class(pkg)

        def spawn(index, name, role, weight_target=None):
            spawn_targets.append(weight_target)
            link = Fake(index, name, version=weight_target[1] if weight_target else "vOLD")
            link.router = router
            router.inbox.put((index, {"type": "ready", "replica": name,
                                      "weight_version": link.wv}))
            return link

        sup = pkg.Supervisor(spawn, backoff_ms=0.0, clock=lambda: clk[0])
        up = pkg.UpgradeCoordinator(canary_window_s=0.0, canary_min_requests=1,
                                    verify=lambda p: (p, "vNEW"))
        router, links = _fake_fleet(pkg, 2, upgrader=up, supervisor=sup)
        links[1].die_on_upgrade = True
        assert router.start_upgrade("/ckpt")["ok"]

        def converged():
            clk[0] += 1.0
            return (up.state == "done" and sup.stats["respawns"] == 1
                    and all(not l.dead and l.wv == "vNEW" for l in router.links))

        _drive(router, up, converged)
        out = router.run([{"prompt": "p"}] * 4)
        return spawn_targets, out, up.stats["rollbacks"], dict(sup.stats)

    got = both(drill)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == [("/ckpt", "vNEW")]
    assert all(o["weight_version"] == "vNEW" for o in got["torch"][1])


def test_route_upgrade_fault_aborts_and_rolls_back():
    def drill(pkg):
        up = pkg.UpgradeCoordinator(canary_window_s=0.0, canary_min_requests=1,
                                    verify=lambda p: (p, "vNEW"))
        router, links = _fake_fleet(pkg, 2, upgrader=up)
        pkg.install(pkg.FaultPlane.parse("route.upgrade:at=2"))
        try:
            assert router.start_upgrade("/ckpt")["ok"]
            _drive(router, up, lambda: up.state in ("failed", "rolled_back"))
        finally:
            pkg.install(None)
        out = router.run([{"prompt": "p"}] * 3)
        return up.state, [l.cur for l in links], router.weight_target, out, dict(up.stats)

    got = both(drill)
    assert got["torch"] == got["jax"]
    assert got["torch"][:3] == ("failed", ["vOLD", "vOLD"], None)


def test_dead_canary_rolls_back_instead_of_starved_promotion():
    def drill(pkg):
        clk = [100.0]
        up = pkg.UpgradeCoordinator(canary_window_s=1.0, canary_min_requests=1,
                                    verify=lambda p: (p, "vNEW"), clock=lambda: clk[0])
        router, links = _fake_fleet(pkg, 2, upgrader=up)
        assert router.start_upgrade("/ckpt")["ok"]
        _drive(router, up, lambda: up.state == "canary")
        links[0].ok = False
        router.inbox.put((0, {"type": "exit"}))
        router.pump(timeout=0)

        def resolved():
            clk[0] += 1.0
            return up.state in ("rolled_back", "failed", "done", "rolling")

        _drive(router, up, resolved)
        return up.state, up._rollback_reason, links[1].cur, router.weight_target

    got = both(drill)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == "rolled_back" and "did not recover" in got["torch"][1]


def test_late_swap_confirmation_after_rollback_converges():
    def drill(pkg):
        up = pkg.UpgradeCoordinator(canary_window_s=30.0, canary_min_requests=1,
                                    verify=lambda p: (p, "vNEW"))
        router, links = _fake_fleet(pkg, 2, upgrader=up)
        held = []
        orig_send = links[0].send

        def holding_send(msg, _orig=orig_send):
            if msg.get("type") == "upgrade":
                links[0].upgrades_seen.append(dict(msg))
                links[0].cur = msg["version"]
                held.append({"type": "upgraded", "ok": True, "version": msg["version"]})
                return
            _orig(msg)

        links[0].send = holding_send
        pkg.install(pkg.FaultPlane.parse("route.canary:p=1,seed=3"))
        try:
            assert router.start_upgrade("/ckpt")["ok"]
            _drive(router, up, lambda: up.state == "swap")
            up._abort("simulated mid-rollout abort")
            mid = up.state
            for msg in held:
                router.inbox.put((0, msg))
            _drive(router, up, lambda: up.state in ("failed", "rolled_back"))
        finally:
            pkg.install(None)
        for _ in range(5):
            router.pump(timeout=0)
        return mid, up.state, [l.cur for l in links]

    got = both(drill)
    assert got["torch"] == got["jax"]
    assert got["torch"][1:] == ("failed", ["vOLD", "vOLD"])


def test_canary_every_defaults_to_fleet_size():
    def drill(pkg):
        up = pkg.UpgradeCoordinator(verify=lambda p: (p, "vNEW"))
        router, links = _fake_fleet(pkg, 3, upgrader=up)
        links[2].wv = links[2].cur = "vNEW"
        assert router.start_upgrade("/ckpt")["ok"]
        return up._canary_every

    assert both(drill) == {"jax": 3, "torch": 3}


def test_router_without_coordinator_refuses_upgrade():
    def drill(pkg):
        Fake = fake_replica_class(pkg)
        links = [Fake(0, "f0")]
        router = pkg.Router(links, encode=None)
        links[0].router = router
        return router.start_upgrade("/ckpt")

    got = both(drill)
    assert got["torch"] == got["jax"]
    assert got["torch"]["ok"] is False and got["torch"]["code"] == "upgrade"


# --------------------------------------------------------------------------
# subprocess fleets of the port's workers


def test_rolling_upgrade_subprocess_soak(tmp_path, lm, lm_new, ckpts):
    """Two port workers serving a live stream while a verified rolling
    swap walks the fleet (quiesce -> in-place flip -> canary -> promote):
    every request answers once, tagged with its admission-time version,
    with JAX's answer on that version's weights; a post-rollout SIGKILL
    heals at the target version."""
    from transformer_tpu_torch.serve.router import ReplicaProcess
    from transformer_tpu_torch.serve.supervisor import Supervisor

    old_dir, new_dir = ckpts
    old_version = tupgrade.verify_checkpoint(old_dir)[1]
    new_version = tupgrade.verify_checkpoint(new_dir)[1]
    reqs = [{"prompt": PROMPT_A, "max_new": 6}] * 14
    want_old = jax_reference(lm, reqs[:1])[0]["continuation"]
    want_new = jax_reference(lm_new, reqs[:1])[0]["continuation"]
    assert want_old != want_new
    worker = ["--model_spec", write_spec(tmp_path / "spec.json"), "--init_ckpt", old_dir,
              "--serve_slots", "2", "--heartbeat_ms", "50", "--device", "cpu"]

    def spawn(index, name, role, weight_target=None):
        argv = list(worker)
        if weight_target is not None:
            argv[argv.index("--init_ckpt") + 1] = weight_target[0]
            argv += ["--weight_version", weight_target[1]]
        return ReplicaProcess.spawn(index, argv, role=role, name=name)

    events = Events()
    sup = Supervisor(spawn, backoff_ms=50.0)
    up = tupgrade.UpgradeCoordinator(canary_window_s=0.3, canary_min_requests=1)
    router = spawn_fleet(2, worker[:-2], telemetry=events, supervisor=sup, upgrader=up,
                         heartbeat_timeout_s=10.0)
    answered = []
    deadline = time.time() + 80
    try:
        next_req, started = 0, False
        while (len(answered) < len(reqs) or (started and up.active)) \
                and time.time() < deadline:
            cap = 8 if up.state in ("idle", "quiesce", "swap") else len(reqs)
            while next_req < min(cap, len(reqs)) and router.backlog < 3:
                router.submit(dict(reqs[next_req]))
                next_req += 1
            router.pump()
            answered.extend(router.drain_ready())
            if not started and len(answered) >= 2:
                status = router.start_upgrade(new_dir)
                assert status["ok"] and status["version"] == new_version, status
                started = True
        assert up.state == "done", (up.state, up.stats)
        assert len(answered) == len(reqs)
        by_version = {}
        for a in answered:
            assert "continuation" in a, a
            by_version.setdefault(a["weight_version"], set()).add(a["continuation"])
        assert set(by_version) == {old_version, new_version}
        assert by_version == {old_version: {want_old}, new_version: {want_new}}
        assert router.weight_target == (new_dir, new_version)
        assert all(l.wv == new_version for l in router.links)
        victim = max(router.links, key=lambda l: l.answered)
        os.kill(victim.pid(), signal.SIGKILL)
        while time.time() < deadline:
            router.pump()
            if sup.stats["respawns"] == 1 and len(router.healthy_links) == 2:
                break
        assert sup.stats["respawns"] == 1, sup.stats
        replacement = router.links[victim.index]
        assert replacement is not victim and replacement.wv == new_version
        out2 = router.run([dict(r) for r in reqs[:4]])
        assert continuations(out2) == [want_new] * 4
        assert all(o["weight_version"] == new_version for o in out2)
    finally:
        router.shutdown()
    phases = [(e["kind"], e.get("phase")) for e in events.events
              if e["kind"] in ("route.upgrade", "route.canary")]
    assert phases == [("route.upgrade", "started"), ("route.upgrade", "swapped"),
                      ("route.canary", "started"), ("route.canary", "promoted"),
                      ("route.upgrade", "swapped"), ("route.upgrade", "completed")]
    # The flips copied in place and captured nothing (the survivor's
    # report; the victim was killed).
    survivor = router.links[1 - victim.index].final_stats
    assert survivor["swaps"] == 1 and survivor["params_moved"] == 0
    assert survivor["graph_captures"] == survivor["warm_captures"]


def test_subprocess_canary_rolls_back_on_route_canary(tmp_path, lm, ckpts):
    """route.canary burn on a real fleet: the canary rolls back, and its
    answers return to the old weights (JAX's answers on them). The prompts
    are shorter than one affinity block, so they go least-loaded and both
    workers serve."""
    from transformer_tpu_torch.serve import resilience

    old_dir, new_dir = ckpts
    reqs = [{"prompt": "ab cd", "max_new": 6}] * 4
    want_old = continuations(jax_reference(lm, reqs[:1])) * 4
    spec = write_spec(tmp_path / "spec.json")
    up = tupgrade.UpgradeCoordinator(canary_window_s=30.0, canary_min_requests=2)
    router = spawn_fleet(2, ["--model_spec", spec, "--init_ckpt", old_dir, "--serve_slots", "2",
                             "--heartbeat_ms", "50"], upgrader=up, heartbeat_timeout_s=10.0)
    deadline = time.time() + 60
    try:
        with resilience.active(resilience.FaultPlane.parse("route.canary:at=1")):
            assert router.start_upgrade(new_dir)["ok"]
            while up.state != "canary" and time.time() < deadline:
                router.pump()
            canary = router.links[up._canary]
            during = router.run([dict(r) for r in reqs])
            while up.state not in ("rolled_back", "failed") and time.time() < deadline:
                router.pump()
        assert up.state == "rolled_back" and up.stats["injected_canary_burn"] == 1
        assert router.weight_target is None
        old_version = tupgrade.verify_checkpoint(old_dir)[1]
        assert canary.wv == old_version
        served = canary.answered
        after = router.run([dict(r) for r in reqs])
        assert canary.answered > served
        assert continuations(after) == want_old
        assert all(a["weight_version"] == old_version for a in after)
        assert any(a["weight_version"] != old_version for a in during)
    finally:
        router.shutdown()
    assert canary.final_stats["swaps"] == 2 and canary.final_stats["params_moved"] == 0
