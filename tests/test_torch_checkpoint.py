"""Checkpoints and exports: the port against the JAX package on the same
files, and the checkpoint manager's own behaviour (the JAX package's tests
of it, ported).

- JAX -> port: a JAX ``CheckpointManager`` checkpoint of a seq2seq
  ``TrainState`` after two JAX train steps (1 + 1 layers, d 32, fp32,
  dropout 0) restores in the port bit for bit (params, Adam's mu and nu,
  both optimizer counts, step; dtypes and shapes too); two more port steps
  then match two more JAX steps within ``tests/test_torch_train.py``'s
  train-step limits (loss within 1e-5 relative; params in units of the
  two steps' summed learning rate within 1e-5 on average and 1e-2 at
  worst per leaf, the key biases, whose gradient is rounding noise,
  within 2x). A JAX *sharded* checkpoint of an fsdp=8 state on the 8
  CPU devices restores bit for bit; so do bf16 leaves (stored as raw
  2-byte words).
- port -> JAX: after two port steps the port's checkpoint restores through
  JAX's ``restore_latest`` (which verifies the manifest) bit for bit, and
  both packages compute the same manifest digest: adam, adam with
  ``max_grad_norm``, adamw.
- int8: the port's ``export_params(quantize="int8")`` writes the same npz
  members as JAX's, byte for byte; each package's
  ``load_exported_params`` reads the other's export to identical arrays.
- ``average_checkpoints`` equals JAX's on the same checkpoints (exactly).
- The manager: rotation, empty directory, shape mismatch, torn-npz /
  garbled-meta / crc fallbacks, every step corrupt re-raises, a failed
  commit leaves the previous checkpoint intact, async round trip, the
  async snapshot survives the next in-place train step, sequential async
  saves rotate, a worker failure surfaces on ``wait``; the preemption
  guard and ``tree_checksum``.
"""

import dataclasses
import json
import os
import signal
import zipfile

import jax
import numpy as np
import pytest
import torch

from transformer_tpu.config import MeshConfig as JMesh
from transformer_tpu.config import ModelConfig as JConfig
from transformer_tpu.config import TrainConfig as JTrain
from transformer_tpu.models import transformer_init
from transformer_tpu.train.checkpoint import CheckpointManager as JManager
from transformer_tpu.train.checkpoint import _flatten as j_flatten
from transformer_tpu.train.checkpoint import average_checkpoints as j_average
from transformer_tpu.train.checkpoint import export_params as j_export
from transformer_tpu.train.checkpoint import load_exported_params as j_load_exported
from transformer_tpu.train.checkpoint import manifest_digest as j_digest
from transformer_tpu.train.checkpoint import manifest_entries as j_entries
from transformer_tpu.train.schedule import noam_schedule as j_noam
from transformer_tpu.train.state import create_train_state as j_create_state
from transformer_tpu.train.trainer import make_train_step as j_make_train_step
from transformer_tpu_torch.config import ModelConfig, TrainConfig
from transformer_tpu_torch.convert import params_from_numpy
from transformer_tpu_torch.models.transformer import flatten
from transformer_tpu_torch.train import checkpoint as ckpt
from transformer_tpu_torch.train.checkpoint import (
    AsyncCheckpointManager,
    CheckpointIntegrityError,
    CheckpointManager,
    average_checkpoints,
    export_params,
    load_exported_params,
    manifest_digest,
    manifest_entries,
    snapshot,
)
from transformer_tpu_torch.train.state import create_train_state
from transformer_tpu_torch.train.trainer import make_train_step
from transformer_tpu_torch.utils.preemption import PreemptionGuard, tree_checksum

MODEL = dict(
    num_layers=1, d_model=32, num_heads=4, dff=64, input_vocab_size=50,
    target_vocab_size=60, max_position=64, dropout_rate=0.0, dtype="float32",
    attention_impl="flash",
)
TRAIN = dict(batch_size=2, sequence_length=64, warmup_steps=4, label_smoothing=0.1)
OPTIMIZERS = {
    "adam": {},
    "adam_clip": dict(max_grad_norm=0.5),
    "adamw": dict(optimizer="adamw", weight_decay=0.1),
}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _pairs(seed, b=2, s=64):
    """(src, tgt) id batches, each row padded after its own length."""
    rng = np.random.default_rng(seed)
    src = rng.integers(1, MODEL["input_vocab_size"], size=(b, s)).astype(np.int32)
    tgt = rng.integers(1, MODEL["target_vocab_size"], size=(b, s)).astype(np.int32)
    for row in range(b):
        src[row, s - 3 * row - 1:] = 0
        tgt[row, s - 5 * row - 2:] = 0
    return src, tgt


def _configs(opt: str = "adam"):
    kw = OPTIMIZERS[opt]
    return (JConfig(**MODEL), JTrain(**TRAIN, **kw), ModelConfig(**MODEL),
            TrainConfig(**TRAIN, **kw))


def _same_bytes(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.shape == w.shape and g.dtype.itemsize == w.dtype.itemsize, key
        assert g.tobytes() == w.tobytes(), key


# --------------------------------------------------------------------------
# JAX -> port


def test_jax_checkpoint_restores_bit_for_bit_and_trains_on(tmp_path):
    jcfg, jtcfg, cfg, tcfg = _configs()
    jstate = j_create_state(jax.random.PRNGKey(0), jcfg, jtcfg)
    jstep = jax.jit(j_make_train_step(jcfg, jtcfg))
    rng = jax.random.PRNGKey(0)
    for i in range(2):
        jstate, _ = jstep(jstate, *_pairs(10 + i), rng)
    JManager(str(tmp_path), is_primary=True).save(jstate)

    template = create_train_state(cfg, tcfg, device="cpu")
    state = CheckpointManager(str(tmp_path)).restore_latest(template)
    got = snapshot(state)
    _same_bytes(got, j_flatten(jstate))
    for key, arr in j_flatten(jstate).items():
        assert got[key].dtype == arr.dtype, key
    assert state.step == 2 and state.opt_state.count == 2
    assert all(p.requires_grad for p in flatten(state.params).values())

    step = make_train_step(cfg, tcfg)
    for i in (2, 3):
        src, tgt = _pairs(10 + i)
        jstate, jm = jstep(jstate, src, tgt, rng)
        state, m = step(state, src, tgt)
        assert _rel(float(m["loss"]), float(jm["loss"])) <= 1e-5
    sched = j_noam(MODEL["d_model"], TRAIN["warmup_steps"])
    lr_sum = sum(float(sched(s)) for s in (2, 3))
    want = j_flatten(jstate.params)
    for key, p in flatten(state.params).items():
        diff = np.abs(p.detach().numpy() - want[key]) / lr_sum
        assert diff.max() <= 2.0, key
        if not key.endswith("mha/key/bias"):
            assert diff.mean() <= 1e-5 and diff.max() <= 1e-2, (key, diff.mean(), diff.max())


def test_jax_sharded_checkpoint_restores_bit_for_bit(tmp_path):
    from transformer_tpu.parallel import create_sharded_state, make_mesh

    model = dict(num_layers=2, d_model=16, num_heads=4, dff=32, input_vocab_size=32,
                 target_vocab_size=32, max_position=32, dtype="float32", dropout_rate=0.0)
    train = dict(batch_size=16, sequence_length=8, warmup_steps=10)
    mesh = make_mesh(JMesh(data=1, fsdp=8))
    jstate, _ = create_sharded_state(jax.random.PRNGKey(0), JConfig(**model), JTrain(**train), mesh)
    path = JManager(str(tmp_path), is_primary=True).save(jstate, step=7)
    files = os.listdir(path)
    assert "shards_p00000.npz" in files and "arrays.npz" not in files
    with np.load(os.path.join(path, "shards_p00000.npz")) as z:  # stored as 8 slices
        assert len([n for n in z.files if n.startswith("params/encoder/embedding/table@")]) == 8
    template = create_train_state(ModelConfig(**model), TrainConfig(**train), device="cpu")
    state = CheckpointManager(str(tmp_path)).restore_latest(template)
    _same_bytes(snapshot(state), j_flatten(jstate))


def test_jax_bf16_leaves_restore_as_their_bits(tmp_path):
    model = {**MODEL, "param_dtype": "bfloat16"}
    jstate = j_create_state(jax.random.PRNGKey(0), JConfig(**model), JTrain(**TRAIN))
    JManager(str(tmp_path), is_primary=True).save(jstate, step=3)
    with np.load(tmp_path / "ckpt_00000003" / "arrays.npz") as z:  # no bfloat16 in numpy
        assert z["params/final/kernel"].dtype.kind == "V"
    template = create_train_state(ModelConfig(**model), TrainConfig(**TRAIN), device="cpu")
    state = CheckpointManager(str(tmp_path)).restore_latest(template)  # verifies the manifest
    want = j_flatten(jstate)
    for key, p in flatten(state.params).items():
        assert p.dtype == torch.bfloat16, key
        assert p.detach().view(torch.int16).numpy().tobytes() == want[f"params/{key}"].tobytes()
    # ...and the port writes them back under the same manifest.
    back = CheckpointManager(str(tmp_path / "port"))
    back.save(state, step=3)
    manifest = json.loads((tmp_path / "port" / "ckpt_00000003" / "manifest.json").read_text())
    assert manifest["digest"] == j_digest(j_entries(want))


# --------------------------------------------------------------------------
# port -> JAX


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_port_checkpoint_restores_in_jax_bit_for_bit(tmp_path, opt):
    jcfg, jtcfg, cfg, tcfg = _configs(opt)
    jinit = j_create_state(jax.random.PRNGKey(0), jcfg, jtcfg)
    params = params_from_numpy(j_flatten(jinit.params), cfg, device="cpu")
    state = create_train_state(cfg, tcfg, params=params)
    assert sorted(snapshot(state)) == sorted(j_flatten(jinit))  # optax's names
    step = make_train_step(cfg, tcfg)
    for i in range(2):
        state, _ = step(state, *_pairs(20 + i))
    path = CheckpointManager(str(tmp_path)).save(state)
    want = snapshot(state)
    assert want["step"].dtype == np.int32 and want["step"].shape == ()

    restored = JManager(str(tmp_path), is_primary=True).restore_latest(
        j_create_state(jax.random.PRNGKey(1), jcfg, jtcfg)
    )
    got = j_flatten(restored)
    _same_bytes(got, want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
    on_disk = json.loads(open(os.path.join(path, "manifest.json")).read())["digest"]
    assert manifest_digest(manifest_entries(want)) == j_digest(j_entries(got)) == on_disk


# --------------------------------------------------------------------------
# int8 exports and averaging


def test_int8_exports_are_byte_identical_and_cross_load(tmp_path):
    jcfg, _, cfg, _ = _configs()
    jparams = transformer_init(jax.random.PRNGKey(3), jcfg)
    params = params_from_numpy(j_flatten(jparams), cfg, device="cpu")
    export_params(params, cfg, str(tmp_path / "port"), quantize="int8")
    j_export(jparams, jcfg, str(tmp_path / "jax"), quantize="int8")
    with zipfile.ZipFile(tmp_path / "port" / "params.npz") as zp, \
            zipfile.ZipFile(tmp_path / "jax" / "params.npz") as zj:
        assert sorted(zp.namelist()) == sorted(zj.namelist())
        assert any(n.endswith("::q8.npy") for n in zp.namelist())
        for name in zj.namelist():
            assert zp.read(name) == zj.read(name), name
    for export in ("port", "jax"):
        got = load_exported_params(str(tmp_path / export), params)
        want = j_flatten(j_load_exported(str(tmp_path / export), jparams))
        for key, p in flatten(got).items():
            assert p.numpy().tobytes() == want[key].tobytes(), (export, key)
    with pytest.raises(ValueError, match="quantize"):
        export_params(params, cfg, str(tmp_path / "bad"), quantize="int4")


def test_average_checkpoints_equals_jax(tmp_path):
    jcfg, jtcfg, cfg, tcfg = _configs()
    base = create_train_state(cfg, tcfg, device="cpu")
    mgr = CheckpointManager(str(tmp_path), max_to_keep=5)
    scales = [1.0, 2.0, 6.0]
    for i, s in enumerate(scales):
        scaled = {k: v.detach() * s for k, v in flatten(base.params).items()}
        from transformer_tpu_torch.models.transformer import unflatten

        mgr.save(dataclasses.replace(base, params=unflatten(scaled)), step=i)
    avg = flatten(average_checkpoints(mgr, base, mgr.all_steps()))
    jtemplate = j_create_state(jax.random.PRNGKey(1), jcfg, jtcfg)
    want = j_flatten(j_average(JManager(str(tmp_path), is_primary=True), jtemplate, [0, 1, 2]))
    for key, p in avg.items():
        assert np.array_equal(p.numpy(), want[key]), key
        np.testing.assert_allclose(p.numpy(), flatten(base.params)[key].detach().numpy() * 3.0,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="at least one"):
        average_checkpoints(mgr, base, [])


# --------------------------------------------------------------------------
# the manager (JAX's tests of it, ported)

TINY = dict(num_layers=1, d_model=16, num_heads=2, dff=32, input_vocab_size=30,
            target_vocab_size=30, max_position=32, dtype="float32", dropout_rate=0.0)
TCFG = dict(batch_size=4, sequence_length=8, epochs=1, warmup_steps=100)


def _tiny_state(seed=0, **model):
    return create_train_state(ModelConfig(**{**TINY, **model}), TrainConfig(**TCFG),
                              generator=torch.Generator().manual_seed(seed), device="cpu")


def _equal_states(a, b) -> None:
    _same_bytes(snapshot(a), snapshot(b))


def test_roundtrip_rotation_and_empty_directory(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.restore_latest(None) is None and mgr.latest_step is None
    state = _tiny_state()
    for s in (1, 2, 3, 4):
        mgr.save(state, step=s)
    assert mgr.all_steps() == [3, 4] and mgr.latest_step == 4
    restored = mgr.restore_latest(_tiny_state(seed=1))
    _equal_states(restored, state)
    assert restored.step == 0  # the state's own step; the directory is named by 4


def test_shape_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_tiny_state(), step=1)
    with pytest.raises(ValueError, match="checkpoint shape"):
        mgr.restore(_tiny_state(d_model=32), 1)


def _dict_states(mgr, steps):
    for step in steps:
        mgr.save({"w": np.full((2, 3), step, np.float32)}, step=step)
    return {"w": np.zeros((2, 3), np.float32)}


def test_restore_latest_falls_back_past_corrupt_checkpoints(tmp_path, capsys):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=5)
    template = _dict_states(mgr, (1, 2, 3))
    npz = tmp_path / "ckpt_00000003" / "arrays.npz"
    npz.write_bytes(npz.read_bytes()[: npz.stat().st_size // 2])  # torn mid-npz
    np.testing.assert_array_equal(mgr.restore_latest(dict(template))["w"], np.full((2, 3), 2.0))
    assert "falling back" in capsys.readouterr().err
    (tmp_path / "ckpt_00000002" / "meta.json").write_text("{torn")
    (tmp_path / "ckpt_00000002" / "arrays.npz").write_bytes(b"not a zip")
    fallbacks = []
    restored = mgr.restore_latest(dict(template), on_fallback=lambda s, e: fallbacks.append(s))
    np.testing.assert_array_equal(restored["w"], np.full((2, 3), 1.0))
    assert fallbacks == [3, 2]
    with pytest.raises(Exception):  # an explicit step still fails loudly
        mgr.restore(dict(template), 3)


def test_crc_mismatch_falls_back_where_the_shapes_still_fit(tmp_path):
    """A changed value in a well-formed npz passes every structural check;
    only the manifest's crc32 catches it."""
    mgr = CheckpointManager(str(tmp_path), max_to_keep=5)
    template = _dict_states(mgr, (1, 2))
    np.savez(tmp_path / "ckpt_00000002" / "arrays.npz", w=np.full((2, 3), 9.0, np.float32))
    with pytest.raises(CheckpointIntegrityError, match="crc32"):
        ckpt.verify_manifest(str(tmp_path / "ckpt_00000002"))
    fallbacks = []
    restored = mgr.restore_latest(dict(template), on_fallback=lambda s, e: fallbacks.append(s))
    np.testing.assert_array_equal(restored["w"], np.full((2, 3), 1.0))
    assert fallbacks == [2]


def test_every_checkpoint_corrupt_reraises(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=5)
    template = _dict_states(mgr, (1, 2))
    for step in (1, 2):
        (tmp_path / f"ckpt_{step:08d}" / "arrays.npz").write_bytes(b"garbage")
    with pytest.raises((zipfile.BadZipFile, OSError, ValueError)):
        mgr.restore_latest(dict(template))


def test_failed_commit_leaves_the_previous_checkpoint(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3)
    template = _dict_states(mgr, (1,))
    real_replace = os.replace

    def failing_replace(src, dst):
        if os.path.basename(dst).startswith("ckpt_"):
            raise OSError("injected commit failure")
        real_replace(src, dst)

    monkeypatch.setattr(os, "replace", failing_replace)
    with pytest.raises(OSError, match="injected"):
        mgr.save({"w": np.full((2, 3), 2.0, np.float32)}, step=2)
    monkeypatch.undo()
    assert mgr.all_steps() == [1]
    np.testing.assert_array_equal(mgr.restore_latest(template)["w"], np.full((2, 3), 1.0))


def test_async_roundtrip_matches_sync(tmp_path):
    state = _tiny_state()
    a = AsyncCheckpointManager(str(tmp_path / "async"), max_to_keep=3)
    s = CheckpointManager(str(tmp_path / "sync"), max_to_keep=3)
    a.save(state, step=5)
    s.save(state, step=5)
    a.wait()
    _equal_states(a.restore_latest(_tiny_state(1)), s.restore_latest(_tiny_state(2)))
    for name in ("manifest.json", "meta.json"):
        assert (tmp_path / "async" / "ckpt_00000005" / name).read_bytes() == \
            (tmp_path / "sync" / "ckpt_00000005" / name).read_bytes()


def test_async_snapshot_survives_the_next_in_place_step(tmp_path):
    """The train step updates the parameters in place right after save()
    returns: the checkpoint must hold the values from before it."""
    cfg, tcfg = ModelConfig(**TINY), TrainConfig(**TCFG)
    state = _tiny_state()
    before = snapshot(state)
    mgr = AsyncCheckpointManager(str(tmp_path), max_to_keep=3)
    mgr.save(state, step=0)
    rng = np.random.default_rng(0)
    src, tgt = (rng.integers(1, 28, (4, 8)).astype(np.int32) for _ in range(2))
    leaf = flatten(state.params)["final/kernel"]
    old = leaf.detach().clone()
    state, _ = make_train_step(cfg, tcfg)(state, src, tgt)
    assert not torch.equal(flatten(state.params)["final/kernel"], old)  # moved in place
    assert flatten(state.params)["final/kernel"] is leaf
    mgr.wait()
    _same_bytes(snapshot(mgr.restore(_tiny_state(2), 0)), before)


def test_async_sequential_saves_rotate(tmp_path):
    state = _tiny_state()
    mgr = AsyncCheckpointManager(str(tmp_path), max_to_keep=2)
    for i in range(4):
        mgr.save(state, step=i)
    mgr.wait()
    assert mgr.all_steps() == [2, 3]


def test_async_worker_failure_surfaces_on_wait(tmp_path):
    state = _tiny_state()
    mgr = AsyncCheckpointManager(str(tmp_path / "x"), max_to_keep=2)

    def boom(flat, step):
        raise OSError("disk full")

    mgr._write = boom
    mgr.save(state, step=0)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    del mgr.__dict__["_write"]  # the failure is consumed; the manager works again
    mgr.save(state, step=1)
    mgr.wait()
    assert mgr.all_steps() == [1]


def test_non_primary_process_writes_nothing(tmp_path):
    for cls in (CheckpointManager, AsyncCheckpointManager):
        mgr = cls(str(tmp_path / cls.__name__), is_primary=False)
        assert mgr.save(_tiny_state(), step=1) is None
        mgr.wait()
        assert not os.path.exists(mgr.directory)


# --------------------------------------------------------------------------
# preemption guard and checksum


def test_preemption_guard_latches_chains_and_restores():
    seen = []

    def previous(signum, frame):
        seen.append(signum)

    old = signal.signal(signal.SIGUSR1, previous)
    try:
        with PreemptionGuard(signals=(signal.SIGUSR1,)) as guard:
            assert not guard.should_stop
            os.kill(os.getpid(), signal.SIGUSR1)
            assert guard.should_stop and guard.signal_received == signal.SIGUSR1
            assert seen == [signal.SIGUSR1]  # chained
            os.kill(os.getpid(), signal.SIGUSR1)  # a second signal defers to it
            assert seen == [signal.SIGUSR1] * 2
        assert signal.getsignal(signal.SIGUSR1) is previous
    finally:
        signal.signal(signal.SIGUSR1, old)


def test_tree_checksum():
    a = snapshot(_tiny_state())
    assert tree_checksum(a) == tree_checksum(dict(a))
    assert tree_checksum(flatten(_tiny_state().params)) == tree_checksum(
        {k[len("params/"):]: v for k, v in a.items() if k.startswith("params/")}
    )
    b = dict(a)
    b["step"] = np.asarray(1, np.int32)
    assert tree_checksum(b) != tree_checksum(a)
    bf16 = {"x": torch.ones(3, dtype=torch.bfloat16)}
    assert tree_checksum(bf16) == tree_checksum({"x": torch.ones(3, dtype=torch.bfloat16)})
    assert tree_checksum(bf16) != tree_checksum({"x": torch.ones(3)})
