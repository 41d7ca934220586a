"""fsdp over processes: the port's partition rules, train steps and
``sharded-v1`` checkpoints against the JAX package, and the mesh checks'
messages.

- The rules: the port's spec of every leaf of the train state (params
  and Adam's moments) of every family (decoder-only, seq2seq, MoE with
  dense layers between, a gated FFN, tied embeddings; a vocabulary of 66,
  which fsdp 4 does not divide) equals JAX's ``param_partition_spec`` on
  fsdp 2 and fsdp 4 meshes; ``_divisible``'s fallback and ``batch_spec``
  equal JAX's; a leaf split over fsdp and gathered back is the leaf.
- Three train steps under ``--fsdp 2`` (gloo processes on the CPU, the
  weights of a JAX init) against JAX's ``DistributedTrainer`` on an fsdp 2
  mesh: the loss and ``grad_norm`` within 1e-5 relative, the eval loss
  too, the parameters as ``test_torch_pipeline.py`` holds them.
- The port's checkpoint of that run (``shards_p00000.npz``,
  ``shards_p00001.npz``, ``meta.json`` in JAX's ``sharded-v1`` layout)
  restores in JAX's ``CheckpointManager`` byte for byte, and JAX's
  sharded checkpoint of its run restores in the port, on the fsdp 2 mesh
  and in one process, byte for byte.
- Each refusal of the mesh checks raises JAX's message.
"""

import os
import types

import jax
import numpy as np
import pytest
import torch

import torch_pipeline_jobs as jobs
from transformer_tpu.config import MeshConfig as JMesh
from transformer_tpu.config import ModelConfig as JConfig
from transformer_tpu.config import TrainConfig as JTrain
from transformer_tpu.parallel import sharding as jsharding
from transformer_tpu.parallel.distributed import DistributedTrainer as JTrainer
from transformer_tpu.parallel.mesh import make_mesh as j_make_mesh
from transformer_tpu.train.checkpoint import CheckpointManager as JManager
from transformer_tpu.train.checkpoint import _flatten
from transformer_tpu.train.state import create_train_state as j_create_state
from transformer_tpu_torch.config import MeshConfig, ModelConfig, TrainConfig
from transformer_tpu_torch.parallel import sharding
from transformer_tpu_torch.parallel.distributed import check_mesh
from transformer_tpu_torch.parallel.mesh import Mesh, Process
from transformer_tpu_torch.train.checkpoint import CheckpointManager
from transformer_tpu_torch.train.state import create_train_state, state_to_flat

RULE_BASE = dict(num_layers=2, d_model=32, num_heads=4, dff=64, input_vocab_size=66,
                 target_vocab_size=66, max_position=32, dtype="float32")
RULE_FAMILIES = {
    "decoder_only": dict(decoder_only=True),
    "seq2seq": dict(),
    "moe_every_2": dict(decoder_only=True, moe_experts=4, moe_every=2),
    "gated": dict(ffn_activation="swiglu"),
    "tied": dict(tie_embeddings=True, tie_output=True),
}
TRAIN = dict(batch_size=8, sequence_length=16, warmup_steps=4)


def _spec_tuple(spec) -> tuple:
    return tuple(spec)


@pytest.mark.parametrize("fsdp", [2, 4])
@pytest.mark.parametrize("family", sorted(RULE_FAMILIES))
def test_rules_match_jax_for_every_leaf(family, fsdp):
    model = {**RULE_BASE, **RULE_FAMILIES[family]}
    mesh = j_make_mesh(JMesh(data=8 // fsdp, fsdp=fsdp))
    jstate = j_create_state(jax.random.PRNGKey(0), JConfig(**model), JTrain(**TRAIN))
    want = {
        jsharding._path_str(path): _spec_tuple(jsharding.param_partition_spec(path, leaf, mesh))
        for path, leaf in jax.tree_util.tree_flatten_with_path(jstate)[0]
    }
    state = create_train_state(ModelConfig(**model), TrainConfig(**TRAIN), device="cpu")
    got = {k: sharding.param_partition_spec(k, getattr(v, "shape", ()), dict(mesh.shape))
           for k, v in state_to_flat(state).items()}
    assert sorted(got) == sorted(want)
    assert got == want
    split = [k for k, s in got.items() if "fsdp" in s]
    assert split and any("embedding" in k for k in split) == (fsdp == 2)


DIVISIBLE_CASES = [
    (("fsdp", None), (66, 32)), (("fsdp", "model", None), (32, 4, 8)),
    (("expert", "fsdp", "model"), (4, 32, 64)), (("model", None, "fsdp"), (4, 8, 30)),
    ((("data", "fsdp"), None), (16, 3)), ((("data", "fsdp"), None), (12, 3)),
    (("fsdp",), ()), (("fsdp", "pipe"), (8, 8)), ((None,), (5,)),
]


@pytest.mark.parametrize("axes", [dict(data=2, fsdp=4), dict(fsdp=2), dict(data=4, fsdp=2,
                                                                         model=1, expert=1)])
@pytest.mark.parametrize("case", range(len(DIVISIBLE_CASES)))
def test_divisible_fallback_matches_jax(case, axes):
    from jax.sharding import PartitionSpec as P

    spec, shape = DIVISIBLE_CASES[case]
    want = jsharding._divisible(P(*spec), shape, types.SimpleNamespace(shape=axes))
    assert sharding._divisible(spec, shape, axes) == tuple(want)


@pytest.mark.parametrize("shard_seq", [False, True])
def test_batch_spec_matches_jax(shard_seq):
    for axes in (dict(data=2, fsdp=2, model=1, seq=1, pipe=2, expert=1), dict(data=2, pipe=2)):
        want = jsharding.batch_spec(types.SimpleNamespace(shape=axes), shard_seq)
        assert sharding.batch_spec(axes, shard_seq) == tuple(want)


def test_shard_bounds_name_the_window():
    # rank 3 of fsdp 2 x model 2: fsdp slice 1, model slice 1
    mesh = Mesh(MeshConfig(fsdp=2, model=2), Process(3, 4, torch.device("cpu"), "gloo"),
                (0, 1, 1, 0, 0, 0), None)
    t = torch.arange(48.0).reshape(4, 6, 2)
    split = sharding.leaf_split("decoder/layers/0/self_mha/query/kernel", t.shape, mesh.shape)
    assert split == {0: "fsdp", 1: "model"}
    assert sharding.leaf_bounds(t.shape, split, mesh) == ((2, 4), (3, 6), (0, 2))
    assert torch.equal(sharding.shard_leaf(t, split, mesh), t[2:, 3:])
    assert sharding.leaf_bounds((), {}, mesh) == ()
    assert sharding.shard_leaf(t, {}, mesh) is t


# --------------------------------------------------------------------------
# --fsdp 2 against JAX, and the checkpoints both ways

LM = dict(num_layers=2, d_model=32, num_heads=4, dff=64, input_vocab_size=64,
          target_vocab_size=64, max_position=32, dropout_rate=0.0, dtype="float32",
          attention_impl="flash", decoder_only=True)


def _batches():
    out = []
    for i in range(3):
        ids = np.random.default_rng(10 + i).integers(1, 63, size=(8, 16)).astype(np.int32)
        ids[1, 11:] = 0
        out.append((ids, ids))
    return out


@pytest.fixture(scope="module")
def fsdp_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("fsdp")
    mesh = j_make_mesh(JMesh(fsdp=2), devices=jax.devices()[:2])
    trainer = JTrainer(JConfig(**LM), JTrain(**TRAIN), mesh, log_fn=lambda *_: None,
                       donate_state=False)
    init = {k: np.asarray(v) for k, v in _flatten(trainer.state.params).items()}
    # The port's processes start now and run beside the JAX side; the
    # restore job waits for JAX's checkpoint to be written.
    saved = root / "jax_saved"
    base = dict(mesh=dict(fsdp=2), model=LM, train=TRAIN, init=init)
    handle = jobs.start_jobs([
        dict(name="train", kind="train", batches=_batches(), ckpt=str(root / "port"),
             state=True, **base),
        dict(name="roundtrip", kind="roundtrip", **base),
        dict(name="restore", kind="restore", ckpt=str(root / "jax"), wait_for=str(saved),
             **base),
    ], str(root), 2)
    try:
        state = trainer.state
        want = {"losses": [], "norms": []}
        for src, tgt in _batches():
            state, m = trainer.train_step(state, src, tgt, jax.random.PRNGKey(0))
            want["losses"].append(float(m["loss"]))
            want["norms"].append(float(m["grad_norm"]))
        want["eval_loss"] = float(trainer.eval_step(state, *_batches()[0])["loss"])
        want["state"] = {k: np.asarray(v) for k, v in _flatten(state).items()}
        JManager(str(root / "jax"), is_primary=True).save(state)
    except BaseException:
        for proc in handle.processes:  # else the restore job waits for `saved`
            proc.terminate()
        raise
    saved.touch()
    jobs.finish(handle)
    got = {}
    for name in ("train", "restore", "roundtrip"):
        with np.load(root / f"{name}.npz") as data:
            got[name] = {k: data[k] for k in data.files}
    return root, init, want, got


def test_fsdp2_steps_match_jax_trainer(fsdp_run):
    from test_torch_pipeline import _check_params, _rel

    _, _, want, got = fsdp_run
    train = got["train"]
    for key in ("losses", "norms"):
        assert all(_rel(g, w) <= 1e-5 for g, w in zip(train[key], want[key])), key
    assert _rel(train["eval_loss"], want["eval_loss"]) <= 1e-5
    _check_params(train, {k: v for k, v in want["state"].items() if k.startswith("params/")},
                  1e-5, 1e-2)


def test_shard_and_gather_round_trip(fsdp_run):
    rt = fsdp_run[3]["roundtrip"]
    assert int(rt["split"]) > 0 and int(rt["leaves"]) > int(rt["split"])


def test_port_sharded_checkpoint_restores_in_jax_byte_for_byte(fsdp_run):
    root, _, _, got = fsdp_run
    (ckpt,) = [d for d in os.listdir(root / "port") if d.startswith("ckpt_")]
    files = sorted(os.listdir(root / "port" / ckpt))
    assert files == ["meta.json", "shards_p00000.npz", "shards_p00001.npz"]
    template = j_create_state(jax.random.PRNGKey(1), JConfig(**LM), JTrain(**TRAIN))
    back = _flatten(JManager(str(root / "port"), is_primary=True).restore_latest(template))
    port = {k[len("state:"):]: v for k, v in got["train"].items() if k.startswith("state:")}
    assert sorted(back) == sorted(port)
    for key, arr in port.items():
        assert np.asarray(back[key]).tobytes() == arr.tobytes(), key


def test_jax_sharded_checkpoint_restores_in_port_byte_for_byte(fsdp_run):
    root, _, want, got = fsdp_run
    jstate = want["state"]
    (ckpt,) = [d for d in os.listdir(root / "jax") if d.startswith("ckpt_")]
    assert any(n.startswith("shards_p") for n in os.listdir(root / "jax" / ckpt))
    on_mesh = got["restore"]
    one = state_to_flat(CheckpointManager(str(root / "jax")).restore_latest(
        create_train_state(ModelConfig(**LM), TrainConfig(**TRAIN), device="cpu")))
    assert sorted(on_mesh) == sorted(jstate) == sorted(one)
    for key, arr in jstate.items():
        assert on_mesh[key].tobytes() == np.asarray(arr).tobytes(), key
        v = one[key]
        v = v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        assert v.tobytes() == np.asarray(arr).tobytes(), key


# --------------------------------------------------------------------------
# refusals, with JAX's messages

BASE = dict(num_layers=2, d_model=32, num_heads=4, dff=64, input_vocab_size=64,
            target_vocab_size=64, max_position=32, dtype="float32")
REFUSALS = {
    "pipe_with_seq": (dict(seq=2, pipe=2), dict(decoder_only=True, attention_impl="ring"), {}),
    "layers_per_stage": (dict(pipe=2), dict(decoder_only=True, num_layers=3), {}),
    "microbatches": (dict(data=2, pipe=2), dict(decoder_only=True), dict(pp_microbatches=3)),
    "batch": (dict(data=2, fsdp=2), dict(decoder_only=True), dict(batch_size=6)),
    "encoder_only": (dict(pipe=2), dict(encoder_only=True, tie_output=True),
                     dict(objective="mlm")),
    "mixed_moe": (dict(pipe=2), dict(decoder_only=True, moe_experts=4, moe_every=2), {}),
    "1f1b_loss_chunks": (dict(pipe=2), dict(decoder_only=True),
                         dict(pp_schedule="1f1b", loss_chunks=2)),
    "1f1b_grad_accum": (dict(pipe=2), dict(decoder_only=True),
                        dict(pp_schedule="1f1b", grad_accum_steps=2)),
}


def _fake_mesh(axes):
    cfg = MeshConfig(**axes)
    return Mesh(cfg, Process(0, cfg.num_devices, torch.device("cpu"), "gloo"),
                (0,) * len(cfg.axis_names), None)


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_raise_jax_messages(case):
    axes, model, train = REFUSALS[case]
    model, train = {**BASE, **model}, {**TRAIN, **train}
    with pytest.raises((ValueError, NotImplementedError)) as got:
        check_mesh(ModelConfig(**model), TrainConfig(**train), _fake_mesh(axes))
    n = MeshConfig(**axes).num_devices
    mesh = j_make_mesh(JMesh(**axes), devices=jax.devices()[:n])
    jcfg, jtcfg = JConfig(**model), JTrain(**train)
    with pytest.raises(ValueError) as want:
        if case.startswith("1f1b"):
            from transformer_tpu.parallel.distributed import make_1f1b_train_step

            make_1f1b_train_step(mesh, jcfg, jtcfg)
        else:
            JTrainer(jcfg, jtcfg, mesh, log_fn=lambda *_: None)
    assert str(got.value) == str(want.value)
