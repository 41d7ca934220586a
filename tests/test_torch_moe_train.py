"""MoE models and trainers: the port against the JAX package on the CPU.

Tiny fp32 models (2 layers, d 32, 4 heads, dff 64, E 4, top-2), weights
converted from a JAX init (``convert.params_from_numpy``):

- the forward and the summed aux of the three families (seq2seq,
  decoder-only, encoder-only MLM) at ``moe_every`` 1 and 2: logits within
  1e-5, aux within 1e-6, the maps' ``moe_aux_encoder`` /
  ``moe_aux_decoder`` keys as JAX returns them;
- three ``make_train_step`` steps against JAX's, one process and
  ``grad_accum_steps=2``: loss and ``moe_aux`` within 1e-5 relative,
  parameters within 1e-5 of the summed learning rate on average and
  1e-2 at worst (the key biases, whose gradient is rounding noise,
  within 2x it), as the dense parity tests hold them;
- in the port alone, bit-identical: remat on against off, the K-step
  dispatch against K eager steps (and its ``moe_aux`` the token-weighted
  mean), a resumed run against an uninterrupted one;
- ``--dp 2`` over gloo processes against JAX's single-program step on the
  same global batch (the aux's statistics are the global batch's): loss
  and ``moe_aux`` within 1e-5 relative, the parameters within 1e-6 of the
  summed learning rate on average (1e-3 at worst) of the one-process
  port's, which the steps above hold to JAX's;
- Adafactor's factored state on the (E, d, dff) leaves against optax's;
  checkpoints (Adam and Adafactor) across the packages both ways, byte
  for byte;
- the int8 export of a MoE model byte-identical to JAX's
  ``_quantize_leaf``; the per-expert glorot init's scale;
- ``cli.train --moe_experts`` trains, reports ``moe_aux`` and exports.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_ring_attention import join_job
from transformer_tpu.config import ModelConfig as JConfig
from transformer_tpu.config import TrainConfig as JTrain
from transformer_tpu.models import transformer_apply as j_transformer_apply
from transformer_tpu.train.checkpoint import _flatten, _quantize_leaf as j_quantize_leaf
from transformer_tpu.train.state import create_train_state as j_create_state
from transformer_tpu.train.trainer import make_train_step as j_make_train_step
from transformer_tpu_torch.config import MeshConfig, ModelConfig, TrainConfig
from transformer_tpu_torch.convert import params_from_numpy
from transformer_tpu_torch.models.transformer import (
    flatten,
    init_params,
    param_spec,
    transformer_apply,
)
from transformer_tpu_torch.parallel.mesh import make_mesh
from transformer_tpu_torch.train.checkpoint import CheckpointManager, export_params, snapshot
from transformer_tpu_torch.train.state import Adafactor, create_train_state
from transformer_tpu_torch.train.trainer import (
    Trainer,
    make_multistep_train_step,
    make_train_step,
)

VOCAB = 64
BASE = dict(
    num_layers=2, d_model=32, num_heads=4, dff=64, input_vocab_size=VOCAB,
    target_vocab_size=VOCAB, max_position=32, dropout_rate=0.0, dtype="float32",
    moe_experts=4, moe_top_k=2, moe_capacity_factor=1.25,
)
FAMILIES = {
    "decoder_only": dict(decoder_only=True),
    "seq2seq": dict(),
    "encoder_only": dict(encoder_only=True, tie_output=True),
}
LM = {**BASE, "decoder_only": True, "attention_impl": "flash", "moe_every": 2}
TRAIN = dict(batch_size=4, sequence_length=16, warmup_steps=4)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _ids(seed, b=4, s=16, pad_tail=5):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, VOCAB - 1, size=(b, s)).astype(np.int32)
    ids[1, s - pad_tail:] = 0
    ids[3, s - 2:] = 0
    return ids


def _jax_init(model, seed=0):
    jcfg = JConfig(**model)
    state = j_create_state(jax.random.PRNGKey(seed), jcfg, JTrain(**TRAIN))
    return state, _flatten(state.params)


def _port(init, model):
    return params_from_numpy(init, ModelConfig(**model), device="cpu")


def _jax_aux(attn):
    return float(attn.get("moe_aux_encoder", 0.0) + attn.get("moe_aux_decoder", 0.0))


# --------------------------------------------------------------------------
# forwards


@pytest.mark.parametrize("every", [1, 2])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_and_aux_match_jax(family, every):
    model = {**BASE, **FAMILIES[family], "moe_every": every}
    _, init = _jax_init(model)
    src, tgt = _ids(1, s=12, pad_tail=4), _ids(2)
    jsrc = None if family != "seq2seq" else jnp.asarray(src)
    want, attn = j_transformer_apply(jax.tree.map(jnp.asarray, _port_unflat(init)), jsrc,
                                     jnp.asarray(tgt), JConfig(**model))
    cfg = ModelConfig(**model)
    params = _port(init, model)
    tsrc = None if family != "seq2seq" else torch.from_numpy(src).long()
    got, aux = transformer_apply(params, tsrc, torch.from_numpy(tgt).long(), cfg, return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert abs(float(aux) - _jax_aux(attn)) <= 1e-6
    # The maps carry JAX's keys.
    _, maps = transformer_apply(params, tsrc, torch.from_numpy(tgt).long(), cfg,
                                return_weights=True)
    assert {k for k in maps if k.startswith("moe_aux")} == \
        {k for k in attn if k.startswith("moe_aux")}
    n_moe = sum(1 for k in param_spec(cfg) if k.endswith("moe/router/kernel"))
    towers = 1 if family != "seq2seq" else 2
    assert n_moe == towers * (2 if every == 1 else 1)
    assert not any("/ffn/" in k for k in param_spec(cfg)) or every == 2


def _port_unflat(init):
    from transformer_tpu_torch.models.transformer import unflatten

    return unflatten(init)


# --------------------------------------------------------------------------
# train steps against JAX


def _jax_steps(model, train, batches, srcs=None):
    state, init = _jax_init(model)
    step = jax.jit(j_make_train_step(JConfig(**model), JTrain(**train)))
    rng = jax.random.PRNGKey(0)
    losses, auxes = [], []
    for i, tgt in enumerate(batches):
        src = tgt if srcs is None else srcs[i]
        state, m = step(state, jnp.asarray(src), jnp.asarray(tgt), rng)
        losses.append(float(m["loss"]))
        auxes.append(float(m["moe_aux"]))
    return init, losses, auxes, _flatten(state.params)


def _port_steps(model, train, init, batches, srcs=None):
    cfg, tcfg = ModelConfig(**model), TrainConfig(**train)
    state = create_train_state(cfg, tcfg, params=_port(init, model))
    step = make_train_step(cfg, tcfg)
    losses, auxes = [], []
    for i, tgt in enumerate(batches):
        state, m = step(state, tgt if srcs is None else srcs[i], tgt)
        losses.append(float(m["loss"]))
        auxes.append(float(m["moe_aux"]))
    return state, losses, auxes


def _check_params(state, want_params, model, steps=3):
    from transformer_tpu.train.schedule import noam_schedule as j_noam

    sched = j_noam(model["d_model"], TRAIN["warmup_steps"])
    lr_sum = sum(float(sched(s)) for s in range(steps))
    for key, p in flatten(state.params).items():
        diff = np.abs(p.detach().numpy() - np.asarray(want_params[key])) / lr_sum
        assert diff.max() <= 2.0, key
        if not key.endswith("mha/key/bias"):
            assert diff.mean() <= 1e-5 and diff.max() <= 1e-2, (key, diff.mean(), diff.max())


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("family", ["decoder_only", "seq2seq"])
def test_train_steps_match_jax(family, accum):
    model = {**BASE, **FAMILIES[family], "moe_every": 1, "attention_impl": "flash"}
    train = {**TRAIN, "grad_accum_steps": accum}
    batches = [_ids(10 + i) for i in range(3)]
    srcs = None if family != "seq2seq" else [_ids(20 + i, s=12, pad_tail=3) for i in range(3)]
    init, want_l, want_a, want_p = _jax_steps(model, train, batches, srcs)
    state, losses, auxes = _port_steps(model, train, init, batches, srcs)
    for g, w in zip(losses, want_l):
        assert _rel(g, w) <= 1e-5, (losses, want_l)
    for g, w in zip(auxes, want_a):
        assert _rel(g, w) <= 1e-5, (auxes, want_a)
    _check_params(state, want_p, model)


def test_mlm_train_steps_match_jax():
    from transformer_tpu_torch.train import trainer as trainer_mod

    model = {**BASE, **FAMILIES["encoder_only"], "moe_every": 2, "input_vocab_size": VOCAB,
             "target_vocab_size": VOCAB}
    train = {**TRAIN, "objective": "mlm", "lr_schedule": "constant", "peak_lr": 3e-3}
    jcfg, jtcfg = JConfig(**model), JTrain(**train)
    state, init = _jax_init(model)
    step = jax.jit(j_make_train_step(jcfg, jtcfg))
    batch = _ids(30)
    state, jm = step(state, jnp.asarray(batch), jnp.asarray(batch), jax.random.PRNGKey(0))
    # The port on JAX's masked batch (the two packages draw different masks).
    from transformer_tpu.train.trainer import _prepare_batch as j_prepare

    j_inp, j_lab, _ = j_prepare(jcfg, jtcfg, jnp.asarray(batch),
                                jax.random.fold_in(jax.random.PRNGKey(0), 0))
    cfg, tcfg = ModelConfig(**model), TrainConfig(**train)
    pstate = create_train_state(cfg, tcfg, params=_port(init, model))
    orig = trainer_mod._prepare_batch
    trainer_mod._prepare_batch = lambda *a: (torch.from_numpy(np.asarray(j_inp)).long(),
                                             torch.from_numpy(np.asarray(j_lab)).long(), None)
    try:
        pstate, m = make_train_step(cfg, tcfg)(pstate, None, batch)
    finally:
        trainer_mod._prepare_batch = orig
    assert _rel(float(m["loss"]), float(jm["loss"])) <= 1e-5
    assert _rel(float(m["moe_aux"]), float(jm["moe_aux"])) <= 1e-5


# --------------------------------------------------------------------------
# the port's own bit-identities


def _lm_state(model=LM, train=TRAIN, seed=0):
    _, init = _jax_init(model, seed)
    cfg, tcfg = ModelConfig(**model), TrainConfig(**train)
    return cfg, tcfg, create_train_state(cfg, tcfg, params=_port(init, model))


def test_remat_on_equals_off_bit_for_bit():
    out = []
    for remat in (False, True):
        model = {**LM, "remat": remat, "dropout_rate": 0.1}
        cfg, tcfg, state = _lm_state(model)
        step = make_train_step(cfg, tcfg)
        for tgt in [_ids(40 + i) for i in range(2)]:
            state, m = step(state, tgt, tgt)
        out.append((flatten(state.params), m))
    (pa, ma), (pb, mb) = out
    assert torch.equal(ma["moe_aux"], mb["moe_aux"]) and torch.equal(ma["loss"], mb["loss"])
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k


def test_multistep_equals_eager_steps_bit_for_bit():
    batches = [_ids(50 + i) for i in range(3)]
    cfg, tcfg, eager = _lm_state({**LM, "dropout_rate": 0.1})
    step = make_train_step(cfg, tcfg)
    ms, ws = [], []
    for tgt in batches:
        eager, m = step(eager, tgt, tgt)
        ms.append(float(m["moe_aux"]))
        ws.append(float(m["weight"]))
    _, _, multi = _lm_state({**LM, "dropout_rate": 0.1})
    run = make_multistep_train_step(make_train_step(cfg, tcfg), tcfg.loss_normalization,
                                    tcfg.batch_size)
    multi, m = run(multi, np.stack(batches), np.stack(batches))
    for k, p in flatten(eager.params).items():
        assert torch.equal(p, flatten(multi.params)[k]), k
    want = sum(a * w for a, w in zip(ms, ws)) / sum(ws)  # token-weighted
    assert float(m["moe_aux"]) == pytest.approx(want, rel=1e-6)


class _Batches:
    def __init__(self, n=3):
        self.data = [(b, b) for b in (_ids(60 + i) for i in range(n))]

    def __len__(self):
        return len(self.data)

    def batches(self, epoch=0):
        order = np.random.default_rng([0, epoch]).permutation(len(self.data))
        for j in order:
            yield self.data[j]


def _fit(epochs, ckpt):
    model = {**LM, "dropout_rate": 0.1}
    cfg = ModelConfig(**model)
    tcfg = TrainConfig(**{**TRAIN, "epochs": epochs, "eval_every_steps": 0,
                          "log_every_steps": 1})
    logs = []
    trainer = Trainer(cfg, tcfg, create_train_state(cfg, tcfg, device="cpu"),
                      log_fn=logs.append, checkpoint=ckpt)
    trainer.fit(_Batches(), None)
    return trainer, logs


def test_resumed_run_equals_uninterrupted(tmp_path):
    from transformer_tpu_torch.convert import params_digest

    whole, logs = _fit(2, CheckpointManager(str(tmp_path / "u")))
    _fit(1, CheckpointManager(str(tmp_path / "r")))
    resumed, _ = _fit(2, CheckpointManager(str(tmp_path / "r")))
    assert resumed.state.step == whole.state.step == 6
    assert params_digest(resumed.state.params) == params_digest(whole.state.params)
    assert any(" moe_aux " in line for line in logs)
    assert whole.train_metrics.moe_aux is not None


# --------------------------------------------------------------------------
# --dp 2


ACCUMS = [1, 2]


def _dp_worker(rank, world, port, init, batches, out_dir):
    """Three ``--dp 2`` steps at each of ``ACCUMS`` in turn on one process
    group, written by rank 0 to ``dp<accum>.npz``."""
    from transformer_tpu_torch.parallel.distributed import DistributedTrainer

    process = join_job(rank, world, port)
    for accum in ACCUMS:
        mesh = make_mesh(MeshConfig(data=world), process)
        model = {**LM, "moe_every": 1}
        cfg, tcfg = ModelConfig(**model), TrainConfig(**TRAIN, grad_accum_steps=accum)
        state = create_train_state(cfg, tcfg, params=_port(init, model))
        trainer = DistributedTrainer(cfg, tcfg, mesh, state=state, log_fn=lambda *_: None)
        losses, auxes = [], []
        for tgt in batches:
            trainer.state, m = trainer.train_step(trainer.state, tgt, tgt)
            losses.append(float(m["loss"]))
            auxes.append(float(m["moe_aux"]))
        params = {k: v.detach().numpy() for k, v in flatten(trainer.state.params).items()}
        if rank == 0:
            np.savez(os.path.join(out_dir, f"dp{accum}.npz"), losses=losses, auxes=auxes,
                     **params)
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """The ``--dp 2`` runs of every ``ACCUMS`` value, one spawn, and beside
    it (while its processes run) the JAX steps and the one-process port's
    of each: {accum: (the run, the JAX steps, the port's state)}."""
    from torch_pipeline_jobs import finish, start

    out = tmp_path_factory.mktemp("dp")
    model = {**LM, "moe_every": 1}
    _, init = _jax_init(model)
    batches = [_ids(70 + i) for i in range(3)]
    handle = start(_dp_worker, 2, init, batches, str(out))
    refs = {}
    for accum in ACCUMS:
        train = {**TRAIN, "grad_accum_steps": accum}
        steps = _jax_steps(model, train, batches)
        refs[accum] = (steps, _port_steps(model, train, steps[0], batches)[0])
    finish(handle)
    return {accum: (np.load(out / f"dp{accum}.npz"), *refs[accum]) for accum in ACCUMS}


@pytest.mark.parametrize("accum", ACCUMS)
def test_dp2_matches_jax_single_program(dp_runs, accum):
    model = {**LM, "moe_every": 1}
    got, (init, want_l, want_a, want_p), state = dp_runs[accum]
    for g, w in zip(got["losses"], want_l):
        assert _rel(g, w) <= 1e-5, (list(got["losses"]), want_l)
    for g, w in zip(got["auxes"], want_a):
        assert _rel(g, w) <= 1e-5, (list(got["auxes"]), want_a)
    # The parameters: the one-process port's (which the test above holds
    # to JAX's), up to the rounding of the sum over processes.
    from transformer_tpu.train.schedule import noam_schedule as j_noam

    lr_sum = sum(float(j_noam(model["d_model"], TRAIN["warmup_steps"])(s)) for s in range(3))
    for key, p in flatten(state.params).items():
        diff = np.abs(got[key] - p.detach().numpy()) / lr_sum
        assert diff.max() <= 2.0, key
        if not key.endswith("mha/key/bias"):
            assert diff.mean() <= 1e-6 and diff.max() <= 1e-3, (key, diff.mean(), diff.max())


# --------------------------------------------------------------------------
# optimizer, export, init


def test_adafactor_state_and_update_on_expert_leaves_match_optax():
    rng = np.random.default_rng(3)
    params = {"moe/in/kernel": rng.standard_normal((8, 128, 256)).astype(np.float32),
              "moe/out/kernel": rng.standard_normal((8, 256, 128)).astype(np.float32),
              "moe/in/bias": rng.standard_normal((8, 256)).astype(np.float32)}
    jtx = optax.adafactor(learning_rate=1e-2)
    jstate = jtx.init({k: jnp.asarray(v) for k, v in params.items()})
    tx = Adafactor(lambda count: 1e-2)
    state = tx.init({k: torch.from_numpy(v.copy()) for k, v in params.items()})
    fac = jstate[0] if not hasattr(jstate, "v_row") else jstate
    jfac = next(s for s in jax.tree.leaves(jstate, is_leaf=lambda s: hasattr(s, "v_row"))
                if hasattr(s, "v_row"))
    for k in params:
        assert tuple(state.v_row[k].shape) == tuple(jfac.v_row[k].shape), k
        assert tuple(state.v_col[k].shape) == tuple(jfac.v_col[k].shape), k
        assert tuple(state.v[k].shape) == tuple(jfac.v[k].shape), k
    del fac
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    for _ in range(2):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        jup, jstate = jtx.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate,
                                 {k: jnp.asarray(v) for k, v in params.items()})
        up, state = tx.update({k: torch.from_numpy(v) for k, v in grads.items()}, state,
                              tparams)
        for k in params:
            np.testing.assert_allclose(up[k].numpy(), np.asarray(jup[k]), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("opt", ["adam", "adafactor"])
def test_checkpoints_cross_both_ways_byte_for_byte(tmp_path, opt):
    """The MoE leaves under JAX's on-disk names: a port checkpoint
    restores through JAX's ``restore_latest`` and a JAX one through the
    port's, byte for byte (params and the optimizer's state)."""
    from transformer_tpu.train.checkpoint import CheckpointManager as JManager

    model = {**LM, "moe_every": 1}
    train = {**TRAIN, **({"optimizer": "adafactor", "lr_schedule": "constant",
                          "peak_lr": 1e-3} if opt == "adafactor" else {})}
    jcfg, jtcfg = JConfig(**model), JTrain(**train)
    jstate = j_create_state(jax.random.PRNGKey(0), jcfg, jtcfg)
    jstate, _ = jax.jit(j_make_train_step(jcfg, jtcfg))(
        jstate, jnp.asarray(_ids(80)), jnp.asarray(_ids(80)), jax.random.PRNGKey(0))
    JManager(str(tmp_path / "jax"), is_primary=True).save(jstate)
    cfg, tcfg = ModelConfig(**model), TrainConfig(**train)
    state = CheckpointManager(str(tmp_path / "jax")).restore_latest(
        create_train_state(cfg, tcfg, device="cpu"))
    got, want = snapshot(state), _flatten(jstate)
    assert sorted(got) == sorted(want) and any("/moe/in/kernel" in k for k in want)
    for key in want:
        assert np.asarray(got[key]).tobytes() == np.asarray(want[key]).tobytes(), key
    state, _ = make_train_step(cfg, tcfg)(state, _ids(81), _ids(81))
    CheckpointManager(str(tmp_path / "port")).save(state)
    back = JManager(str(tmp_path / "port"), is_primary=True).restore_latest(
        j_create_state(jax.random.PRNGKey(1), jcfg, jtcfg))
    for key, arr in snapshot(state).items():
        assert np.asarray(_flatten(back)[key]).tobytes() == np.asarray(arr).tobytes(), key


def test_int8_export_of_a_moe_model_is_jax_bytes(tmp_path):
    import zipfile

    from transformer_tpu.train.checkpoint import export_params as j_export
    from transformer_tpu_torch.convert import params_to_numpy

    model = {**LM, "d_model": 64, "dff": 256, "num_heads": 4, "moe_experts": 8}
    jstate, init = _jax_init(model)
    params = _port(init, model)
    assert all(np.asarray(init[k]).tobytes() == v.tobytes()
               for k, v in params_to_numpy(params).items())  # numpy -> port -> numpy
    export_params(params, ModelConfig(**model), str(tmp_path), quantize="int8")
    j_export(jstate.params, JConfig(**model), str(tmp_path / "jax"), quantize="int8")
    with zipfile.ZipFile(tmp_path / "params.npz") as zp, \
            zipfile.ZipFile(tmp_path / "jax" / "params.npz") as zj:
        assert sorted(zp.namelist()) == sorted(zj.namelist())
        for name in zj.namelist():
            assert zp.read(name) == zj.read(name), name
    with np.load(tmp_path / "params.npz") as data:
        got = {k: data[k] for k in data.files}
    for key, w in init.items():
        want = j_quantize_leaf(key, np.asarray(w))
        if want is None:
            assert np.array_equal(got[key], np.asarray(w)), key
            continue
        for k2, arr in want.items():
            assert got[k2].dtype == arr.dtype and got[k2].tobytes() == arr.tobytes(), k2
    # (8, 64, 256): prod(shape[:-2]) = 8 < 16, one scale per output column.
    scale = got["decoder/layers/1/moe/in/kernel::q8scale"]
    assert scale.shape == (1, 1, 256)


def test_init_params_draws_each_expert_with_its_own_fans():
    cfg = ModelConfig(**{**LM, "d_model": 64, "dff": 256, "moe_experts": 8})
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    w = params["decoder"]["layers"][1]["moe"]["in"]["kernel"]
    limit = (6.0 / (64 + 256)) ** 0.5
    assert w.shape == (8, 64, 256) and float(w.abs().max()) <= limit
    assert float(w.std()) == pytest.approx(limit / 3 ** 0.5, rel=0.02)
    router = params["decoder"]["layers"][1]["moe"]["router"]["kernel"]
    assert float(router.abs().max()) <= (6.0 / (64 + 8)) ** 0.5
    assert "ffn" in params["decoder"]["layers"][0] and "ffn" not in params["decoder"]["layers"][1]


# --------------------------------------------------------------------------
# the CLI


def test_cli_train_with_moe_experts(tmp_path):
    from transformer_tpu_torch.cli import train

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for split, n in (("train", 120), ("test", 30)):
        for side in ("src", "tgt"):
            with open(os.path.join(root, "data", f"{side}-{split}.txt"), encoding="utf-8") as f:
                head = [next(f) for _ in range(n)]
            (tmp_path / f"{side}-{split}.txt").write_text("".join(head), encoding="utf-8")
    logs = []
    trainer = train.main([
        "--device=cpu", "--decoder_only", "--dataset_path", str(tmp_path),
        "--tgt_vocab_file", str(tmp_path / "v.subwords"), "--target_vocab_size=300",
        "--num_layers=2", "--d_model=32", "--dff=64", "--num_heads=4",
        "--sequence_length=32", "--batch_size=4", "--epochs=1",
        "--moe_experts=4", "--moe_every=2", "--ckpt_path", str(tmp_path / "ckpt"),
        "--export_path", str(tmp_path / "export"),
    ], log_fn=logs.append)
    assert trainer.model_cfg.moe_experts == 4
    assert 0.5 < trainer.train_metrics.moe_aux < 4.0
    from transformer_tpu_torch.convert import load_export

    params, cfg = load_export(str(tmp_path / "export"), device="cpu")
    assert cfg.moe_experts == 4 and "moe" in params["decoder"]["layers"][1]


def test_dataclass_replace_keeps_moe():
    cfg = dataclasses.replace(ModelConfig(**LM), remat=True)
    assert cfg.moe_experts == 4 and cfg.moe_every == 2
