"""Adafactor: the port's against ``optax.adafactor(learning_rate=schedule)``
as the JAX package's ``make_optimizer`` builds it.

- The update alone, on the same gradients: three updates of a factored
  (130, 128) leaf, a 3-D leaf whose second-largest dim is under 128 and a
  vector, with and without ``clip_by_global_norm``, within 1e-5 of the
  movement (||port - optax|| / ||optax - init|| per leaf).
- Three train steps from converted JAX params against JAX
  ``make_train_step`` (``optimizer="adafactor"``; a decoder-only LM at d
  128, so the embedding, the FFN and the output kernels are factored),
  fp32, with and without ``max_grad_norm``: loss per step within 1e-5
  relative, every param within rtol 1e-5 of JAX's plus an atol of 1e-5
  of the summed learning rate (the key biases, whose gradient is rounding
  noise that the softmax cancels, within 2x the summed learning rate).
- The state's leaves have optax's names and shapes at d 128, factored and
  not; the optimizer state holds under half the parameter count (JAX's
  ``test_state_is_factored``).
- A JAX checkpoint of an Adafactor state restores in the port bit for
  bit, and the port's restores in JAX bit for bit.
- JAX's ``test_overfit_one_batch``: 60 steps of one batch take the loss
  below 0.6 of the first.
- The second-moment decay ``1 - (count + 1) ** -0.8`` equals jitted
  optax's bit for bit over the first 400 counts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from transformer_tpu.config import ModelConfig as JConfig
from transformer_tpu.config import TrainConfig as JTrain
from transformer_tpu.train.checkpoint import CheckpointManager as JManager
from transformer_tpu.train.checkpoint import _flatten as j_flatten
from transformer_tpu.train.state import create_train_state as j_create_state
from transformer_tpu.train.trainer import make_train_step as j_make_train_step
from transformer_tpu_torch.config import ModelConfig, TrainConfig
from transformer_tpu_torch.convert import params_from_numpy
from transformer_tpu_torch.models.transformer import flatten
from transformer_tpu_torch.train.checkpoint import CheckpointManager, snapshot
from transformer_tpu_torch.train.state import (
    Adafactor,
    AdafactorState,
    create_train_state,
    factored_dims,
)
from transformer_tpu_torch.train.trainer import make_train_step

VOCAB = 160
MODEL = dict(
    num_layers=1, d_model=128, num_heads=4, dff=256, input_vocab_size=VOCAB,
    target_vocab_size=VOCAB, max_position=32, decoder_only=True, dropout_rate=0.0,
    dtype="float32",
)
TRAIN = dict(batch_size=2, sequence_length=32, warmup_steps=4, lr_schedule="constant",
             peak_lr=1e-2, optimizer="adafactor")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _batches(n, seed=0, b=2, s=32):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tgt = rng.integers(1, VOCAB, size=(b, s)).astype(np.int32)
        tgt[1, s - 7:] = 0
        out.append(tgt)
    return out


@pytest.mark.parametrize("max_grad_norm", [0.0, 1.0], ids=["no_clip", "clip"])
def test_updates_match_optax(max_grad_norm):
    rng = np.random.default_rng(0)
    init = {"a": rng.standard_normal((130, 128)), "b": rng.standard_normal((128, 4, 32)),
            "c": rng.standard_normal((256,)) * 1e-4}
    init = {k: v.astype(np.float32) for k, v in init.items()}
    schedule = optax.linear_schedule(1e-3, 1e-2, 4)
    tx = optax.adafactor(learning_rate=schedule)
    if max_grad_norm:
        tx = optax.chain(optax.clip_by_global_norm(max_grad_norm), tx)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    js = tx.init(jp)
    update = jax.jit(tx.update)
    port = Adafactor(lambda c: float(schedule(c)), max_grad_norm)
    params = {k: torch.tensor(v) for k, v in init.items()}
    state = port.init(params)
    for _ in range(3):
        g = {k: (rng.standard_normal(v.shape) * 3).astype(np.float32) for k, v in init.items()}
        u, js = update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, u)
        state = port.step_(params, {k: torch.tensor(v) for k, v in g.items()}, state)
    assert state.count == 3
    for k in init:
        moved = np.asarray(jp[k]) - init[k]
        assert _rel(params[k].numpy() - init[k], moved) <= 1e-5, k


def _jax_run(train, batches):
    jcfg, jtcfg = JConfig(**MODEL), JTrain(**train)
    state = j_create_state(jax.random.PRNGKey(0), jcfg, jtcfg)
    init = {k: np.asarray(v) for k, v in j_flatten(state.params).items()}
    step = jax.jit(j_make_train_step(jcfg, jtcfg))
    losses = []
    for tgt in batches:
        state, m = step(state, jnp.asarray(tgt), jnp.asarray(tgt), jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    return init, losses, state


@pytest.mark.parametrize("max_grad_norm", [0.0, 0.5], ids=["no_clip", "clip"])
def test_train_steps_match_jax(max_grad_norm):
    train = {**TRAIN, "max_grad_norm": max_grad_norm}
    batches = _batches(3)
    init, want_losses, jstate = _jax_run(train, batches)
    cfg, tcfg = ModelConfig(**MODEL), TrainConfig(**train)
    state = create_train_state(cfg, tcfg, params=params_from_numpy(init, cfg, device="cpu"))
    step = make_train_step(cfg, tcfg)
    for tgt, want in zip(batches, want_losses):
        state, m = step(state, tgt, tgt)
        assert _rel(float(m["loss"]), want) <= 1e-5
    lr_sum = 3 * TRAIN["peak_lr"]
    want = j_flatten(jstate.params)
    factored = 0
    for key, p in flatten(state.params).items():
        got, w = p.detach().numpy(), np.asarray(want[key])
        factored += factored_dims(w.shape) is not None
        if key.endswith("self_mha/key/bias"):
            assert np.abs(got - w).max() <= 2 * lr_sum, key
        else:
            np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-5 * lr_sum, err_msg=key)
    assert factored == 4  # the embedding, the FFN's two kernels, the output kernel
    # ...and the optimizer state too.
    got_state = snapshot(state)
    for key, arr in j_flatten(jstate).items():
        if key.startswith("opt_state/") and arr.ndim and "self_mha/key" not in key:
            np.testing.assert_allclose(got_state[key], arr, rtol=1e-4, err_msg=key)


@pytest.mark.parametrize("max_grad_norm", [0.0, 1.0], ids=["no_clip", "clip"])
def test_state_names_and_shapes_are_optax(max_grad_norm):
    train = {**TRAIN, "max_grad_norm": max_grad_norm}
    jstate = j_create_state(jax.random.PRNGKey(0), JConfig(**MODEL), JTrain(**train))
    state = create_train_state(ModelConfig(**MODEL), TrainConfig(**train), device="cpu")
    assert isinstance(state.opt_state, AdafactorState)
    want, got = j_flatten(jstate), snapshot(state)
    assert sorted(got) == sorted(want)
    for key in want:
        assert np.shape(got[key]) == np.shape(want[key]), key
    prefix = "opt_state/1/0" if max_grad_norm else "opt_state/0"
    assert got[f"{prefix}/v_row/decoder/embedding/table"].shape == (128,)
    assert got[f"{prefix}/v_col/decoder/embedding/table"].shape == (VOCAB,)
    assert got[f"{prefix}/v/decoder/embedding/table"].shape == (1,)
    assert got[f"{prefix}/v/decoder/layers/0/self_mha/query/kernel"].shape == (128, 4, 32)


def test_state_is_factored():
    cfg = ModelConfig(num_layers=1, d_model=128, num_heads=4, dff=256, input_vocab_size=512,
                      target_vocab_size=512, max_position=32, dtype="float32", dropout_rate=0.0)
    base = dict(batch_size=4, sequence_length=8, warmup_steps=100)

    def elems(tensors):
        return sum(t.numel() for t in tensors)

    s_a = create_train_state(cfg, TrainConfig(**base), device="cpu")
    s_f = create_train_state(cfg, TrainConfig(**base, optimizer="adafactor"), device="cpu")
    n_params = elems(flatten(s_a.params).values())
    assert elems(s_a.opt_state.tensors()) >= 2 * n_params
    assert elems(s_f.opt_state.tensors()) < n_params / 2


def test_jax_checkpoint_restores_bit_for_bit_and_back(tmp_path):
    train = {**TRAIN, "max_grad_norm": 1.0}
    init, _, jstate = _jax_run(train, _batches(2, seed=4))
    JManager(str(tmp_path / "jax"), is_primary=True).save(jstate)
    cfg, tcfg = ModelConfig(**MODEL), TrainConfig(**train)
    template = create_train_state(cfg, tcfg, device="cpu")
    state = CheckpointManager(str(tmp_path / "jax")).restore_latest(template)
    want = j_flatten(jstate)
    got = snapshot(state)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].tobytes() == np.asarray(want[key]).tobytes(), key
    assert state.step == 2 and state.opt_state.count == 2
    # The port trains on and writes; JAX restores that bit for bit.
    state, _ = make_train_step(cfg, tcfg)(state, *(_batches(1, seed=5) * 2))
    CheckpointManager(str(tmp_path / "port")).save(state)
    restored = JManager(str(tmp_path / "port"), is_primary=True).restore_latest(
        j_create_state(jax.random.PRNGKey(1), JConfig(**MODEL), JTrain(**train)))
    back, mine = j_flatten(restored), snapshot(state)
    assert sorted(back) == sorted(mine)
    for key in mine:
        assert np.asarray(back[key]).tobytes() == mine[key].tobytes(), key


def test_overfit_one_batch():
    cfg = ModelConfig(num_layers=1, d_model=16, num_heads=2, dff=32, input_vocab_size=30,
                      target_vocab_size=30, max_position=32, dtype="float32", dropout_rate=0.0)
    tcfg = TrainConfig(batch_size=4, sequence_length=8, epochs=1, warmup_steps=20,
                       optimizer="adafactor")
    state = create_train_state(cfg, tcfg, device="cpu")
    step = make_train_step(cfg, tcfg)
    r = np.random.default_rng(0)
    src = r.integers(1, 28, (4, 8)).astype(np.int32)
    tgt = r.integers(1, 28, (4, 8)).astype(np.int32)
    first = None
    for _ in range(60):
        state, m = step(state, src, tgt)
        first = float(m["loss"]) if first is None else first
    assert float(m["loss"]) < first * 0.6


def test_factored_dims_follow_optax():
    from optax._src.factorized import _factored_dims

    for shape in [(128, 128), (130, 128), (128, 130), (512, 8, 64), (128, 4, 256),
                  (256,), (127, 4096), (200, 300, 400)]:
        assert factored_dims(shape) == _factored_dims(shape, True, 128), shape


def test_adafactor_update_needs_params():
    port = Adafactor(lambda c: 0.1)
    params = {"w": torch.ones(3)}
    with pytest.raises(ValueError, match="needs the params"):
        port.update({"w": torch.ones(3)}, port.init(params))
    assert dataclasses.replace(port.init(params), count=1).count == 1


def test_decay_matches_optax_bit_for_bit():
    from optax._src.factorized import _decay_rate_pow

    port = Adafactor(lambda c: 0.0)
    decay = jax.jit(lambda i: _decay_rate_pow(i, 0.8))
    for count in range(400):
        assert port.scalars(count)[0] == np.float32(decay(count)), count
