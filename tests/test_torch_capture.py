"""The helpers changed so that a CUDA graph can capture the train step
return what their earlier forms returned, bit for bit, on the CPU.

Each earlier form made a device tensor from a host scalar
(``torch.tensor(x, device=...)`` or ``torch.as_tensor``), a host-to-device
copy that a capture refuses or bakes in; each now fills on the device or
keeps an int on the host. Adam read its per-update scalars as Python floats
and built new moment tensors every step; it now reads them from a tensor
and moves the moments in place. The earlier forms are written out here.

- ``ops.masks.attention_bias``, ``ops.positional._angle_rates`` (through
  ``sinusoidal_rows``) and ``apply_rope``;
- ``models.encoder.embed_prologue`` at an int offset (0, 5, one past
  ``max_position``) and at per-row tensor offsets;
- ``train.state.Adam.update``, with and without clipping and as adamw,
  over three updates: updates and moments;
- the ``grad_accum_steps`` step's "batch" divisor (``train/trainer.py``):
  the step against the earlier form of that step;
- the dropout tape hands out generators that draw what a plain keyed
  generator draws, and refuses a key off the step's.
"""

import numpy as np
import pytest
import torch

from transformer_tpu_torch.config import ModelConfig, TrainConfig
from transformer_tpu_torch.models.encoder import embed_prologue
from transformer_tpu_torch.models.transformer import flatten
from transformer_tpu_torch.ops.masks import NEG_INF, attention_bias, make_padding_mask
from transformer_tpu_torch.ops.nn import (
    DropoutTape,
    dropout_generator,
    dropout_tape,
    embedding_lookup,
    key_seed,
)
from transformer_tpu_torch.ops.positional import apply_rope, sinusoidal_rows
from transformer_tpu_torch.train.state import Adam, create_train_state, decays, make_optimizer
from transformer_tpu_torch.train.trainer import _forward_loss, global_norm, make_train_step


def test_attention_bias_unchanged():
    ids = torch.tensor([[3, 4, 0, 0], [1, 0, 2, 0]])
    mask = make_padding_mask(ids)
    for dtype in (torch.float32, torch.bfloat16):
        old = torch.where(mask, torch.zeros((), dtype=dtype),
                          torch.tensor(NEG_INF, dtype=dtype))
        got = attention_bias(mask, dtype)
        assert got.dtype == old.dtype and torch.equal(got, old)


def _old_angle_rates(d_model):
    channels = torch.arange(d_model, dtype=torch.float32)[None, :]
    return torch.pow(torch.tensor(10000.0, dtype=torch.float32),
                     -(2.0 * torch.floor(channels / 2.0)) / d_model)


def test_sinusoidal_rows_and_rope_unchanged():
    positions = torch.arange(37)[None, :] + torch.tensor([[0], [9]])
    angles = positions.float()[..., None] * _old_angle_rates(64).reshape(-1)
    old = torch.cat([torch.sin(angles[..., 0::2]), torch.cos(angles[..., 1::2])], dim=-1)
    assert torch.equal(sinusoidal_rows(positions, 64), old)

    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 37, 4, 16)).astype(np.float32))
    half = 8
    inv_freq = torch.pow(torch.tensor(10000.0, dtype=torch.float32),
                         -torch.arange(0, half, dtype=torch.float32) / half)
    ang = positions.float()[..., None] * inv_freq
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    old = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    assert torch.equal(apply_rope(x, positions), old)


@pytest.mark.parametrize("offset", [0, 5, 40, "rows"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_prologue_unchanged(offset, dtype):
    cfg = ModelConfig(num_layers=1, d_model=32, num_heads=4, dff=64, input_vocab_size=50,
                      target_vocab_size=50, max_position=32, dtype=dtype)
    table = {"table": torch.from_numpy(
        np.random.default_rng(1).standard_normal((50, 32)).astype(np.float32))}
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, 50, (3, 7)))
    if offset == "rows":
        offset = torch.tensor([0, 3, 30])
    x = embedding_lookup(table, ids, cfg.compute_dtype)
    x = x * torch.tensor(cfg.d_model**0.5, dtype=cfg.compute_dtype)
    off = torch.clamp(torch.as_tensor(offset).long(), 0, cfg.max_position).reshape(-1, 1)
    old = x + sinusoidal_rows(off + torch.arange(7)[None, :], 32, cfg.compute_dtype)
    assert torch.equal(embed_prologue(table, ids, cfg, offset), old)


def _old_adam_update(tx, grads, mu, nu, count, params):
    """``Adam.update`` before it read its scalars from a tensor."""
    if tx.max_grad_norm > 0:
        g_norm = global_norm(grads.values())
        keep = g_norm < tx.max_grad_norm
        grads = {k: torch.where(keep, g, (g / g_norm) * tx.max_grad_norm)
                 for k, g in grads.items()}
    n = count + 1
    one = torch.tensor(1.0, dtype=torch.float32)
    bc1 = float(one - torch.tensor(tx.b1, dtype=torch.float32) ** n)
    bc2 = float(one - torch.tensor(tx.b2, dtype=torch.float32) ** n)
    step_size = -tx.schedule(count)
    new_mu, new_nu, updates = {}, {}, {}
    for k, g in grads.items():
        new_mu[k] = (1 - tx.b1) * g + tx.b1 * mu[k]
        new_nu[k] = (1 - tx.b2) * (g * g) + tx.b2 * nu[k]
        u = (new_mu[k] / bc1) / (torch.sqrt(new_nu[k] / bc2) + tx.eps)
        if tx.adamw and decays(k, params[k]):
            u = u + tx.weight_decay * params[k]
        updates[k] = step_size * u
    return updates, new_mu, new_nu


@pytest.mark.parametrize("kind", ["adam", "clipped", "adamw"])
def test_adam_update_unchanged(kind):
    tx = Adam(lambda s: 1e-3 * (s + 1), 0.9, 0.98, 1e-9,
              max_grad_norm=0.5 if kind == "clipped" else 0.0,
              weight_decay=0.01 if kind == "adamw" else 0.0, adamw=kind == "adamw")
    rng = np.random.default_rng(3)
    params = {"w/kernel": torch.from_numpy(rng.standard_normal((4, 5)).astype(np.float32)),
              "w/bias": torch.from_numpy(rng.standard_normal((5,)).astype(np.float32))}
    state = tx.init(params)
    mu = {k: v.clone() for k, v in state.mu.items()}
    nu = {k: v.clone() for k, v in state.nu.items()}
    for step in range(3):
        grads = {k: torch.from_numpy((rng.standard_normal(v.shape) * 10 ** (step - 1))
                                     .astype(np.float32)) for k, v in params.items()}
        want, mu, nu = _old_adam_update(tx, grads, mu, nu, step, params)
        got, state = tx.update(grads, state, params)
        assert state.count == step + 1
        for k in params:
            assert torch.equal(got[k], want[k]), (step, k)
            assert torch.equal(state.mu[k], mu[k]) and torch.equal(state.nu[k], nu[k]), (step, k)


def test_grad_accum_batch_divisor_unchanged():
    cfg = ModelConfig(num_layers=1, d_model=32, num_heads=4, dff=64, input_vocab_size=40,
                      target_vocab_size=40, max_position=32, dtype="float32")
    tcfg = TrainConfig(batch_size=4, sequence_length=16, warmup_steps=4, grad_accum_steps=2,
                       loss_normalization="batch")
    rng = np.random.default_rng(4)
    src = rng.integers(1, 40, (4, 16)).astype(np.int32)
    tgt = rng.integers(1, 40, (4, 16)).astype(np.int32)
    tgt[1, 9:] = 0

    new = create_train_state(cfg, tcfg, device="cpu")
    new, metrics = make_train_step(cfg, tcfg)(new, src, tgt)

    old = create_train_state(cfg, tcfg, device="cpu")  # the same init, from the seed
    leaves = flatten(old.params)
    s, t = torch.from_numpy(src).long(), torch.from_numpy(tgt).long()
    grads, loss_sum = None, 0.0
    for i in range(2):
        rows = slice(2 * i, 2 * i + 2)
        _, m = _forward_loss(old.params, t[rows], cfg, tcfg, (tcfg.seed, 0, i), src=s[rows])
        g = torch.autograd.grad(m["loss_sum"], list(leaves.values()))
        grads = list(g) if grads is None else [a + b for a, b in zip(grads, g)]
        loss_sum = m["loss_sum"].detach() + loss_sum
    denom = torch.tensor(float(tcfg.batch_size))  # the earlier divisor
    grads = {k: g / denom for k, g in zip(leaves, grads)}
    updates, _ = make_optimizer(cfg, tcfg).update(grads, old.opt_state, leaves)
    with torch.no_grad():
        for k, p in leaves.items():
            p.add_(updates[k])
    for (k, a), b in zip(flatten(new.params).items(), leaves.values()):
        assert torch.equal(a, b), k
    assert torch.equal(metrics["loss"], loss_sum / denom)


def test_dropout_tape_draws_the_keyed_generators_masks():
    base = (0, 7)
    tape = DropoutTape(base)
    with dropout_tape(tape):
        g = dropout_generator(base + (1, 2), "cpu")
        with pytest.raises(ValueError, match="does not extend"):
            dropout_generator((0, 8, 1), "cpu")
    assert tape.suffixes == [(1, 2)]
    want = torch.rand(5, generator=torch.Generator().manual_seed(key_seed(base + (1, 2))))
    assert torch.equal(torch.rand(5, generator=g), want)
    assert torch.equal(
        torch.rand(5, generator=dropout_generator(base + (1, 2), "cpu")), want
    )  # outside the tape: a plain keyed generator
