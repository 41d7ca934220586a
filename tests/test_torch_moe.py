"""The Mixture-of-Experts op: the port's ``ops/moe.py`` against the JAX
package's ``transformer_tpu/ops/moe.py`` on the CPU.

Inputs come from a numpy seed; fp32 at E 4, k 2, d 32, dff 64, B 2, S 10
unless a case says otherwise:

- outputs within 1e-5, the aux loss within 1e-6;
- the routing identical: the top-k indices (``jax.lax.top_k``'s order),
  the slot positions and the kept/dropped mask, against the JAX twin's
  bookkeeping (its one-hot loop, restated here in jax.numpy line for line,
  since ``moe_apply`` returns only y and the aux);
- gradients (``jax.grad`` against torch autograd) for x, the router, and
  the in and out stacks, within 1e-5;
- the cases: capacity overflow (factor 0.5), a token mask with PADs, a
  zero router kernel (every probability equal: the tie order), a
  collapsed router against a balanced one, a bf16 compute dtype (2e-2),
  one expert equal to the dense FFN, and ``expert_capacity`` over a grid;
- the backward is bit-reproducible, and a choice whose gate is 0 uses up
  its slot but dispatches nothing.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_tpu.ops.moe import expert_capacity as j_expert_capacity
from transformer_tpu.ops.moe import moe_apply as j_moe_apply
from transformer_tpu_torch.ops import moe as moe_mod
from transformer_tpu_torch.ops.ffn import ffn_apply
from transformer_tpu_torch.ops.moe import expert_capacity, moe_apply, moe_init, moe_route

E, K, D, DFF, B, S = 4, 2, 32, 64, 2, 10


def _params(seed: int, e=E, d=D, dff=DFF, router_scale=1.0):
    rng = np.random.default_rng(seed)
    return {
        "router": {"kernel": (rng.standard_normal((d, e)) * router_scale).astype(np.float32)},
        "in": {"kernel": (rng.standard_normal((e, d, dff)) / math.sqrt(d)).astype(np.float32),
               "bias": (rng.standard_normal((e, dff)) * 0.1).astype(np.float32)},
        "out": {"kernel": (rng.standard_normal((e, dff, d)) / math.sqrt(dff)).astype(np.float32),
                "bias": (rng.standard_normal((e, d)) * 0.1).astype(np.float32)},
    }


def _x(seed: int, b=B, s=S, d=D):
    return np.random.default_rng(seed + 100).standard_normal((b, s, d)).astype(np.float32)


def _to_jax(tree, dtype=None):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype) if dtype else jnp.asarray(a), tree)


def _to_torch(tree, requires_grad=False):
    def leaf(a):
        t = torch.from_numpy(np.array(a))
        return t.requires_grad_(requires_grad)

    return jax.tree.map(leaf, tree)


def _jax_routing(params, x, k, cf, token_mask=None):
    """The twin's routing bookkeeping (``transformer_tpu/ops/moe.py``
    lines 139-175), returning (indices, positions, fits) per choice."""
    b, s, _ = x.shape
    e = params["router"]["kernel"].shape[1]
    c = j_expert_capacity(s, e, k, cf)
    logits = jnp.einsum("bsm,me->bse", x.astype(jnp.float32),
                        params["router"]["kernel"].astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    live = None if token_mask is None else jnp.broadcast_to(token_mask.astype(jnp.float32), (b, s))
    _, indices = jax.lax.top_k(probs, k)
    counts = jnp.zeros((b, e), jnp.float32)
    positions, fits_all = [], []
    for j in range(k):
        oh = jax.nn.one_hot(indices[..., j], e, dtype=jnp.float32)
        if live is not None:
            oh = oh * live[..., None]
        pos = jnp.cumsum(oh, axis=1) - oh + counts[:, None, :]
        pos_j = jnp.sum(pos * oh, axis=-1)
        fits = (pos_j < c).astype(jnp.float32) * jnp.sum(oh, axis=-1)
        counts = counts + jnp.sum(oh * fits[..., None], axis=1)
        positions.append(pos_j)
        fits_all.append(fits)
    return (np.asarray(indices), np.stack([np.asarray(p) for p in positions], -1).astype(np.int64),
            np.stack([np.asarray(f) for f in fits_all], -1) > 0)


CASES = {
    "base": dict(),
    "overflow": dict(cf=0.5),
    "pads": dict(mask=True),
    "zero_router": dict(router_scale=0.0),
    "collapsed": dict(collapse=True),
    "top1": dict(k=1),
    "top3": dict(k=3),
}


def _case(name):
    c = CASES[name]
    params = _params(1, router_scale=c.get("router_scale", 1.0))
    if c.get("collapse"):
        # Expert 2 wins everywhere by a logit margin of about 6, which keeps
        # every probability a normal fp32 number (XLA on the CPU flushes
        # subnormals to zero, torch keeps them, which would reorder ties).
        params["router"]["kernel"] *= 0.05
        params["router"]["kernel"][:, 2] += 0.25
    x = _x(1)
    if c.get("collapse"):
        x = np.abs(x)
    mask = None
    if c.get("mask"):
        mask = np.ones((B, S), bool)
        mask[0, 6:] = False
        mask[1, 2] = False
    return params, x, mask, c.get("k", K), c.get("cf", 1.25)


def _both(params, x, mask, k, cf, dtype=None):
    jout = j_moe_apply(_to_jax(params), jnp.asarray(x, dtype or jnp.float32), num_experts=E,
                       top_k=k, capacity_factor=cf,
                       token_mask=None if mask is None else jnp.asarray(mask))
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tout = moe_apply(_to_torch(params), torch.from_numpy(x).to(tdtype), num_experts=E, top_k=k,
                     capacity_factor=cf,
                     token_mask=None if mask is None else torch.from_numpy(mask))
    return jout, tout


@pytest.mark.parametrize("name", sorted(CASES))
def test_output_aux_and_routing_match_jax(name):
    params, x, mask, k, cf = _case(name)
    (jy, jaux), (ty, taux) = _both(params, x, mask, k, cf)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    assert abs(float(taux) - float(jaux)) <= 1e-6, (float(taux), float(jaux))
    # Routing: indices, slot positions of the kept choices, the kept mask.
    j_idx, j_pos, j_fit = _jax_routing(_to_jax(params), jnp.asarray(x), k, cf,
                                       None if mask is None else jnp.asarray(mask))
    probs = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(params["router"]["kernel"]), -1)
    c = expert_capacity(S, E, k, cf)
    r = moe_route(probs, k, c, None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(r["indices"].numpy(), j_idx)
    np.testing.assert_array_equal(r["fits"].numpy(), j_fit)
    np.testing.assert_array_equal(r["position"].numpy()[j_fit], j_pos[j_fit])
    if name == "overflow":
        assert not j_fit.all()  # the case drops tokens
    if name == "zero_router":  # every probability equal: JAX's tie order
        assert (j_idx[..., 0] == 0).all() and (j_idx[..., 1] == 1).all()
    if name == "pads":
        assert not r["fits"].numpy()[~mask].any()


@pytest.mark.parametrize("name", ["base", "overflow", "pads", "zero_router", "top3"])
def test_gradients_match_jax(name):
    params, x, mask, k, cf = _case(name)
    gy = np.random.default_rng(7).standard_normal((B, S, D)).astype(np.float32)
    jmask = None if mask is None else jnp.asarray(mask)

    def j_obj(p, xx):
        y, aux = j_moe_apply(p, xx, num_experts=E, top_k=k, capacity_factor=cf,
                             token_mask=jmask)
        return jnp.sum(y * gy) + 0.37 * aux

    jg_p, jg_x = jax.grad(j_obj, argnums=(0, 1))(_to_jax(params), jnp.asarray(x))
    tp = _to_torch(params, requires_grad=True)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe_apply(tp, tx, num_experts=E, top_k=k, capacity_factor=cf,
                       token_mask=None if mask is None else torch.from_numpy(mask))
    (torch.sum(y * torch.from_numpy(gy)) + 0.37 * aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg_x), atol=1e-5, rtol=0)
    for path in (("router", "kernel"), ("in", "kernel"), ("in", "bias"), ("out", "kernel"),
                 ("out", "bias")):
        got = tp[path[0]][path[1]].grad.numpy()
        want = np.asarray(jg_p[path[0]][path[1]])
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=str(path))


def test_collapsed_router_has_the_larger_aux():
    _, jaux_bal = _both(*_case("base"))[0]
    _, jaux_col = _both(*_case("collapsed"))[0]
    (_, taux_bal), (_, taux_col) = _both(*_case("base"))[1], _both(*_case("collapsed"))[1]
    assert float(taux_col) > 3.5 > 1.5 > float(taux_bal)  # E at collapse, ~1 balanced
    assert abs(float(taux_col) - float(jaux_col)) <= 1e-6
    assert abs(float(taux_bal) - float(jaux_bal)) <= 1e-6


def test_bf16_compute_dtype_within_2e2():
    params, x, mask, k, cf = _case("base")
    (jy, jaux), (ty, taux) = _both(params, x, mask, k, cf, dtype=jnp.bfloat16)
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy, np.float32), atol=2e-2, rtol=0)
    assert abs(float(taux) - float(jaux)) <= 1e-6  # routing stays fp32


def test_one_expert_is_the_dense_ffn():
    params = _params(3, e=1)
    x = _x(3)
    y, aux = moe_apply(_to_torch(params), torch.from_numpy(x), num_experts=1, top_k=2)
    dense = {n: {"kernel": torch.from_numpy(params[n]["kernel"][0]),
                 "bias": torch.from_numpy(params[n]["bias"][0])} for n in ("in", "out")}
    np.testing.assert_allclose(y.numpy(), ffn_apply(dense, torch.from_numpy(x)).numpy(),
                               atol=1e-6, rtol=0)
    assert float(aux) == pytest.approx(1.0, abs=1e-6)
    jy, jaux = j_moe_apply(_to_jax(params), jnp.asarray(x), num_experts=1, top_k=2)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=0)


@pytest.mark.parametrize("seq_len", [1, 2, 7, 10, 64, 4095])
def test_expert_capacity_over_a_grid(seq_len):
    for e in (1, 2, 4, 8, 64):
        for k in (1, 2, 3):
            for cf in (0.5, 1.0, 1.25, 2.0):
                assert expert_capacity(seq_len, e, k, cf) == j_expert_capacity(seq_len, e, k, cf)
    assert expert_capacity(4095, 8, 2, 1.25) == 1280  # long4k-moe's C


def test_backward_is_bit_reproducible():
    params, x, mask, k, cf = _case("overflow")
    grads = []
    for _ in range(2):
        tp = _to_torch(params, requires_grad=True)
        tx = torch.from_numpy(x).requires_grad_(True)
        y, aux = moe_apply(tp, tx, num_experts=E, top_k=k, capacity_factor=cf)
        (y.square().sum() + aux).backward()
        grads.append([tx.grad] + [tp[a][b].grad for a in ("router", "in", "out")
                                  for b in (("kernel",) if a == "router" else ("kernel", "bias"))])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_zero_gate_choice_takes_a_slot_and_sends_nothing(monkeypatch):
    """A renormalised gate of exactly 0 (a probability that underflows)
    still takes its capacity slot, but its token is not copied there: the
    slot's expert output is the expert of a zero row, as the twin's
    ``dispatch = combine > 0``. Holds against JAX on a router whose
    second choice underflows for some tokens."""
    params = _params(5, router_scale=0.0)
    # Expert 0 by a margin of 200 in the logits: every other probability
    # is exp(-200) = 0 in fp32, so the second choice (expert 1) has gate 0.
    x = np.ones((1, 6, D), np.float32)
    params["router"]["kernel"][:, 0] = 200.0 / D
    jy, jaux = j_moe_apply(_to_jax(params), jnp.asarray(x), num_experts=E, top_k=2,
                           capacity_factor=1.25)
    tx = torch.from_numpy(x).requires_grad_(True)
    tp = _to_torch(params, requires_grad=True)
    y, aux = moe_apply(tp, tx, num_experts=E, top_k=2, capacity_factor=1.25)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    gy = np.random.default_rng(0).standard_normal(y.shape).astype(np.float32)
    (y * torch.from_numpy(gy)).sum().backward()
    jg = jax.grad(lambda p: jnp.sum(j_moe_apply(p, jnp.asarray(x), num_experts=E, top_k=2,
                                                 capacity_factor=1.25)[0] * gy))(_to_jax(params))
    np.testing.assert_allclose(tp["in"]["bias"].grad.numpy(), np.asarray(jg["in"]["bias"]),
                               atol=1e-5, rtol=0)


def test_moe_init_per_expert_glorot():
    g = torch.Generator().manual_seed(0)
    p = moe_init(g, 64, 256, 8)
    limit = (6.0 / (64 + 256)) ** 0.5  # each expert's fans, not E's
    w = p["in"]["kernel"]
    assert w.shape == (8, 64, 256) and float(w.abs().max()) <= limit
    assert float(w.abs().max()) > 0.95 * limit
    assert float(w.std()) == pytest.approx(limit / math.sqrt(3), rel=0.02)
    assert p["out"]["kernel"].shape == (8, 256, 64) and p["router"]["kernel"].shape == (64, 8)
    assert not p["in"]["bias"].any() and not p["out"]["bias"].any()


def test_stats_reducer_sees_counts_and_live_tokens():
    params, x, mask, k, cf = _case("pads")
    seen = []

    def reducer(v):
        seen.append(v.clone())
        return v * 2  # two identical processes

    with moe_mod.moe_stats_reducer(reducer):
        _, aux2 = moe_apply(_to_torch(params), torch.from_numpy(x), num_experts=E, top_k=k,
                            token_mask=torch.from_numpy(mask))
    _, aux1 = moe_apply(_to_torch(params), torch.from_numpy(x), num_experts=E, top_k=k,
                        token_mask=torch.from_numpy(mask))
    (v,) = seen
    assert v.shape == (E + 1,) and float(v[-1]) == mask.sum() and float(v[:E].sum()) == mask.sum()
    # Global f doubled, n doubled: this process's share is half the aux.
    assert float(aux2) == pytest.approx(float(aux1) / 2, rel=1e-6)
