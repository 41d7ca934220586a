"""PyTorch port vs the JAX package: primitive ops on the same inputs.

Inputs come from numpy with a seed and go through both twins. Tolerances:
fp32 1e-5 absolute (the ops do the same arithmetic; only reduction order
and libm may differ), bf16 one bf16 ulp at the values' scale (stated per
test)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_tpu.ops import attention as jattn
from transformer_tpu.ops import ffn as jffn
from transformer_tpu.ops import nn as jnn
from transformer_tpu.ops import positional as jpos
from transformer_tpu_torch.ops import attention as tattn
from transformer_tpu_torch.ops import ffn as tffn
from transformer_tpu_torch.ops import nn as tnn
from transformer_tpu_torch.ops import positional as tpos

FP32_TOL = 1e-5
ACTIVATIONS = ["geglu", "gelu", "reglu", "relu", "silu", "swiglu"]


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _close(got, want, tol):
    np.testing.assert_allclose(
        np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32),
        np.asarray(want, np.float32), rtol=0, atol=tol,
    )


def test_layernorm_matches_jax():
    rng = _rng()
    x = rng.standard_normal((3, 5, 32)).astype(np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(32).astype(np.float32),
         "bias": rng.standard_normal(32).astype(np.float32)}
    want = jnn.layernorm_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = tnn.layernorm_apply({k: _t(v) for k, v in p.items()}, _t(x))
    _close(got, want, FP32_TOL)


def test_layernorm_bf16_matches_jax():
    """bf16 input, fp32 statistics, bf16 output: within one bf16 ulp at
    |y| < 4 (2**-6)."""
    rng = _rng(1)
    x = rng.standard_normal((4, 32)).astype(np.float32)
    p = {"scale": np.ones(32, np.float32), "bias": np.zeros(32, np.float32)}
    want = jnn.layernorm_apply(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x, jnp.bfloat16)
    )
    got = tnn.layernorm_apply({k: _t(v) for k, v in p.items()}, _t(x, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want, np.float32), 2**-6)


def test_dense_and_embedding_match_jax():
    rng = _rng(2)
    p = {"kernel": rng.standard_normal((16, 24)).astype(np.float32),
         "bias": rng.standard_normal(24).astype(np.float32)}
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    want = jnn.dense_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = tnn.dense_apply({k: _t(v) for k, v in p.items()}, _t(x))
    _close(got, want, FP32_TOL)
    table = rng.standard_normal((11, 16)).astype(np.float32)
    ids = rng.integers(0, 11, (2, 5))
    want = jnn.embedding_lookup({"table": jnp.asarray(table)}, jnp.asarray(ids), jnp.float32)
    got = tnn.embedding_lookup({"table": _t(table)}, torch.from_numpy(ids), torch.float32)
    _close(got, want, 0.0)
    want = jnn.embedding_attend({"table": jnp.asarray(table)}, jnp.asarray(x))
    got = tnn.embedding_attend({"table": _t(table)}, _t(x))
    _close(got, want, FP32_TOL)


def test_sinusoidal_table_is_block_sin_cos():
    """The block [sin | cos] layout (not interleaved), same values."""
    want = jpos.sinusoidal_positional_encoding(64, 32)
    got = tpos.sinusoidal_positional_encoding(64, 32)
    _close(got, want, FP32_TOL)
    # Channel 1 of position p is sin(p * 10000**(-2*0/32)) = sin(p): block
    # layout puts it at column 0 (evens) and cos(p) at column 16 (odds).
    np.testing.assert_allclose(got[5, 0].item(), np.sin(5.0), atol=1e-6)
    np.testing.assert_allclose(got[5, 16].item(), np.cos(5.0), atol=1e-6)


def test_sinusoidal_rows_match_table():
    table = tpos.sinusoidal_positional_encoding(64, 32)
    pos = torch.tensor([[0, 7, 63], [5, 5, 1]])
    assert torch.equal(tpos.sinusoidal_rows(pos, 32), table[pos])


@pytest.mark.parametrize("per_row", [False, True])
def test_rope_matches_jax(per_row):
    rng = _rng(3)
    x = rng.standard_normal((2, 5, 4, 8)).astype(np.float32)
    if per_row:
        offs = [3, 11]
        want = np.stack([
            np.asarray(jpos.apply_rope(jnp.asarray(x[i : i + 1]), o + jnp.arange(5)))[0]
            for i, o in enumerate(offs)
        ])
        got = tpos.apply_rope(_t(x), torch.tensor(offs)[:, None] + torch.arange(5))
    else:
        want = jpos.apply_rope(jnp.asarray(x), 2 + jnp.arange(5))
        got = tpos.apply_rope(_t(x), 2 + torch.arange(5))
    _close(got, want, FP32_TOL)


def _ffn_params(rng, d, dff, gated):
    p = {
        "in": {"kernel": rng.standard_normal((d, dff)) * 0.3, "bias": rng.standard_normal(dff) * 0.1},
        "out": {"kernel": rng.standard_normal((dff, d)) * 0.3, "bias": rng.standard_normal(d) * 0.1},
    }
    if gated:
        p["gate"] = {"kernel": rng.standard_normal((d, dff)) * 0.3,
                     "bias": rng.standard_normal(dff) * 0.1}
    j = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), p)
    t = jax.tree.map(lambda a: _t(a), p)
    return j, t


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_ffn_apply_matches_jax(activation):
    rng = _rng(4)
    jp, tp = _ffn_params(rng, 16, 32, activation in ("geglu", "reglu", "swiglu"))
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    want = jffn.ffn_apply(jp, jnp.asarray(x), activation)
    got = tffn.ffn_apply(tp, _t(x), activation)
    _close(got, want, FP32_TOL)


@pytest.mark.parametrize("activation", ["relu", "gelu", "swiglu"])
def test_ffn_apply_bf16_matches_jax(activation):
    """bf16 compute: the outputs are O(1), so a 3e-2 bound covers a few
    bf16 ulps of rounding placed differently by the two frameworks."""
    rng = _rng(5)
    jp, tp = _ffn_params(rng, 16, 32, activation == "swiglu")
    x = rng.standard_normal((4, 16)).astype(np.float32)
    want = jffn.ffn_apply(jp, jnp.asarray(x, jnp.bfloat16), activation)
    got = tffn.ffn_apply(tp, _t(x, torch.bfloat16), activation)
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want, np.float32), 3e-2)


@pytest.mark.parametrize("h_kv", [4, 2])
def test_dot_product_attention_matches_jax(h_kv):
    rng = _rng(6)
    q = rng.standard_normal((2, 3, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 6, h_kv, 8)).astype(np.float32)
    v = rng.standard_normal((2, 6, h_kv, 8)).astype(np.float32)
    mask = rng.random((2, 1, 3, 6)) > 0.3
    mask[..., 0] = True
    want, _ = jattn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask)
    )
    got = tattn.dot_product_attention(_t(q), _t(k), _t(v), torch.from_numpy(mask))
    _close(got, want, FP32_TOL)


def test_quantize_kv_matches_jax():
    rng = _rng(7)
    t = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    t[0, 0, 0] = 0.0  # an all-zero row keeps scale 1
    jq, js = jattn._quantize_kv(jnp.asarray(t))
    tq, ts = tattn._quantize_kv(_t(t))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("quantize", [False, True])
def test_init_block_pool_layout_matches_jax(quantize):
    want = jattn.init_block_pool(5, 4, 2, 8, jnp.float32, quantize=quantize)
    got = tattn.init_block_pool(5, 4, 2, 8, torch.float32, quantize=quantize)
    assert tattn.kv_buffer_keys(got) == jattn.kv_buffer_keys(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        assert str(got[key].dtype).split(".")[-1] == np.dtype(want[key].dtype).name
