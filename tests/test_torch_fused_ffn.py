"""Kernel A: the plain version of the port's fused residual+LN+FFN sublayer
against the JAX package's Pallas kernel ``fused_ln_ffn`` (interpret mode),
for all six activations x {pre, post} LN, with non-trivial LN parameters
and dff split into two tiles on the JAX side. (The CUDA kernel against
the plain version: tests/test_torch_cuda.py.)

Tolerances: fp32 1e-5 absolute (same casts; the dff contraction is summed
in another order); bf16 3e-2 (outputs are O(1) LayerNorm'd or residual
values, a 3e-2 bound allows a few bf16 ulps placed differently)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_tpu.ops.ffn import fused_ln_ffn as j_fused_ln_ffn
from transformer_tpu_torch.ops.ffn import fused_ln_ffn, fused_ln_ffn_plain

ACTIVATIONS = ["geglu", "gelu", "reglu", "relu", "silu", "swiglu"]
GATED = {"geglu", "reglu", "swiglu"}


def _case(activation, m=3, d=32, dff=256, seed=0):
    rng = np.random.default_rng(seed)
    lim = (6.0 / (d + dff)) ** 0.5
    ffn = {
        "in": {"kernel": rng.standard_normal((d, dff)) * lim, "bias": rng.standard_normal(dff) * 0.1},
        "out": {"kernel": rng.standard_normal((dff, d)) * lim, "bias": rng.standard_normal(d) * 0.1},
    }
    if activation in GATED:
        ffn["gate"] = {"kernel": rng.standard_normal((d, dff)) * lim,
                       "bias": rng.standard_normal(dff) * 0.1}
    ln = {"scale": 1.0 + 0.1 * rng.standard_normal(d), "bias": 0.1 * rng.standard_normal(d)}
    x = rng.standard_normal((m, d))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    ffn, ln, x = jax.tree.map(f32, ffn), jax.tree.map(f32, ln), f32(x)
    return ffn, ln, x


def _torch(tree, dtype=torch.float32):
    return jax.tree.map(lambda a: torch.from_numpy(a.copy()).to(dtype), tree)


def _jax(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


@pytest.mark.parametrize("norm_scheme", ["pre", "post"])
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_plain_matches_jax_pallas_kernel(activation, norm_scheme):
    ffn, ln, x = _case(activation)
    kw = dict(activation=activation, norm_scheme=norm_scheme, epsilon=1e-6)
    want = j_fused_ln_ffn(
        _jax(ln), _jax(ffn), jnp.asarray(x), block_dff=128, interpret=True, **kw
    )
    got = fused_ln_ffn_plain(_torch(ln), _torch(ffn), torch.from_numpy(x), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("activation", ["relu", "gelu", "swiglu"])
def test_plain_matches_jax_pallas_kernel_bf16(activation):
    ffn, ln, x = _case(activation, seed=1)
    kw = dict(activation=activation, norm_scheme="post", epsilon=1e-6)
    want = j_fused_ln_ffn(
        _jax(ln), _jax(ffn), jnp.asarray(x, jnp.bfloat16), block_dff=128,
        interpret=True, **kw,
    )
    got = fused_ln_ffn_plain(_torch(ln), _torch(ffn), torch.from_numpy(x).bfloat16(), **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=0, atol=3e-2
    )


def test_leading_axes_fold_into_rows():
    ffn, ln, x = _case("relu", m=6)
    x3 = x.reshape(2, 3, -1)
    got = fused_ln_ffn(_torch(ln), _torch(ffn), torch.from_numpy(x3), norm_scheme="post")
    flat = fused_ln_ffn(_torch(ln), _torch(ffn), torch.from_numpy(x), norm_scheme="post")
    assert tuple(got.shape) == x3.shape
    assert torch.equal(got.reshape(6, -1), flat)


def test_wrapper_on_cpu_counts_no_launch():
    ffn, ln, x = _case("swiglu")
    before = fused_ln_ffn.launches
    got = fused_ln_ffn(_torch(ln), _torch(ffn), torch.from_numpy(x), activation="swiglu")
    want = fused_ln_ffn_plain(_torch(ln), _torch(ffn), torch.from_numpy(x), activation="swiglu")
    assert torch.equal(got, want)
    assert fused_ln_ffn.launches == before


def test_unknown_norm_scheme_rejected():
    ffn, ln, x = _case("relu")
    with pytest.raises(ValueError, match="norm_scheme"):
        fused_ln_ffn(_torch(ln), _torch(ffn), torch.from_numpy(x), norm_scheme="mid")
