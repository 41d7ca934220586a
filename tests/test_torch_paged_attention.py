"""Kernel B: the plain version of the port's paged attention against the
JAX package's Pallas kernel (interpret mode, as tests/test_paged_kernel.py
runs it on the CPU) and against the XLA gather oracle, across
fp32 / bf16 / int8 / GQA pools x S_q in {1, 3}, on a fragmented table
with an aliased slot and stale rows full of data. (The CUDA kernel
against the plain version: tests/test_torch_cuda.py.) The gather oracle
(``_gather_oracle``: dense-ordered views through the table, then the
fp32-softmax ``dot_product_attention`` under the offset causal mask) is
the port's twin of JAX's ``paged_attention(impl="xla")``.

Tolerances (per variant, as the JAX suite states them for its own kernel
against its oracle): fp32 5e-6; bf16 / int8 / GQA 3e-2 (the online and
one-pass softmax round p to bf16 at different maxima). The port's gather
oracle against JAX's: fp32 1e-6, bf16 2**-7 (one ulp at |out| < 2)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_tpu.kernels.flash_attention import paged_attention as j_paged_attention
from transformer_tpu.ops.attention import _quantize_kv as j_quantize
from transformer_tpu_torch.kernels.kv_pool import gather_block_views
from transformer_tpu_torch.kernels.paged_flash import (
    paged_flash_attention,
    paged_flash_attention_plain,
)
from transformer_tpu_torch.ops.attention import dot_product_attention

TOL = {"fp32": 5e-6, "bf16": 3e-2, "int8": 3e-2, "gqa": 3e-2}
ORACLE_TOL = {"fp32": 1e-6, "bf16": 2**-7, "int8": 2**-7, "gqa": 2**-7}
VARIANTS = {
    "fp32": dict(dtype="float32", h_q=2, h_kv=2, quantized=False),
    "bf16": dict(dtype="bfloat16", h_q=2, h_kv=2, quantized=False),
    "int8": dict(dtype="bfloat16", h_q=2, h_kv=2, quantized=True),
    "gqa": dict(dtype="bfloat16", h_q=4, h_kv=1, quantized=False),
}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _case(variant: str, s_q: int, block_tokens: int = 8, seed: int = 0):
    """The JAX suite's hostile pool: 7 blocks of random data, fragmented
    out-of-order tables, slot 2 aliasing slot 0's first two blocks, unused
    entries on sink block 0, lengths ending mid-block. Returns (jax
    inputs, torch inputs), built from the same numpy arrays."""
    spec = VARIANTS[variant]
    rng = np.random.default_rng(seed)
    d, blocks, n = 8, 7, 3
    table = np.asarray([[3, 5, 1, 0], [6, 2, 4, 0], [3, 5, 2, 0]], np.int32)
    index = np.asarray(
        [block_tokens + 2, block_tokens // 2, 2 * block_tokens - 2], np.int32
    )
    lengths = index + s_q
    kf = rng.standard_normal((blocks, block_tokens, spec["h_kv"], d)).astype(np.float32)
    vf = rng.standard_normal((blocks, block_tokens, spec["h_kv"], d)).astype(np.float32)
    q = rng.standard_normal((n, s_q, spec["h_q"], d)).astype(np.float32)
    jdt, tdt = jnp.dtype(spec["dtype"]), _TORCH[spec["dtype"]]
    if spec["quantized"]:
        k, ks = (np.asarray(a) for a in j_quantize(jnp.asarray(kf)))
        v, vs = (np.asarray(a) for a in j_quantize(jnp.asarray(vf)))
        jkw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        tkw = dict(k_scale=torch.from_numpy(ks.copy()), v_scale=torch.from_numpy(vs.copy()))
        jk, jv = jnp.asarray(k), jnp.asarray(v)
        tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    else:
        jkw, tkw = {}, {}
        jk, jv = jnp.asarray(kf, jdt), jnp.asarray(vf, jdt)
        tk, tv = torch.from_numpy(kf).to(tdt), torch.from_numpy(vf).to(tdt)
    jargs = (jnp.asarray(q, jdt), jk, jv, jnp.asarray(table), jnp.asarray(lengths))
    targs = (torch.from_numpy(q).to(tdt), tk, tv, torch.from_numpy(table),
             torch.from_numpy(lengths))
    return jargs, jkw, targs, tkw


def _gather_oracle(q, k_pool, v_pool, table, lengths, *, k_scale=None, v_scale=None):
    """(N, S_q, H, D) queries against the pools through the block tables;
    row ``s`` sits at positions ``lengths[s] - S_q .. lengths[s] - 1``."""
    s_q = q.shape[1]
    k = gather_block_views(k_pool, table)  # (N, L, H_kv, D)
    v = gather_block_views(v_pool, table)
    if k_scale is not None:
        k = k.to(q.dtype) * gather_block_views(k_scale, table).to(q.dtype)
        v = v.to(q.dtype) * gather_block_views(v_scale, table).to(q.dtype)
    positions = torch.arange(k.shape[1])[None, None, None, :]
    q_pos = (lengths.long()[:, None, None, None] - s_q) + torch.arange(s_q)[None, None, :, None]
    return dot_product_attention(q, k, v, positions <= q_pos)


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else t, np.float32)


@pytest.mark.parametrize("s_q", [1, 3])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_plain_matches_jax_pallas_kernel(variant, s_q):
    jargs, jkw, targs, tkw = _case(variant, s_q)
    want = j_paged_attention(*jargs, impl="paged_flash", interpret=True, **jkw)
    got = paged_flash_attention_plain(*targs, **tkw)
    assert tuple(got.shape) == want.shape
    assert got.dtype == _TORCH[VARIANTS[variant]["dtype"]]
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[variant], atol=TOL[variant])


@pytest.mark.parametrize("s_q", [1, 3])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_plain_matches_jax_gather_oracle(variant, s_q):
    jargs, jkw, targs, tkw = _case(variant, s_q)
    want = j_paged_attention(*jargs, impl="xla", **jkw)
    got = paged_flash_attention_plain(*targs, **tkw)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[variant], atol=TOL[variant])
    # The port's own gather oracle against JAX's, closer still.
    oracle = _gather_oracle(*targs, **tkw)
    np.testing.assert_allclose(
        _np(oracle), _np(want), rtol=0, atol=ORACLE_TOL[variant]
    )


def test_wrapper_on_cpu_is_the_plain_version():
    _, _, targs, tkw = _case("int8", 3)
    before = paged_flash_attention.launches
    got = paged_flash_attention(*targs, **tkw)
    assert torch.equal(got, paged_flash_attention_plain(*targs, **tkw))
    assert paged_flash_attention.launches == before  # only kernel launches count


def test_plain_ignores_stale_table_entries():
    """Entries past a sequence's length are never visible: pointing them
    at other blocks leaves the output bit-identical."""
    _, _, targs, tkw = _case("bf16", 1)
    base = paged_flash_attention_plain(*targs, **tkw)
    hostile = targs[3].clone()
    hostile[:, -1] = torch.tensor([4, 1, 6], dtype=torch.int32)
    got = paged_flash_attention_plain(*targs[:3], hostile, targs[4], **tkw)
    assert torch.equal(got, base)


def test_mismatched_scales_rejected():
    _, _, targs, tkw = _case("int8", 1)
    with pytest.raises(ValueError, match="BOTH"):
        paged_flash_attention_plain(*targs, k_scale=tkw["k_scale"])
