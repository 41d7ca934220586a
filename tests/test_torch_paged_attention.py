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
oracle against JAX's: fp32 1e-6, bf16 2**-7 (one ulp at |out| < 2).

The CUDA kernel splits each sequence over CTAs (``split_plan``) and merges
their partials in split order; ``_split_fold`` replays that order in torch
at lengths on the split edges and holds it to the plain version (fp32
1e-6: the same sums, regrouped) and to JAX's Pallas kernel (fp32 5e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_tpu.kernels.flash_attention import paged_attention as j_paged_attention
from transformer_tpu.ops.attention import _quantize_kv as j_quantize
from transformer_tpu_torch.kernels.kv_pool import gather_block_views
from transformer_tpu_torch.kernels.paged_flash import (
    MASK_GUARD,
    MASKED,
    paged_flash_attention,
    paged_flash_attention_plain,
    split_plan,
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


# How a CTA of csrc/paged_attention.cu folds its split: kWarps warps, each
# taking kChunk positions at a time (one per lane), chunks w, w + 4, ...
CTA_WARPS, CHUNK_TOKENS = 4, 32


def _merge(parts):
    """Partials (m, l, acc) merged in list order, as the kernel merges its
    warps' and its splits': m = max m_i, weights exp(m_i - m), an empty
    partial (m = MASKED) weighing exactly 0."""
    m = torch.stack([p[0] for p in parts]).amax(dim=0)
    l, acc = torch.zeros_like(parts[0][1]), torch.zeros_like(parts[0][2])
    for m_i, l_i, acc_i in parts:
        w = torch.where(m_i > MASK_GUARD, torch.exp(m_i - m), torch.zeros_like(m_i))
        l = l + w * l_i
        acc = acc + w[..., None] * acc_i
    return m, l, acc


def _split_fold(q, k_pool, v_pool, table, lengths):
    """The kernel's order in torch: per (sequence, kv head), each split's
    CTA_WARPS warps fold their CHUNK_TOKENS-position chunks online (the
    running max moves, p is rounded to T at it, acc is rescaled); the
    warps' partials merge in warp order into the split's, the splits' in
    split order, and out = acc / l. Every split is folded, those past a
    sequence's length included (an empty partial)."""
    n, s_q, h, d = q.shape
    nmax, (_, bt, h_kv, _) = table.shape[1], k_pool.shape
    plan = split_plan(n, s_q, h, h_kv, d, nmax, bt)
    dtype, gs = q.dtype, (h // h_kv) * s_q
    k = gather_block_views(k_pool, table).to(dtype).float().permute(0, 2, 1, 3)
    v = gather_block_views(v_pool, table).to(dtype).float().permute(0, 2, 1, 3)
    qg = q.float().reshape(n, s_q, h_kv, h // h_kv, d).permute(0, 2, 3, 1, 4)
    qg = qg.reshape(n, h_kv, gs, d)  # rows r = g * S_q + i
    s = (qg @ k.transpose(-1, -2)).to(dtype).float() * d**-0.5  # (N, H_kv, GS, L)
    pos = torch.arange(nmax * bt)
    q_pos = lengths.long()[:, None] - s_q + torch.arange(gs) % s_q  # (N, GS)
    s = torch.where(pos <= q_pos[:, None, :, None], s, torch.full_like(s, MASKED))

    def empty():
        return (torch.full((n, h_kv, gs), MASKED), torch.zeros((n, h_kv, gs)),
                torch.zeros((n, h_kv, gs, d)))

    def fold(state, lo, hi):
        m, l, acc = state
        chunk = s[..., lo:hi]
        m_new = torch.maximum(m, chunk.amax(dim=-1))
        p = torch.where(chunk > MASK_GUARD, torch.exp(chunk - m_new[..., None]),
                        torch.zeros_like(chunk))
        corr = torch.exp(m - m_new)
        pv = p.to(dtype).float() @ v[:, :, lo:hi]
        return m_new, corr * l + p.sum(dim=-1), acc * corr[..., None] + pv

    splits = []
    for sp in range(plan.splits):
        lo = sp * plan.split_tokens
        stop = min(lo + plan.split_tokens, nmax * bt)  # the table ends inside the last split
        chunks = -(-(stop - lo) // CHUNK_TOKENS)
        warps = []
        for w in range(CTA_WARPS):
            state = empty()
            for c in range(w, chunks, CTA_WARPS):
                start = lo + c * CHUNK_TOKENS
                state = fold(state, start, min(start + CHUNK_TOKENS, stop))
            warps.append(state)
        splits.append(_merge(warps))
    _, l, acc = _merge(splits)
    out = (acc / l[..., None]).reshape(n, h_kv, h // h_kv, s_q, d)
    return out.permute(0, 3, 1, 2, 4).reshape(n, s_q, h, d).to(dtype), plan


SPLIT_BLOCK = 16  # the serving path's pool block: 128-position splits
SPLIT_NMAX = 20  # a table 320 positions wide: three splits, the last one half full


def _split_case(length, s_q, seed=0):
    """Two sequences over a fragmented fp32 pool (GQA group of 2, so the
    kernel folds G * S_q rows per CTA): the first of ``length`` positions
    (at least S_q), the second of 200; unused table entries point at
    blocks of the other sequence, which the mask must hide. Returns (jax
    inputs, torch inputs)."""
    rng = np.random.default_rng(seed)
    h, h_kv, d = 4, 2, 8
    lengths = np.asarray([max(length, s_q), 200], np.int32)
    need = [-(-int(L) // SPLIT_BLOCK) for L in lengths]
    blocks = 1 + sum(need) + 4
    perm = rng.permutation(np.arange(1, blocks))
    table = rng.integers(1, blocks, (2, SPLIT_NMAX)).astype(np.int32)
    table[0, : need[0]] = perm[: need[0]]
    table[1, : need[1]] = perm[need[0] : need[0] + need[1]]
    kf = rng.standard_normal((blocks, SPLIT_BLOCK, h_kv, d)).astype(np.float32)
    vf = rng.standard_normal((blocks, SPLIT_BLOCK, h_kv, d)).astype(np.float32)
    q = rng.standard_normal((2, s_q, h, d)).astype(np.float32)
    arrays = (q, kf, vf, table, lengths)
    return tuple(jnp.asarray(a) for a in arrays), tuple(torch.from_numpy(a) for a in arrays)


_SPLIT = SPLIT_BLOCK * max(1, 128 // SPLIT_BLOCK)


@pytest.mark.parametrize("s_q", [1, 4])
@pytest.mark.parametrize(
    "length", [1, _SPLIT - 1, _SPLIT, _SPLIT + 1, SPLIT_BLOCK * SPLIT_NMAX],
    ids=["one", "split-1", "split", "split+1", "table_width"],
)
def test_split_fold_matches_plain_and_jax_pallas_kernel(length, s_q):
    jargs, targs = _split_case(length, s_q)
    got, plan = _split_fold(*targs)
    assert (plan.split_tokens, plan.splits) == (_SPLIT, 3)
    want = paged_flash_attention_plain(*targs)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    jax_out = j_paged_attention(*jargs, impl="paged_flash", interpret=True)
    np.testing.assert_allclose(got.numpy(), _np(jax_out), rtol=TOL["fp32"], atol=TOL["fp32"])


@pytest.mark.parametrize(
    "block_tokens, nmax, split_tokens, splits",
    [(16, 257, 128, 33), (8, 20, 128, 2), (48, 7, 96, 4), (256, 3, 256, 3)],
)
def test_split_plan_depends_on_the_table_width_only(block_tokens, nmax, split_tokens, splits):
    """The serving path's table (257 entries of 16 positions) gives 33
    splits of 128; a split is whole pool blocks, at least one, and the
    splits cover the table."""
    plan = split_plan(4, 2, 8, 2, 64, nmax, block_tokens)
    assert (plan.split_tokens, plan.splits) == (split_tokens, splits)
    assert plan.split_tokens % block_tokens == 0
    assert plan.splits * plan.split_tokens >= nmax * block_tokens
    assert plan.rows_shape == (4, 2, splits, 8) and plan.acc_shape == (4, 2, splits, 8, 64)
