"""Paged decode attention: the KV pool read in place through the block table.

``paged_flash_attention`` launches the hand-written CUDA kernel
``csrc/paged_attention.cu`` on CUDA tensors; ``paged_flash_attention_plain``
is the same function in torch ops (one softmax over the gathered rows
instead of the kernel's online walk, with the same dtype casts), used for
CPU tensors and as the kernel's reference on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from transformer_tpu_torch.kernels.kv_pool import gather_block_views
from transformer_tpu_torch.kernels.work import paged_attention_work, priced_call

# Finite stand-ins for -inf, as in the JAX package's flash kernels: masked
# scores sit far below any real logit, and the exp-guard recognises them.
MASKED = -1e30
MASK_GUARD = -1e29

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"paged_attention": [_I] + [_P] * 11 + [_I] * 9 + [_F, _P]}

# Positions one CTA of the kernel folds, rounded down to whole pool blocks
# (at least one). At the serving path's 16-token blocks that is 8 blocks:
# the main path's lengths (1001, 311, 701, 131 over 8 kv heads) then keep
# 152 CTAs busy on the H100's 132 SMs, where 256 would leave 80 and 64
# would double the partials the merge reads while leaving two of a CTA's
# four 32-token warps without work.
SPLIT_TARGET_TOKENS = 128


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """How the kernel cuts a table of ``nmax`` entries over the sequence:
    ``splits`` CTAs per (sequence, kv head), each folding ``split_tokens``
    consecutive positions into an fp32 partial (m, l, acc) in scratch of
    the shapes below. Depends on the table's width only, never on the
    lengths, so the wrapper reads nothing back from the device."""

    split_tokens: int
    splits: int
    rows_shape: tuple[int, ...]  # m and l: (N, H_kv, splits, G * S_q)
    acc_shape: tuple[int, ...]  # acc: (N, H_kv, splits, G * S_q, D)


def split_plan(n: int, s_q: int, h: int, h_kv: int, d: int, nmax: int,
               block_tokens: int) -> SplitPlan:
    blocks = max(1, SPLIT_TARGET_TOKENS // block_tokens)
    splits = -(-nmax // blocks)
    rows = (n, h_kv, splits, (h // h_kv) * s_q)
    return SplitPlan(blocks * block_tokens, splits, rows, rows + (d,))


def _check(q, k_pool, v_pool, k_scale, v_scale):
    n, s_q, h, d = q.shape
    if k_pool.shape[-1] != d:
        raise ValueError(f"head_dim mismatch: q {d} vs pool {k_pool.shape[-1]}")
    if h % k_pool.shape[2]:
        raise ValueError(
            f"query heads {h} must be a multiple of kv heads {k_pool.shape[2]}"
        )
    if (k_scale is None) != (v_scale is None):
        raise ValueError("int8 pools need BOTH k_scale and v_scale")


def paged_flash_attention_plain(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Reference for ``paged_flash_attention`` with the TPU kernel's casts:
    int8 dequantised as ``T(code) * T(scale)``; scores a dot in the compute
    dtype T, rounded to T, then fp32 and scaled; masked scores -1e30 and
    exp-guarded to exactly 0; p rounded to T for P·V, accumulated in fp32;
    out = (P·V) / sum(p)."""
    _check(q, k_pool, v_pool, k_scale, v_scale)
    n, s_q, h, d = q.shape
    h_kv = k_pool.shape[2]
    group = h // h_kv
    dtype = q.dtype
    k = gather_block_views(k_pool, table)  # (N, L, H_kv, D)
    v = gather_block_views(v_pool, table)
    if k_scale is not None:
        k = k.to(dtype) * gather_block_views(k_scale, table).to(dtype)
        v = v.to(dtype) * gather_block_views(v_scale, table).to(dtype)
    L = k.shape[1]
    qg = q.reshape(n, s_q, h_kv, group, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(dtype)).float() * d**-0.5
    positions = torch.arange(L, device=q.device)
    q_pos = (lengths.long()[:, None] - s_q) + torch.arange(s_q, device=q.device)
    visible = positions[None, None, :] <= q_pos[:, :, None]  # (N, S_q, L)
    scores = torch.where(visible[:, None, None], scores, torch.full_like(scores, MASKED))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(scores > MASK_GUARD, torch.exp(scores - m), torch.zeros_like(scores))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgqk,bkhd->bhgqd", p.to(dtype).float(), v.to(dtype).float())
    out = (acc / l).to(dtype)  # (N, H_kv, G, S_q, D)
    return out.permute(0, 3, 1, 2, 4).reshape(n, s_q, h, d)


def paged_flash_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Attention over a paged KV pool, blocks read in place.

    q: (N, S_q, H, D) queries at positions ``lengths - S_q .. lengths - 1``;
    k_pool/v_pool: (num_blocks, B, H_kv, D) in the compute dtype, or int8
    codes with (num_blocks, B, H_kv, 1) fp32 ``k_scale``/``v_scale``;
    table: (N, nmax) int32; lengths: (N,) int32 (including the S_q rows).
    Returns (N, S_q, H, D) in q's dtype.

    Replaces the TPU kernel ``_paged_kernel`` (``transformer_tpu/kernels/
    paged_flash.py``). On CPU tensors this runs the plain version; on CUDA
    tensors it launches ``csrc/paged_attention.cu`` or raises; on ``meta``
tensors (a cost trace) it is priced by ``kernels.work``. Decode
    attention is bound by reading the visible K/V rows from HBM: the kernel
    splits each sequence over CTAs of ``split_plan(...).split_tokens``
    positions, each reading only the table entries below the sequence's
    length, its K/V rows as 16-byte vectors, and serving all G query heads
    of its kv head from one read of each row; a second kernel merges the
    CTAs' fp32 partials in split order. A K/V row (``D`` times the pool's
    element size) must be a multiple of 16 bytes and the pools 16-byte
    aligned.
    """
    if q.device.type == "cpu":
        return paged_flash_attention_plain(
            q, k_pool, v_pool, table, lengths, k_scale=k_scale, v_scale=v_scale
        )
    if q.device.type == "meta":
        _check(q, k_pool, v_pool, k_scale, v_scale)
        work = paged_attention_work(q, k_pool, table, lengths, k_scale is not None)
        return priced_call("paged_flash_attention", work, lambda: torch.empty_like(q))
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_attention runs on cpu or cuda, not {q.device}")
    _check(q, k_pool, v_pool, k_scale, v_scale)
    from transformer_tpu_torch.kernels import build

    codes = {torch.float32: 0, torch.bfloat16: 1}
    if q.dtype not in codes:
        raise ValueError(f"paged attention kernel takes float32 or bfloat16, not {q.dtype}")
    quantized = k_scale is not None
    pool_dtype = torch.int8 if quantized else q.dtype
    if k_pool.dtype != pool_dtype or v_pool.dtype != pool_dtype:
        raise ValueError(
            f"pool dtype {k_pool.dtype}/{v_pool.dtype} does not match "
            f"{pool_dtype} (the compute dtype, or int8 with scales)"
        )
    tensors = [q, k_pool, v_pool, table, lengths] + (
        [k_scale, v_scale] if quantized else []
    )
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_flash_attention: every tensor must be on q's device")
    if any(not t.is_contiguous() for t in tensors[1:]):
        raise ValueError("paged_flash_attention: pools, scales and table must be contiguous")
    if quantized and (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
        raise ValueError("int8 pool scales must be float32")
    n, s_q, h, d = q.shape
    _, block_tokens, h_kv, _ = k_pool.shape
    if (d * k_pool.element_size()) % 16:
        raise ValueError(
            f"paged attention kernel reads K/V rows as 16-byte vectors: head_dim {d} x "
            f"{k_pool.element_size()} bytes is not a multiple of 16"
        )
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged attention kernel: the pools must start on a 16-byte boundary")
    q = q.contiguous()
    table = table.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    plan = split_plan(n, s_q, h, h_kv, d, table.shape[1], block_tokens)
    part_m = torch.empty(plan.rows_shape, dtype=torch.float32, device=q.device)
    part_l = torch.empty(plan.rows_shape, dtype=torch.float32, device=q.device)
    part_acc = torch.empty(plan.acc_shape, dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    lib = build.load("paged_attention", _SIGNATURES)

    def ptr(t):
        return None if t is None else t.data_ptr()

    status = lib.paged_attention(
        codes[q.dtype], ptr(q), ptr(k_pool), ptr(v_pool), ptr(k_scale),
        ptr(v_scale), ptr(table), ptr(lengths), ptr(part_m), ptr(part_l), ptr(part_acc),
        ptr(out), n, s_q, h, h_kv, d, block_tokens, table.shape[1], plan.split_tokens,
        plan.splits, d**-0.5, torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(status, "paged_attention")
    paged_flash_attention.launches += 1
    return out


# Kernel launches since the last reset (the plain path does not count).
paged_flash_attention.launches = 0
