"""Attention over a paged KV pool, by implementation.

Port of ``paged_attention`` from ``transformer_tpu/kernels/flash_attention.py``
(the only part of that module the serving slice runs): ``impl="xla"`` is
the plain gather oracle (dense-ordered views through the table, then the
fp32-softmax ``dot_product_attention`` under the offset causal mask);
``impl="paged_flash"`` reads the pool in place through
``kernels/paged_flash.paged_flash_attention``.
"""

from __future__ import annotations

import torch

from transformer_tpu_torch.kernels.kv_pool import gather_block_views
from transformer_tpu_torch.kernels.paged_flash import paged_flash_attention
from transformer_tpu_torch.ops.attention import dot_product_attention


def paged_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    impl: str = "xla",
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """(N, S_q, H, D) queries against (num_blocks, B, H_kv, D) pools through
    (N, nmax) block tables; row ``s`` sits at positions ``lengths[s] - S_q ..
    lengths[s] - 1``."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("int8 pools need BOTH k_scale and v_scale")
    if impl == "paged_flash":
        return paged_flash_attention(
            q, k_pool, v_pool, table, lengths, k_scale=k_scale, v_scale=v_scale
        )
    if impl != "xla":
        raise ValueError(f"unknown paged_attention impl {impl!r}")
    s_q = q.shape[1]
    k = gather_block_views(k_pool, table)  # (N, L, H_kv, D)
    v = gather_block_views(v_pool, table)
    if k_scale is not None:
        k = k.to(q.dtype) * gather_block_views(k_scale, table).to(q.dtype)
        v = v.to(q.dtype) * gather_block_views(v_scale, table).to(q.dtype)
    L = k.shape[1]
    positions = torch.arange(L, device=q.device)[None, None, None, :]
    q_pos = (lengths.long()[:, None, None, None] - s_q) + torch.arange(
        s_q, device=q.device
    )[None, None, :, None]
    return dot_product_attention(q, k, v, positions <= q_pos)
