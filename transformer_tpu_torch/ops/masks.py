"""Attention masks: boolean, True = "may attend" (the JAX twin's polarity),
turned into an additive bias at the attention op."""

from __future__ import annotations

import torch

from transformer_tpu_torch.config import PAD_ID

# Finite large-negative bias: fully-masked rows give a uniform softmax
# instead of NaNs.
NEG_INF = -1e9


def make_cache_prefix_mask(index, s_q: int, buf_len: int, device="cpu") -> torch.Tensor:
    """(1, 1, s_q, buf_len) bool: the offset causal mask of a prefill chunk
    attending into a partially-filled cache. Query i sits at absolute
    position ``index + i`` and may attend buffer position j iff
    ``j <= index + i``."""
    positions = torch.arange(buf_len, device=device)[None, None, None, :]
    q_pos = index + torch.arange(s_q, device=device)[None, None, :, None]
    return positions <= q_pos


def attention_bias(mask: torch.Tensor | None, dtype=torch.float32):
    """Boolean allowed-mask -> additive bias (0 allowed, NEG_INF blocked)."""
    if mask is None:
        return None
    zero = torch.zeros((), dtype=dtype, device=mask.device)
    # Filled on the device (no copy from a host scalar), so a CUDA graph
    # can capture it.
    return torch.where(mask, zero, torch.full((), NEG_INF, dtype=dtype, device=mask.device))


def make_padding_mask(ids: torch.Tensor, pad_id: int = PAD_ID) -> torch.Tensor:
    """(B, S) ids -> (B, 1, 1, S) bool, True where the key is a real token."""
    return (ids != pad_id)[:, None, None, :]


def make_causal_mask(seq_len: int, window: int = 0, device="cpu") -> torch.Tensor:
    """(1, 1, S, S) bool, True where query i may attend key j <= i;
    ``window > 0`` also requires j > i - window (a sliding window)."""
    mask = torch.tril(torch.ones((seq_len, seq_len), dtype=torch.bool, device=device))
    if window:
        mask = mask & torch.triu(torch.ones_like(mask), diagonal=-(window - 1))
    return mask[None, None]
