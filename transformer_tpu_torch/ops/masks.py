"""Attention masks: boolean, True = "may attend" (the JAX twin's polarity),
turned into an additive bias at the attention op."""

from __future__ import annotations

import torch

from transformer_tpu_torch.config import PAD_ID

# Finite large-negative bias: fully-masked rows give a uniform softmax
# instead of NaNs.
NEG_INF = -1e9


def _query_positions(index, s_q: int, device) -> torch.Tensor:
    """(B|1, 1, s_q, 1) absolute query positions ``index + i``: ``index``
    is an int or a (B,) tensor of per-row positions (the slot pool's
    step, every slot at its own position)."""
    steps = torch.arange(s_q, device=device)[None, None, :, None]
    if isinstance(index, torch.Tensor):
        return index.long().reshape(-1, 1, 1, 1) + steps
    return index + steps


def make_cache_prefix_mask(index, s_q: int, buf_len: int, window: int = 0,
                           device="cpu") -> torch.Tensor:
    """(B|1, 1, s_q, buf_len) bool: the offset causal mask of a chunk
    attending into a partially-filled full-length cache. Query i sits at
    absolute position ``index + i`` (``index`` an int, or a (B,) tensor:
    one row of the mask per batch row) and may attend buffer position j
    iff ``j <= index + i``; ``window > 0`` also requires ``j > index + i -
    window`` (a sliding window over a full-length cache)."""
    positions = torch.arange(buf_len, device=device)[None, None, None, :]
    q_pos = _query_positions(index, s_q, device)
    valid = positions <= q_pos
    if window:
        valid = valid & (positions > q_pos - window)
    return valid


def make_rolling_prefill_mask(index, s_q: int, buf_len: int, device="cpu") -> torch.Tensor:
    """(B|1, 1, s_q, buf_len + s_q) bool: a prefill chunk attending a
    ROLLING window cache. The first ``buf_len`` key columns are the
    buffer's slots before the chunk, the last ``s_q`` the chunk's own
    keys. Slot s last held absolute position ``p_old(s)``, the largest
    ``p < index`` with ``p % buf_len == s`` (negative: never written);
    query i (position ``index + i``) may attend slot s iff ``p_old(s)`` is
    real and inside its band ``(index + i - buf_len, index + i]``, and
    chunk key j iff ``j <= i`` (chunks are at most ``buf_len`` wide). This
    is, position for position, what the one-token rolling path attends at
    each tick."""
    slots = torch.arange(buf_len, device=device)[None, None, None, :]
    start = _query_positions(index, 1, device)  # (B|1, 1, 1, 1)
    p_old = (start - 1) - ((start - 1 - slots) % buf_len)
    q_pos = _query_positions(index, s_q, device)
    old_ok = (p_old >= 0) & (p_old > q_pos - buf_len)
    i = torch.arange(s_q, device=device)
    chunk_ok = (i[None, :] <= i[:, None])[None, None].expand(old_ok.shape[0], 1, s_q, s_q)
    return torch.cat([old_ok, chunk_ok], dim=-1)


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
