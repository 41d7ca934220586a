"""The work of each kernel launch: its operations and the bytes it must move.

One function per kernel, taking the launch's operands. ``chip_smoke.py``
divides these counts by the card's rates for each kernel's ``bound_ms``,
and the cost model (``analysis/costs.py``) prices a wrapper called with
``meta`` operands as one operation of this work, so the two read the same
count. Bytes are each input read once and each output written once;
operations are 2 per multiply-add of the kernel's products.

Where the work depends on the data (the key mask of a flash launch, the
lengths of a paged one), a launch on the card counts what its data needs.
On ``meta`` operands there is no data: every key counts as real and every
table entry as visible, the most the shapes allow.

``priced_call`` is the wrappers' meta branch: it makes the outputs of the
right shapes and, inside a cost trace, reports the launch as one priced
operation in place of the ops that made those outputs.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Callable
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class Work:
    flops: float
    nbytes: float


def _has_data(t: torch.Tensor | None) -> bool:
    return t is not None and t.device.type != "meta"


def visible_pairs(mask: torch.Tensor | None, b: int, s_q: int, s_k: int, causal: bool,
                  band: int | None) -> int:
    """(query row, key) pairs an attention computes, summed over the batch,
    per query head: what the key mask ``mask`` (B, S_k) lets through, not
    the dense S_q * S_k (every key real when there is no mask or it holds
    no data). ``causal`` rows see keys up to their own position, within
    ``band`` keys when a band is given."""
    if not _has_data(mask):
        if not causal:
            return b * s_q * s_k
        rows = range(s_q)
        return b * sum(row + 1 if band is None else min(row + 1, band) for row in rows)
    cm = torch.cumsum(mask.long(), dim=1)  # (B, S_k)
    if not causal:
        return int(cm[:, -1].sum().item()) * s_q
    rows = torch.arange(s_q, device=mask.device)
    seen = cm[:, rows]
    if band is not None:
        lo = rows - band
        seen = seen - torch.where(lo >= 0, cm[:, lo.clamp_min(0)], torch.zeros_like(seen))
    return int(seen.sum().item())


# The products of each flash kernel: QK^T and PV forward; S, dP and dQ;
# S, dP, dV and dK.
FLASH_PRODUCTS = {"flash_fwd": 2, "flash_dq": 3, "flash_dkdv": 4}


def flash_work(kernel: str, q, k, kv_mask=None, causal: bool = False,
               band: int | None = None) -> Work:
    """``flash_fwd`` (q, k, v read; out, lse written), ``flash_dq`` (q, k,
    v, dO, lse, delta read; dQ written) or ``flash_dkdv`` (q, k, v, dO,
    lse, delta read; dK, dV written): (B, S, H, D) q, (B, S_k, H_kv, D) k
    and v, a (B, S_k) uint8 key mask when given."""
    b, s_q, h, d = q.shape
    e = q.element_size()
    qb, kvb, rows = q.numel() * e, k.numel() * e, b * h * s_q * 4
    mask = 0 if kv_mask is None else kv_mask.numel()
    nbytes = {
        "flash_fwd": 2 * qb + 2 * kvb + rows + mask,
        "flash_dq": 3 * qb + 2 * kvb + 2 * rows + mask,
        "flash_dkdv": 2 * qb + 4 * kvb + 2 * rows + mask,
    }[kernel]
    pairs = visible_pairs(kv_mask, b, s_q, k.shape[1], causal, band) * h
    return Work(2.0 * FLASH_PRODUCTS[kernel] * d * pairs, nbytes)


def ring_step_work(q, k, kv_mask, carry, causal: bool = False,
                   band: int | None = None) -> Work:
    """``flash_ring_step``: q, the chunk's k and v and its key mask read,
    the fp32 carry ``(m, l, acc)`` read and written; QK^T and PV over the
    chunk's visible pairs."""
    b, c, h, d = q.shape
    e = q.element_size()
    carry_bytes = sum(t.numel() * 4 for t in carry)
    mask = 0 if kv_mask is None else kv_mask.numel()
    nbytes = q.numel() * e + 2 * k.numel() * e + mask + 2 * carry_bytes
    pairs = visible_pairs(kv_mask, b, c, k.shape[1], causal, band) * h
    return Work(4.0 * d * pairs, nbytes)


def paged_attention_work(q, k_pool, table, lengths, quantized: bool) -> Work:
    """``paged_flash_attention``: q read and out written, the K and V rows
    below each sequence's length (and their fp32 scales in an int8 pool),
    the table entries that address them, and the lengths. ``lengths`` is a
    tensor or a list of ints; without data every table entry counts."""
    n, s_q, h, d = q.shape
    _, block, h_kv, _ = k_pool.shape
    nmax = table.shape[1]
    if isinstance(lengths, torch.Tensor):
        lengths = lengths.tolist() if _has_data(lengths) else [nmax * block] * n
    kv_elem = k_pool.element_size()
    rows = sum(lengths)
    nbytes = (
        2 * q.numel() * q.element_size()
        + 2 * rows * h_kv * d * kv_elem
        + (2 * rows * h_kv * 4 if quantized else 0)
        + sum(math.ceil(L / block) for L in lengths) * 4 + 4 * n
    )
    visible = sum(L - s_q + i + 1 for L in lengths for i in range(s_q))
    return Work(4.0 * d * h * visible, nbytes)


def fused_ln_ffn_work(x, dff: int, gated: bool) -> Work:
    """``fused_ln_ffn`` over the rows of ``x`` (..., d): x read and out
    written, the W_in (and gate) and W_out weights, their biases and the
    LayerNorm's scale and bias read once, all in x's dtype."""
    d = x.shape[-1]
    m = x.numel() // d
    mats = 3 if gated else 2
    nbytes = x.element_size() * (2 * m * d + mats * d * dff + (mats - 1) * dff + d + 2 * d)
    return Work(2.0 * m * d * dff * mats, nbytes)


# --------------------------------------------------------------------------
# the wrappers' meta branch

# The cost traces running now, innermost last (``analysis.costs``
# pushes one for the length of a program; the autograd engine may run a
# backward's launches on another thread, so this is not a context variable).
PRICERS: list = []


def priced_call(name: str, work: Work, make: Callable[[], Any]) -> Any:
    """The outputs of a launch on ``meta`` operands, made by ``make``;
    inside a cost trace the trace counts them as one operation named
    ``name`` of ``work`` (its ``kernel(name, work)`` context), not as the
    ops that made them."""
    if not PRICERS:
        return make()
    with PRICERS[-1].kernel(name, work):
        return make()
