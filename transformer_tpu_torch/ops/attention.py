"""Scaled dot-product attention: the cache-free ``mha_apply`` of training
and the cached self-attention of prefill.

Port of the parts of ``transformer_tpu/ops/attention.py`` the serving,
training and seq2seq slices run: the cache-free ``mha_apply`` (with
``precomputed_kv`` for cross-attention, and ``return_weights`` for the
attention maps of ``cli.translate --attention_out``), ``project_kv``, the decode
caches (full-length, or a rolling O(window) buffer for
``attention_window`` models) and their cached self-attention, and the
cache's block slice, insert and rollback (the prefix cache and the
speculative drafter), which refuse a rolling cache. Layouts are the JAX
package's: activations (B, S, H, D); q/k/v kernels (d_model, H, D); the
out kernel (H, D, d_model). KV caches and pools are dicts with the JAX
key names (``k``/``v``, plus fp32 ``k_scale``/``v_scale`` for int8
storage, plus ``index`` for a cache and ``rolling`` for a rolling one).
A cache's ``index`` is an int, or a (B,) tensor of per-row positions (the
slot pool's batched step, every slot at its own position).
"""

from __future__ import annotations

from typing import Any

import torch

from transformer_tpu_torch.ops.masks import (
    attention_bias,
    make_cache_prefix_mask,
    make_causal_mask,
    make_rolling_prefill_mask,
)
from transformer_tpu_torch.ops.nn import Params


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None = None,
    return_weights: bool = False,
):
    """softmax(q·kᵀ/√d + bias)·v for (B, S, H, D) queries, softmax in fp32.
    ``k``/``v`` may carry fewer heads (grouped-query attention). With
    ``return_weights`` returns (output, the fp32 (B, H, S_q, S_k) map)."""
    head_dim = q.shape[-1]
    scale = head_dim**-0.5
    H, Hkv = q.shape[2], k.shape[2]
    if H == Hkv:
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
        if mask is not None:
            logits = logits + attention_bias(mask)
        weights = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", weights.to(q.dtype), v)
        return (out, weights) if return_weights else out
    if H % Hkv:
        raise ValueError(f"query heads {H} must be a multiple of kv heads {Hkv}")
    G = H // Hkv
    B, Sq = q.shape[:2]
    qg = q.reshape(B, Sq, Hkv, G, head_dim)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() * scale
    if mask is not None:
        bias = attention_bias(mask)  # (B|1, H|1, S_q|1, S_k)
        if bias.shape[1] != 1:
            raise ValueError("per-head masks are unsupported with grouped kv heads")
        logits = logits + bias[:, :, None]
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", weights.to(q.dtype), v).reshape(B, Sq, H, head_dim)
    if return_weights:
        return out, weights.reshape(B, H, *weights.shape[3:])
    return out


def _project(p: Params, x: torch.Tensor, dtype) -> torch.Tensor:
    # (B, S, M) @ (M, H, D) -> (B, S, H, D)
    return torch.einsum(
        "bsm,mhd->bshd", x.to(dtype), p["kernel"].to(dtype)
    ) + p["bias"].to(dtype)


def out_project(p: Params, out: torch.Tensor, dtype) -> torch.Tensor:
    # (B, S, H, D) @ (H, D, M) -> (B, S, M)
    return torch.einsum("bshd,hdm->bsm", out, p["kernel"].to(dtype)) + p[
        "bias"
    ].to(dtype)


def project_kv(params: Params, x_kv: torch.Tensor, dtype=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Project key/value inputs once, for reuse across decode steps through
    ``mha_apply(..., precomputed_kv=...)``."""
    dtype = dtype or x_kv.dtype
    return _project(params["key"], x_kv, dtype), _project(params["value"], x_kv, dtype)


def _kv_padding_mask(mask: torch.Tensor | None, impl: str) -> torch.Tensor | None:
    """Blockwise kernels take key padding only: squeeze a broadcastable
    (B|1, 1, 1, S_k) allowed-mask to (B|1, S_k), or reject."""
    if mask is None:
        return None
    if mask.dim() == 4 and mask.shape[1] == 1 and mask.shape[2] == 1:
        return mask[:, 0, 0, :]
    raise ValueError(
        f"attention_impl={impl!r} takes a key-padding mask (B, 1, 1, S_k) plus the "
        f"structural causal flag; got a mask of shape {tuple(mask.shape)}"
    )


def mha_apply(
    params: Params,
    x_q: torch.Tensor,
    x_kv: torch.Tensor,
    mask: torch.Tensor | None = None,
    *,
    impl: str = "xla",
    causal: bool = False,
    window: int = 0,
    rope: bool = False,
    reference: bool = False,
    precomputed_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
    return_weights: bool = False,
):
    """Cache-free multi-head attention: (B, S_q, d) x (B, S_k, d) ->
    (B, S_q, d); with ``return_weights``, (output, the fp32 (B, H, S_q,
    S_k) attention map), whose map is None under the blockwise impls
    (flash, ring, ulysses keep none). ``precomputed_kv`` carries k/v already projected to
    (B, S_k, H_kv, D) (cross-attention over a fixed encoder output).
    ``mask`` is a broadcastable bool allowed-mask; ``causal`` is ANDed with
    it (structural under ``impl="flash"`` and ``"ring"``, a dense mask
    under ``"xla"``); ``window`` needs ``causal``. ``rope``
    rotates q and k at positions ``arange(S)``, offset by the chunk's
    global position under ``"ring"``. ``impl="ring"`` runs inside
    ``parallel.seq_context.sequence_parallel``: the inputs are this
    process's sequence chunk and the keys come round the ring.
    ``reference`` runs the flash kernels' plain versions on any device."""
    if window and not causal:
        raise ValueError(
            "window requires causal=True; bidirectional local attention is not implemented"
        )
    ctx = None
    if impl in ("ring", "ulysses"):
        from transformer_tpu_torch.parallel.seq_context import current_seq_context

        ctx = current_seq_context()
        if ctx is None:
            raise RuntimeError(
                f"attention_impl={impl!r} needs an active sequence-parallel "
                "context: train through DistributedTrainer with "
                "MeshConfig(seq>1) (or wrap the forward in "
                "parallel.seq_context.sequence_parallel)"
            )
    dtype = x_q.dtype
    q = _project(params["query"], x_q, dtype)
    if precomputed_kv is not None:
        k, v = (t.to(dtype) for t in precomputed_kv)
    else:
        k = _project(params["key"], x_kv, dtype)
        v = _project(params["value"], x_kv, dtype)
    if rope:
        from transformer_tpu_torch.ops.positional import apply_rope

        positions = torch.arange(x_q.shape[1], device=x_q.device)
        if ctx is not None:
            positions = positions + ctx.offset
        q = apply_rope(q, positions)
        if precomputed_kv is None:
            k = apply_rope(k, positions)
    weights = None
    if impl == "flash":
        from transformer_tpu_torch.kernels.flash_attention import flash_attention

        kv_mask = _kv_padding_mask(mask, impl)
        if kv_mask is not None:
            kv_mask = kv_mask.expand(q.shape[0], k.shape[1])
        out = flash_attention(
            q, k, v, kv_mask=kv_mask, causal=causal, window=window, reference=reference
        )
    elif ctx is not None:
        from transformer_tpu_torch.parallel.seq_context import seq_parallel_attention

        kv_mask = _kv_padding_mask(mask, impl)
        if kv_mask is not None:
            kv_mask = kv_mask.expand(q.shape[0], k.shape[1])
        out = seq_parallel_attention(ctx, impl, q, k, v, kv_mask, causal, window=window)
    else:
        if causal:
            cmask = make_causal_mask(x_q.shape[1], window, device=x_q.device)
            mask = cmask if mask is None else mask & cmask
        out = dot_product_attention(q, k, v, mask, return_weights=return_weights)
        if return_weights:
            out, weights = out
    out = out_project(params["out"], out, dtype)
    return (out, weights) if return_weights else out


def _quantize_kv(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per-(position, head) quantization of (..., D) rows:
    one fp32 scale per row of D values (round half to even, as jnp.round)."""
    t32 = t.float()
    amax = t32.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax == 0.0, torch.ones_like(amax), amax / 127.0)
    q = torch.clamp(torch.round(t32 / scale), -127, 127)
    return q.to(torch.int8), scale.float()


def kv_buffer_keys(cache: dict[str, Any]) -> tuple[str, ...]:
    """The keys holding per-position KV rows, in storage layout order."""
    if "k_scale" in cache:
        return ("k", "k_scale", "v", "v_scale")
    return ("k", "v")


def _store_kv(cache, k, v, rows):
    """Write new (B, S_q, H, D) k/v into ``cache`` in place, int8 caches
    quantizing into codes + scales: at buffer rows ``[rows, rows + S_q)``
    of every batch row when ``rows`` is an int, else at the (B|1, S_q)
    tensor ``rows`` of buffer rows per batch row (one batched scatter).
    Returns k/v as a later read of the cache sees them (the int8 round
    trip; the inputs otherwise)."""
    s_q = k.shape[1]
    if "k_scale" in cache:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        vals = {"k": kq, "k_scale": ks, "v": vq, "v_scale": vs}
        dtype = k.dtype
        seen = (kq.to(dtype) * ks.to(dtype), vq.to(dtype) * vs.to(dtype))
    else:
        vals = {"k": k.to(cache["k"].dtype), "v": v.to(cache["v"].dtype)}
        seen = (k, v)
    if not isinstance(rows, int):
        rows = rows.long().expand(k.shape[0], s_q)
        batch = torch.arange(k.shape[0], device=k.device)[:, None].expand_as(rows)
    for key in kv_buffer_keys(cache):
        if isinstance(rows, int):
            cache[key][:, rows : rows + s_q] = vals[key]
        else:
            cache[key][batch, rows] = vals[key]
    return seen


def _require_positional_buffers(cache: dict[str, Any], op: str) -> None:
    """Refuse a rolling-window cache in an operation that addresses buffer
    rows by absolute position: a rolling buffer stores position ``p`` at
    slot ``p % buf_len`` and evicts on wrap, so row ranges are neither
    stable nor complete (the JAX package's policy and message)."""
    if "rolling" in cache:
        raise ValueError(
            f"{op} cannot address a rolling-window cache by position: the "
            "window buffer evicts rows on wrap (slot p % buf_len), so "
            "absolute-position rows are neither stable nor complete — serve "
            "this config without attention_window"
        )


def slice_kv_blocks(cache: dict[str, Any], start: int, n: int) -> dict[str, torch.Tensor]:
    """Rows ``[start, start + n)`` of every KV buffer, in the cache's own
    storage layout (bf16 rows as bf16, int8 codes with their fp32 scales,
    GQA at the kv-head count): the export half of a block round trip, so
    ``insert_kv_blocks`` writes back exactly the bits the cache held."""
    _require_positional_buffers(cache, "slice_kv_blocks")
    return {key: cache[key][:, start : start + n].clone() for key in kv_buffer_keys(cache)}


def insert_kv_blocks(cache: dict[str, Any], blocks: dict[str, torch.Tensor], start: int):
    """Write ``slice_kv_blocks`` rows back at buffer rows ``[start, start +
    n)``, in place and without conversion; ``index`` is left to the
    caller. Returns ``cache``."""
    _require_positional_buffers(cache, "insert_kv_blocks")
    for key in kv_buffer_keys(cache):
        rows = blocks[key]
        cache[key][:, start : start + rows.shape[1]] = rows
    return cache


def rollback_cache(cache: dict[str, Any], index: int) -> dict[str, Any]:
    """Rollback by index: the buffers stay, ``index`` moves back. Rows at
    or past it are hidden by the offset causal mask of every later read,
    and the next write at them overwrites them (int8 rows re-quantized
    with their scales). A rolling cache is refused: a speculative write at
    ``p`` evicted slot ``p % buf_len``, which may still be in the window
    after the rollback."""
    _require_positional_buffers(cache, "rollback_cache")
    return dict(cache, index=int(index))


def init_cache(
    batch_size: int,
    max_len: int,
    num_heads: int,
    head_dim: int,
    dtype=torch.bfloat16,
    quantize: bool = False,
    device="cpu",
    window: int = 0,
) -> dict[str, Any]:
    """A fresh decode cache for ``cached_self_attention``: (B, buf_len, H,
    D) k/v in ``dtype``, or int8 codes with one fp32 scale per (position,
    head) row, and ``index`` 0. ``buf_len`` is ``max_len``, or with
    ``window > 0`` (``attention_window``) a ROLLING buffer of
    ``min(window, max_len)`` slots, marked by its ``rolling`` key (the
    requested window): each write goes to slot ``index % buf_len``, so a
    windowed decode reads O(window) rows at any context length."""
    buf_len = min(window, max_len) if window else max_len
    cache = dict(
        init_block_pool(batch_size, buf_len, num_heads, head_dim, dtype, quantize, device),
        index=0,
    )
    if window:
        cache["rolling"] = int(window)
    return cache


def _read_kv(cache: dict[str, Any], dtype, copy: bool = False):
    """The whole buffer as attention reads it: dequantized int8, else in
    ``dtype`` (``copy``: never the buffer itself, which the caller is
    about to write)."""
    if "k_scale" in cache:
        return (cache["k"].to(dtype) * cache["k_scale"].to(dtype),
                cache["v"].to(dtype) * cache["v_scale"].to(dtype))
    return cache["k"].to(dtype, copy=copy), cache["v"].to(dtype, copy=copy)


def cached_self_attention(
    params: Params,
    x: torch.Tensor,
    cache: dict[str, Any],
    *,
    rope: bool = False,
    window: int = 0,
) -> tuple[torch.Tensor, dict[str, Any]]:
    """``mha_apply`` on its cache path: project (B, S_q, d) inputs, write
    the new K/V at ``cache["index"]`` (an int, or (B,) per-row positions)
    and attend. The buffers are updated in place; returns (output, cache
    with the index advanced).

    Full-length cache: the write lands at rows ``index ..``, attention runs
    over the whole buffer under the offset causal prefix mask (banded by
    ``window`` when one is given). Rolling cache (``init_cache(window=)``):
    one token writes slot ``index % buf_len`` and attends every slot that
    holds a real position (all of them once the index wraps); a chunk of
    S_q > 1 (prefill, at most ``buf_len`` wide) first attends the
    buffer's pre-chunk slots plus its own keys under
    ``make_rolling_prefill_mask``, then writes, so no chunk token evicts a
    position an earlier chunk token still sees."""
    dtype = x.dtype
    q = _project(params["query"], x, dtype)
    k = _project(params["key"], x, dtype)
    v = _project(params["value"], x, dtype)
    idx = cache["index"]
    per_row = isinstance(idx, torch.Tensor)
    if not per_row:
        idx = int(idx)
    s_q = x.shape[1]
    steps = torch.arange(s_q, device=x.device)
    positions = idx.long()[:, None] + steps[None, :] if per_row else idx + steps
    if rope:
        from transformer_tpu_torch.ops.positional import apply_rope

        q = apply_rope(q, positions)
        k = apply_rope(k, positions)
    buf_len = cache["k"].shape[1]
    rolling = "rolling" in cache
    if rolling and s_q > 1:
        if s_q > buf_len:
            raise ValueError(
                f"rolling-window prefill chunks must fit the window "
                f"buffer: got s_q={s_q} > buf_len={buf_len} (split the "
                "prefill into chunks of at most the window size)"
            )
        k_old, v_old = _read_kv(cache, dtype, copy=True)
        mask = make_rolling_prefill_mask(idx, s_q, buf_len, device=x.device)
        rows = (positions if per_row else positions[None]) % buf_len
        k_new, v_new = _store_kv(cache, k, v, rows)
        k = torch.cat([k_old, k_new], dim=1)
        v = torch.cat([v_old, v_new], dim=1)
    else:
        if rolling:
            rows = (positions if per_row else positions[None]) % buf_len
        elif per_row:
            # Written in bounds by construction: the slot pool keeps
            # speculate_k rows of slack past the admission budget.
            rows = positions
        else:
            rows = idx
            if rows + s_q > buf_len:
                raise ValueError(
                    f"cache write [{rows}, {rows + s_q}) exceeds the buffer ({buf_len})"
                )
        _store_kv(cache, k, v, rows)
        k, v = _read_kv(cache, dtype)
        if rolling:
            # Slots holding a real position: those <= index until the
            # index wraps, then all (the newest write evicted the only
            # position that left the band).
            slots = torch.arange(buf_len, device=x.device)[None, None, None, :]
            at = idx.long().reshape(-1, 1, 1, 1) if per_row else idx
            mask = (slots <= at) | (at >= buf_len)
        else:
            mask = make_cache_prefix_mask(idx, s_q, buf_len, window, device=x.device)
    out = dot_product_attention(q, k, v, mask)
    return out_project(params["out"], out, dtype), dict(cache, index=idx + s_q)


def init_block_pool(
    num_blocks: int,
    block_tokens: int,
    num_heads: int,
    head_dim: int,
    dtype=torch.bfloat16,
    quantize: bool = False,
    device="cpu",
) -> dict[str, Any]:
    """One layer's paged KV pool: (num_blocks, block_tokens, H, D) buffers
    addressed through block tables (``kernels/kv_pool.py``); int8 pools
    carry fp32 (..., 1) scales beside the codes."""
    shape = (num_blocks, block_tokens, num_heads, head_dim)
    if quantize:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:3] + (1,), dtype=torch.float32, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "v_scale": torch.zeros(shape[:3] + (1,), dtype=torch.float32, device=device),
        }
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }
