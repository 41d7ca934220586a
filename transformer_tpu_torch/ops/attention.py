"""Scaled dot-product attention and the cached self-attention of prefill.

Port of the parts of ``transformer_tpu/ops/attention.py`` the serving
slice runs. Layouts are the JAX package's: activations (B, S, H, D); q/k/v
kernels (d_model, H, D); the out kernel (H, D, d_model). KV caches and
pools are dicts with the JAX key names (``k``/``v``, plus fp32
``k_scale``/``v_scale`` for int8 storage, plus ``index`` for a cache).
"""

from __future__ import annotations

from typing import Any

import torch

from transformer_tpu_torch.ops.masks import attention_bias, make_cache_prefix_mask
from transformer_tpu_torch.ops.nn import Params


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """softmax(q·kᵀ/√d + bias)·v for (B, S, H, D) queries, softmax in fp32.
    ``k``/``v`` may carry fewer heads (grouped-query attention)."""
    head_dim = q.shape[-1]
    scale = head_dim**-0.5
    H, Hkv = q.shape[2], k.shape[2]
    if H == Hkv:
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
        if mask is not None:
            logits = logits + attention_bias(mask)
        weights = torch.softmax(logits, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", weights.to(q.dtype), v)
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
    out = torch.einsum("bhgqk,bkhd->bqhgd", weights.to(q.dtype), v)
    return out.reshape(B, Sq, H, head_dim)


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


def _store_kv(cache, k, v, index: int):
    """Write new (B, S_q, H, D) k/v into ``cache`` rows [index, index+S_q),
    in place (int8 caches quantize into codes + scales)."""
    s_q = k.shape[1]
    if "k_scale" in cache:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        vals = {"k": kq, "k_scale": ks, "v": vq, "v_scale": vs}
    else:
        vals = {"k": k.to(cache["k"].dtype), "v": v.to(cache["v"].dtype)}
    for key in kv_buffer_keys(cache):
        cache[key][:, index : index + s_q] = vals[key]


def cached_self_attention(
    params: Params,
    x: torch.Tensor,
    cache: dict[str, Any],
    *,
    rope: bool = False,
) -> tuple[torch.Tensor, dict[str, Any]]:
    """``mha_apply`` on its full-length-cache path: project (B, S_q, d)
    inputs, write the new K/V at ``cache["index"]`` (an int), attend over the
    whole buffer under the offset causal prefix mask. The buffers are
    updated in place; returns (output, cache with the index advanced)."""
    dtype = x.dtype
    q = _project(params["query"], x, dtype)
    k = _project(params["key"], x, dtype)
    v = _project(params["value"], x, dtype)
    idx = int(cache["index"])
    s_q = x.shape[1]
    if rope:
        from transformer_tpu_torch.ops.positional import apply_rope

        positions = idx + torch.arange(s_q, device=x.device)
        q = apply_rope(q, positions)
        k = apply_rope(k, positions)
    buf_len = cache["k"].shape[1]
    if idx + s_q > buf_len:
        raise ValueError(
            f"cache write [{idx}, {idx + s_q}) exceeds the buffer ({buf_len})"
        )
    _store_kv(cache, k, v, idx)
    if "k_scale" in cache:
        k = cache["k"].to(dtype) * cache["k_scale"].to(dtype)
        v = cache["v"].to(dtype) * cache["v_scale"].to(dtype)
    else:
        k = cache["k"].to(dtype)
        v = cache["v"].to(dtype)
    mask = make_cache_prefix_mask(idx, s_q, buf_len, device=x.device)
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
