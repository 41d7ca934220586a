"""Decoder stack: the cache-free training forward and the KV-cached path
of decoding.

Port of ``transformer_tpu/models/decoder.py``: the layer (causal
self-attention over a per-layer cache, or cache-free under the structural
causal flag and the padding self-mask; for seq2seq models the
cross-attention sublayer over the encoder output; the FFN), the stack
with dropout and per-layer remat, the chunked single-pass prefill, the
decode caches (a rolling O(window) buffer for ``attention_window``
models) and the precomputed cross-attention K/V. Cross-attention
always takes the plain path, whatever ``cfg.attention_impl`` says, as in
the JAX twin.
"""

from __future__ import annotations

from typing import Any

import torch

from transformer_tpu_torch.config import ModelConfig
from transformer_tpu_torch.models.encoder import (
    _ffn_sublayer_apply,
    _generators,
    _subkey,
    _sublayer,
    embed_prologue,
)
from transformer_tpu_torch.ops.attention import (
    cached_self_attention,
    init_cache,
    mha_apply,
    project_kv,
)
from transformer_tpu_torch.ops.nn import (
    GlobalSlice,
    Params,
    layernorm_apply,
    remat_layer,
)

CrossKV = tuple[torch.Tensor, torch.Tensor]


def decoder_layer_apply(
    params: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    cache: dict[str, Any] | None = None,
    *,
    self_mask: torch.Tensor | None = None,
    enc_out: torch.Tensor | None = None,
    cross_mask: torch.Tensor | None = None,
    cross_kv: CrossKV | None = None,
    key: tuple[int, ...] | None = None,
    deterministic: bool = True,
    reference: bool = False,
    dropout_slice: GlobalSlice | None = None,
    return_weights: bool = False,
):
    """One decoder layer: (x, updated cache). With a cache, causal
    attention over it (decoding); without, causal self-attention under
    ``self_mask`` (B, 1, 1, S) with dropout keyed on ``key`` (training),
    drawn over the global activation ``dropout_slice`` places x in. A
    seq2seq layer then attends over ``enc_out`` under ``cross_mask``, or
    over its projected ``cross_kv``. Dropout sites: 0 self-attention, 1
    FFN, 2 cross-attention. ``return_weights`` (cache-free) returns (x,
    None, self-attention map, cross-attention map), each None where the
    path keeps no map."""
    box: list[Any] = [None, None, None]

    def self_attn(h):
        if cache is not None:
            out, box[0] = cached_self_attention(
                params["self_mha"], h, cache, rope=cfg.position_scheme == "rope",
                window=cfg.attention_window,
            )
            return out
        out = mha_apply(
            params["self_mha"], h, h, self_mask, impl=cfg.attention_impl, causal=True,
            window=cfg.attention_window, rope=cfg.position_scheme == "rope",
            reference=reference, return_weights=return_weights,
        )
        if return_weights:
            out, box[1] = out
        return out

    gens = _generators(key, 2 if cfg.decoder_only else 3, cfg, deterministic, x.device)
    x = _sublayer(cfg, params["ln1"], x, self_attn, gens[0], deterministic, dropout_slice)
    if not cfg.decoder_only:
        if enc_out is None and cross_kv is None:
            raise ValueError("a seq2seq decoder needs the encoder output (or its cross K/V)")

        def cross_attn(h):
            out = mha_apply(
                params["cross_mha"], h, enc_out, cross_mask, precomputed_kv=cross_kv,
                return_weights=return_weights,
            )
            if return_weights:
                out, box[2] = out
            return out

        x = _sublayer(cfg, params["ln2"], x, cross_attn, gens[2], deterministic, dropout_slice)
    x = _sublayer(
        cfg, params["ln_ffn"], x, lambda h: _ffn_sublayer_apply(params, h, cfg),
        gens[1], deterministic, dropout_slice,
    )
    return (x, *box) if return_weights else (x, box[0])


def decoder_apply(
    params: Params,
    ids: torch.Tensor,
    cfg: ModelConfig,
    caches: list[dict[str, Any]] | None = None,
    position_offset: int | torch.Tensor = 0,
    *,
    self_mask: torch.Tensor | None = None,
    enc_out: torch.Tensor | None = None,
    cross_mask: torch.Tensor | None = None,
    cross_kvs: list[CrossKV] | None = None,
    key: tuple[int, ...] | None = None,
    deterministic: bool = True,
    reference: bool = False,
    dropout_slice: GlobalSlice | None = None,
    return_weights: bool = False,
):
    """(B, S) ids at positions ``position_offset ..`` -> (B, S, d_model)
    hiddens and the updated caches (None on the cache-free path). Dropout
    sites are keyed ``key + (0, site)`` for the prologue and ``key +
    (layer + 1, site)`` per layer, and draw over the global activation
    that ``dropout_slice`` places the ids in (a data × sequence split).
    With ``cfg.remat`` the cache-free layers run under ``remat_layer``
    whenever gradients are recorded. ``return_weights`` (cache-free)
    returns (hiddens, None, maps): the JAX twin's
    ``decoder_layer{L}_block1`` (self) and ``_block2`` (cross) maps of the
    plain path (cross-attention always has one; self-attention none
    under flash); its layers never run under remat."""
    (g_embed,) = _generators(_subkey(key, 0), 1, cfg, deterministic, ids.device)
    x = embed_prologue(
        params["embedding"], ids, cfg, position_offset, g_embed, deterministic, dropout_slice
    )
    cross = dict(enc_out=enc_out, cross_mask=cross_mask)
    maps = {}
    if caches is not None:
        new_caches = []
        for i, (layer, cache) in enumerate(zip(params["layers"], caches)):
            kv = None if cross_kvs is None else cross_kvs[i]
            x, cache = decoder_layer_apply(layer, x, cfg, cache, cross_kv=kv, **cross)
            new_caches.append(cache)
    else:
        new_caches = None

        def layer_call(layer, x, layer_key):
            out = decoder_layer_apply(
                layer, x, cfg, self_mask=self_mask, key=layer_key,
                deterministic=deterministic, reference=reference, dropout_slice=dropout_slice,
                return_weights=return_weights, **cross,
            )
            return out if return_weights else out[0]

        if cfg.remat and torch.is_grad_enabled() and not return_weights:
            layer_call = remat_layer(layer_call, cfg)
        for i, layer in enumerate(params["layers"]):
            x = layer_call(layer, x, _subkey(key, i + 1))
            if return_weights:
                x, _, w1, w2 = x
                for block, w in ((1, w1), (2, w2)):
                    if w is not None:
                        maps[f"decoder_layer{i + 1}_block{block}"] = w
    if cfg.norm_scheme == "pre":
        x = layernorm_apply(params["final_ln"], x, cfg.layernorm_epsilon)
    return (x, new_caches, maps) if return_weights else (x, new_caches)


def decoder_prefill(
    params: Params,
    tokens: torch.Tensor,
    caches: list[dict[str, Any]],
    cfg: ModelConfig,
    start: int = 0,
    chunk: int = 0,
    *,
    enc_out: torch.Tensor | None = None,
    cross_mask: torch.Tensor | None = None,
    cross_kvs: list[CrossKV] | None = None,
) -> tuple[torch.Tensor, list[dict[str, Any]]]:
    """Teacher-forced prefill of (B, n) ``tokens`` at positions ``start ..
    start + n - 1``, in ``chunk``-sized forwards (0 = one forward). A
    rolling cache caps the chunk at its buffer length (the attention
    layer's invariant). Returns the (B, d_model) hidden state of the last
    position and the caches."""
    n = tokens.shape[1]
    if n < 1:
        raise ValueError(f"prefill needs at least one token, got {n}")
    chunk = chunk if chunk > 0 else n
    if caches and "rolling" in caches[0]:
        chunk = min(chunk, caches[0]["k"].shape[1])
    x_last = None
    for off in range(0, n, chunk):
        width = min(chunk, n - off)
        x, caches = decoder_apply(
            params, tokens[:, off : off + width], cfg, caches,
            position_offset=start + off, enc_out=enc_out, cross_mask=cross_mask,
            cross_kvs=cross_kvs,
        )
        x_last = x[:, -1, :]
    return x_last, caches


def init_decoder_caches(
    cfg: ModelConfig, batch_size: int, max_len: int, device="cpu"
) -> list[dict[str, Any]]:
    """One self-attention KV cache per decoder layer (int8 with
    ``cfg.kv_cache_int8``; a rolling O(window) buffer with
    ``cfg.attention_window``), starting at position 0."""
    return [
        init_cache(batch_size, max_len, cfg.kv_heads, cfg.head_dim, cfg.compute_dtype,
                   quantize=cfg.kv_cache_int8, device=device, window=cfg.attention_window)
        for _ in range(cfg.num_layers)
    ]


def precompute_cross_kvs(
    params: Params, enc_out: torch.Tensor, cfg: ModelConfig
) -> list[CrossKV]:
    """Every layer's cross-attention K/V of the (fixed) encoder output,
    projected once for the whole decode."""
    return [
        project_kv(layer["cross_mha"], enc_out, cfg.compute_dtype)
        for layer in params["layers"]
    ]
