"""Decoder stack of the decoder-only LM: the cache-free training forward
and the KV-cached path of serving.

Port of the parts of ``transformer_tpu/models/decoder.py`` the serving and
training slices run: the self-attention + FFN layer (over a per-layer
cache, or cache-free under the structural causal flag and the padding
self-mask, with dropout and per-layer remat), the stack, and the chunked
single-pass prefill. Cross-attention (seq2seq) is a later slice.
"""

from __future__ import annotations

from typing import Any

import torch

from transformer_tpu_torch.config import ModelConfig
from transformer_tpu_torch.models.encoder import (
    _ffn_sublayer_apply,
    _sublayer,
    embed_prologue,
)
from transformer_tpu_torch.ops.attention import cached_self_attention, mha_apply
from transformer_tpu_torch.ops.nn import (
    GlobalSlice,
    Params,
    dropout_generator,
    layernorm_apply,
    remat_layer,
)


def _generators(key, n: int, cfg: ModelConfig, deterministic: bool, device):
    """One dropout generator per site, keyed ``key + (site,)``; Nones when
    dropout is off."""
    if deterministic or cfg.dropout_rate == 0.0:
        return [None] * n
    if key is None:
        raise ValueError("dropout in training mode requires a key")
    return [dropout_generator(tuple(key) + (i,), device) for i in range(n)]


def decoder_layer_apply(
    params: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    cache: dict[str, Any] | None = None,
    *,
    self_mask: torch.Tensor | None = None,
    key: tuple[int, ...] | None = None,
    deterministic: bool = True,
    reference: bool = False,
    dropout_slice: GlobalSlice | None = None,
) -> tuple[torch.Tensor, dict[str, Any] | None]:
    """One decoder-only layer: (x, updated cache). With a cache, causal
    attention over it (serving); without, causal self-attention under
    ``self_mask`` (B, 1, 1, S) with dropout keyed on ``key`` (training),
    drawn over the global activation ``dropout_slice`` places x in."""
    box: list[Any] = [None]

    def self_attn(h):
        if cache is not None:
            out, box[0] = cached_self_attention(
                params["self_mha"], h, cache, rope=cfg.position_scheme == "rope",
            )
            return out
        return mha_apply(
            params["self_mha"], h, h, self_mask, impl=cfg.attention_impl, causal=True,
            window=cfg.attention_window, rope=cfg.position_scheme == "rope",
            reference=reference,
        )

    g_attn, g_ffn = _generators(key, 2, cfg, deterministic, x.device)
    x = _sublayer(cfg, params["ln1"], x, self_attn, g_attn, deterministic, dropout_slice)
    x = _sublayer(
        cfg, params["ln_ffn"], x, lambda h: _ffn_sublayer_apply(params, h, cfg),
        g_ffn, deterministic, dropout_slice,
    )
    return x, box[0]


def decoder_apply(
    params: Params,
    ids: torch.Tensor,
    cfg: ModelConfig,
    caches: list[dict[str, Any]] | None = None,
    position_offset: int = 0,
    *,
    self_mask: torch.Tensor | None = None,
    key: tuple[int, ...] | None = None,
    deterministic: bool = True,
    reference: bool = False,
    dropout_slice: GlobalSlice | None = None,
) -> tuple[torch.Tensor, list[dict[str, Any]] | None]:
    """(B, S) ids at positions ``position_offset ..`` -> (B, S, d_model)
    hiddens and the updated caches (None on the cache-free path). Dropout
    sites are keyed ``key + (0, site)`` for the prologue and ``key +
    (layer + 1, site)`` per layer, and draw over the global activation
    that ``dropout_slice`` places the ids in (a data × sequence split).
    With ``cfg.remat`` the cache-free layers run under ``remat_layer``
    whenever gradients are recorded."""
    if not cfg.decoder_only:
        raise NotImplementedError(
            "the port runs decoder-only LMs; cross-attention (seq2seq) is a later slice"
        )
    if caches is not None and cfg.attention_window:
        raise NotImplementedError(
            "sliding-window attention over a cache (rolling caches) is a later slice of the port"
        )
    (g_embed,) = _generators(
        None if key is None else tuple(key) + (0,), 1, cfg, deterministic, ids.device
    )
    x = embed_prologue(
        params["embedding"], ids, cfg, position_offset, g_embed, deterministic, dropout_slice
    )
    if caches is not None:
        new_caches = []
        for layer, cache in zip(params["layers"], caches):
            x, cache = decoder_layer_apply(layer, x, cfg, cache)
            new_caches.append(cache)
    else:
        new_caches = None

        def layer_call(layer, x, layer_key):
            return decoder_layer_apply(
                layer, x, cfg, self_mask=self_mask, key=layer_key,
                deterministic=deterministic, reference=reference, dropout_slice=dropout_slice,
            )[0]

        if cfg.remat and torch.is_grad_enabled():
            layer_call = remat_layer(layer_call, cfg)
        for i, layer in enumerate(params["layers"]):
            x = layer_call(layer, x, None if key is None else tuple(key) + (i + 1,))
    if cfg.norm_scheme == "pre":
        x = layernorm_apply(params["final_ln"], x, cfg.layernorm_epsilon)
    return x, new_caches


def decoder_prefill(
    params: Params,
    tokens: torch.Tensor,
    caches: list[dict[str, Any]],
    cfg: ModelConfig,
    start: int = 0,
    chunk: int = 0,
) -> tuple[torch.Tensor, list[dict[str, Any]]]:
    """Teacher-forced prefill of (B, n) ``tokens`` at positions ``start ..
    start + n - 1``, in ``chunk``-sized forwards (0 = one forward). Returns
    the (B, d_model) hidden state of the last position and the caches."""
    n = tokens.shape[1]
    if n < 1:
        raise ValueError(f"prefill needs at least one token, got {n}")
    chunk = chunk if chunk > 0 else n
    x_last = None
    for off in range(0, n, chunk):
        width = min(chunk, n - off)
        x, caches = decoder_apply(
            params, tokens[:, off : off + width], cfg, caches,
            position_offset=start + off,
        )
        x_last = x[:, -1, :]
    return x_last, caches
