"""Decoder stack of the decoder-only LM, on its KV-cached path.

Port of the parts of ``transformer_tpu/models/decoder.py`` the serving
slice runs: the self-attention + FFN layer over a per-layer cache, the
stack, and the chunked single-pass prefill. Cross-attention (seq2seq) and
the cache-free training forward are later slices.
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
from transformer_tpu_torch.ops.attention import cached_self_attention
from transformer_tpu_torch.ops.nn import Params, layernorm_apply


def _require_decoder_only(cfg: ModelConfig) -> None:
    if not cfg.decoder_only:
        raise NotImplementedError(
            "the port serves decoder-only LMs; seq2seq decoding is a later slice"
        )
    if cfg.attention_window:
        raise NotImplementedError(
            "sliding-window attention (rolling caches) is a later slice of the port"
        )


def decoder_layer_apply(
    params: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    cache: dict[str, Any],
) -> tuple[torch.Tensor, dict[str, Any]]:
    """One decoder-only layer over its KV cache: (x, updated cache)."""
    box: list[Any] = [None]

    def self_attn(h):
        out, box[0] = cached_self_attention(
            params["self_mha"], h, cache, rope=cfg.position_scheme == "rope",
        )
        return out

    x = _sublayer(cfg, params["ln1"], x, self_attn)
    x = _sublayer(
        cfg, params["ln_ffn"], x, lambda h: _ffn_sublayer_apply(params, h, cfg)
    )
    return x, box[0]


def decoder_apply(
    params: Params,
    ids: torch.Tensor,
    cfg: ModelConfig,
    caches: list[dict[str, Any]],
    position_offset: int = 0,
) -> tuple[torch.Tensor, list[dict[str, Any]]]:
    """(B, S) ids at positions ``position_offset ..`` -> (B, S, d_model)
    hiddens and the updated caches."""
    _require_decoder_only(cfg)
    x = embed_prologue(params["embedding"], ids, cfg, position_offset)
    new_caches = []
    for layer, cache in zip(params["layers"], caches):
        x, cache = decoder_layer_apply(layer, x, cfg, cache)
        new_caches.append(cache)
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
