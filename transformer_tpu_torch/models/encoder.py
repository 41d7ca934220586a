"""Encoder stack, and the layer plumbing the decoder shares: the
embedding prologue and the residual sublayer.

Port of ``transformer_tpu/models/encoder.py``: the encoder layer
(bidirectional self-attention under the key-padding mask, then the FFN,
LayerNorms ``ln1`` and ``ln2``), the stack with per-layer remat and the
pre-LN ``final_ln``. Dropout sits where the JAX twin puts it: after each
sublayer's function and at the end of the prologue; it is the identity
when ``deterministic`` (the default, which serving keeps). Each dropout
site draws from its own generator, keyed ``key + (site,)``.
"""

from __future__ import annotations

import torch

from transformer_tpu_torch.config import ModelConfig
from transformer_tpu_torch.ops.attention import mha_apply
from transformer_tpu_torch.ops.ffn import ffn_apply
from transformer_tpu_torch.ops.nn import (
    GlobalSlice,
    Params,
    dropout,
    dropout_generator,
    embedding_lookup,
    layernorm_apply,
    remat_layer,
)
from transformer_tpu_torch.ops.positional import sinusoidal_rows


def layer_uses_moe(cfg: ModelConfig, layer_index: int) -> bool:
    """Whether layer ``layer_index`` (0-based) carries a MoE FFN."""
    return cfg.moe_experts > 0 and (layer_index + 1) % cfg.moe_every == 0


def _generators(key, n: int, cfg: ModelConfig, deterministic: bool, device):
    """One dropout generator per site, keyed ``key + (site,)``; Nones when
    dropout is off."""
    if deterministic or cfg.dropout_rate == 0.0:
        return [None] * n
    if key is None:
        raise ValueError("dropout in training mode requires a key")
    return [dropout_generator(tuple(key) + (i,), device) for i in range(n)]


def _subkey(key, *path):
    return None if key is None else tuple(key) + path


def _sublayer(cfg: ModelConfig, params_ln, x, fn, generator=None, deterministic=True,
              dropout_slice: GlobalSlice | None = None):
    """Residual sublayer in post-LN (``LN(x + drop(fn(x)))``) or pre-LN
    (``x + drop(fn(LN(x)))``) form; ``dropout_slice`` places ``x`` in the
    global activation of a split run (``ops.nn.dropout``)."""
    if cfg.norm_scheme == "pre":
        y = fn(layernorm_apply(params_ln, x, cfg.layernorm_epsilon))
        return x + dropout(generator, y, cfg.dropout_rate, deterministic, dropout_slice)
    y = dropout(generator, fn(x), cfg.dropout_rate, deterministic, dropout_slice)
    return layernorm_apply(params_ln, x + y, cfg.layernorm_epsilon)


def _ffn_sublayer_apply(params: Params, h: torch.Tensor, cfg: ModelConfig):
    if "moe" in params:
        raise NotImplementedError(
            "MoE FFN layers are not ported yet (a later slice of the port)"
        )
    return ffn_apply(params["ffn"], h, cfg.ffn_activation)


def embed_prologue(
    embedding: Params,
    ids: torch.Tensor,
    cfg: ModelConfig,
    position_offset: int | torch.Tensor = 0,
    generator: torch.Generator | None = None,
    deterministic: bool = True,
    dropout_slice: GlobalSlice | None = None,
) -> torch.Tensor:
    """(B, S) ids -> embed, ×√d_model (in the compute dtype), + the
    sinusoidal rows at ``position_offset + arange(S)``, then dropout
    (drawn over the global activation that ``dropout_slice`` places the
    ids in, when given).
    ``position_offset`` is an int or a (B,) tensor of per-row offsets (the
    batched decode step). Offsets clamp to ``max_position`` exactly as the
    JAX twin's dynamic slice of its ``max_position + S``-row table does."""
    seq_len = ids.shape[1]
    if seq_len > cfg.max_position:
        raise ValueError(
            f"sequence length {seq_len} exceeds cfg.max_position "
            f"{cfg.max_position}; raise max_position to size the positional table"
        )
    dtype = cfg.compute_dtype
    x = embedding_lookup(embedding, ids, dtype)
    # Constants and int offsets are made on the device, not copied from the
    # host, so a CUDA graph can capture the prologue.
    x = x * torch.full((), cfg.d_model**0.5, dtype=dtype, device=x.device)
    if cfg.position_scheme == "sinusoidal":
        if isinstance(position_offset, torch.Tensor):
            offset = torch.clamp(position_offset.long(), 0, cfg.max_position).reshape(-1, 1)
        else:
            offset = min(max(int(position_offset), 0), cfg.max_position)
        positions = offset + torch.arange(seq_len, device=ids.device)[None, :]
        x = x + sinusoidal_rows(positions, cfg.d_model, dtype)
    return dropout(generator, x, cfg.dropout_rate, deterministic, dropout_slice)


def encoder_layer_apply(
    params: Params,
    x: torch.Tensor,
    mask: torch.Tensor | None,
    cfg: ModelConfig,
    key: tuple[int, ...] | None = None,
    deterministic: bool = True,
    reference: bool = False,
    dropout_slice: GlobalSlice | None = None,
    return_weights: bool = False,
):
    """One encoder layer: self-attention under the (B, 1, 1, S) key-padding
    ``mask`` with ``impl=cfg.attention_impl`` and no causality, then the
    FFN. ``reference`` runs the flash kernels' plain versions; dropout
    draws over the global activation that ``dropout_slice`` places x in.
    ``return_weights`` returns (x, the attention map or None)."""
    box = [None]

    def attn(h):
        out = mha_apply(
            params["mha"], h, h, mask, impl=cfg.attention_impl, causal=False,
            rope=cfg.position_scheme == "rope", reference=reference,
            return_weights=return_weights,
        )
        if return_weights:
            out, box[0] = out
        return out

    g_attn, g_ffn = _generators(key, 2, cfg, deterministic, x.device)
    x = _sublayer(cfg, params["ln1"], x, attn, g_attn, deterministic, dropout_slice)
    x = _sublayer(
        cfg, params["ln2"], x, lambda h: _ffn_sublayer_apply(params, h, cfg), g_ffn,
        deterministic, dropout_slice,
    )
    return (x, box[0]) if return_weights else x


def encoder_apply(
    params: Params,
    ids: torch.Tensor,
    mask: torch.Tensor | None,
    cfg: ModelConfig,
    key: tuple[int, ...] | None = None,
    deterministic: bool = True,
    reference: bool = False,
    position_offset: int = 0,
    dropout_slice: GlobalSlice | None = None,
    return_weights: bool = False,
):
    """(B, S) source ids at positions ``position_offset ..`` -> (B, S,
    d_model) encodings. Dropout sites are keyed ``key + (0, site)`` for the
    prologue and ``key + (layer + 1, site)`` per layer, and draw over the
    global activation that ``dropout_slice`` places the ids in (a data ×
    sequence split, as in ``decoder_apply``). With ``cfg.remat`` each layer
    runs under ``remat_layer`` whenever gradients are recorded.
    ``return_weights`` returns (encodings, {"encoder_layer{L}": map}) with
    the plain path's maps (none under flash), as the JAX twin; its layers
    never run under remat."""
    (g_embed,) = _generators(_subkey(key, 0), 1, cfg, deterministic, ids.device)
    x = embed_prologue(params["embedding"], ids, cfg, position_offset, g_embed, deterministic,
                       dropout_slice)

    def layer_call(layer, x, layer_key):
        return encoder_layer_apply(layer, x, mask, cfg, layer_key, deterministic, reference,
                                   dropout_slice, return_weights)

    if cfg.remat and torch.is_grad_enabled() and not return_weights:
        layer_call = remat_layer(layer_call, cfg)
    maps = {}
    for i, layer in enumerate(params["layers"]):
        x = layer_call(layer, x, _subkey(key, i + 1))
        if return_weights:
            x, w = x
            if w is not None:
                maps[f"encoder_layer{i + 1}"] = w
    if cfg.norm_scheme == "pre":
        x = layernorm_apply(params["final_ln"], x, cfg.layernorm_epsilon)
    return (x, maps) if return_weights else x
