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
from transformer_tpu_torch.ops.moe import moe_apply
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


def _token_mask_from(mask: torch.Tensor | None) -> torch.Tensor | None:
    """A (B|1, 1, 1, S) key-padding mask -> the (B|1, S) token mask of MoE
    routing; any other mask (or none) marks every token real, as in the
    JAX twin."""
    if mask is not None and mask.dim() == 4 and mask.shape[1] == 1 and mask.shape[-2] == 1:
        return mask[:, 0, 0, :]
    return None


def _ffn_sublayer_apply(params: Params, h: torch.Tensor, cfg: ModelConfig, aux_box: list,
                        token_mask: torch.Tensor | None = None):
    """The dense FFN, or the MoE FFN for a layer whose params carry
    ``moe``; a MoE layer's load-balance loss lands in ``aux_box[0]``."""
    if "moe" in params:
        y, aux_box[0] = moe_apply(
            params["moe"], h, num_experts=cfg.moe_experts, top_k=cfg.moe_top_k,
            capacity_factor=cfg.moe_capacity_factor, activation=cfg.ffn_activation,
            token_mask=token_mask,
        )
        return y
    return ffn_apply(params["ffn"], h, cfg.ffn_activation)


def _add_aux(total: torch.Tensor | None, aux: torch.Tensor | None) -> torch.Tensor | None:
    if aux is None:
        return total
    return aux if total is None else total + aux


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
    Returns (x, the MoE layer's aux loss or None); ``return_weights``
    returns (x, the attention map or None, aux). The aux is an output, not
    a side channel, so it survives ``remat_layer``."""
    box = [None]
    aux_box: list = [None]

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
        cfg, params["ln2"], x,
        lambda h: _ffn_sublayer_apply(params, h, cfg, aux_box, _token_mask_from(mask)),
        g_ffn, deterministic, dropout_slice,
    )
    return (x, box[0], aux_box[0]) if return_weights else (x, aux_box[0])


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
    return_aux: bool = False,
):
    """(B, S) source ids at positions ``position_offset ..`` -> (B, S,
    d_model) encodings. Dropout sites are keyed ``key + (0, site)`` for the
    prologue and ``key + (layer + 1, site)`` per layer, and draw over the
    global activation that ``dropout_slice`` places the ids in (a data ×
    sequence split, as in ``decoder_apply``). With ``cfg.remat`` each layer
    runs under ``remat_layer`` whenever gradients are recorded.
    ``return_weights`` returns (encodings, {"encoder_layer{L}": map}) with
    the plain path's maps (none under flash) and, for a MoE model, the
    summed load-balance loss under ``"moe_aux_encoder"``, as the JAX twin;
    its layers never run under remat. ``return_aux`` appends that sum
    (None without MoE layers) to what is returned."""
    (g_embed,) = _generators(_subkey(key, 0), 1, cfg, deterministic, ids.device)
    x = embed_prologue(params["embedding"], ids, cfg, position_offset, g_embed, deterministic,
                       dropout_slice)

    def layer_call(layer, x, layer_key):
        return encoder_layer_apply(layer, x, mask, cfg, layer_key, deterministic, reference,
                                   dropout_slice, return_weights)

    if cfg.remat and torch.is_grad_enabled() and not return_weights:
        layer_call = remat_layer(layer_call, cfg)
    maps = {}
    aux_total = None
    for i, layer in enumerate(params["layers"]):
        out = layer_call(layer, x, _subkey(key, i + 1))
        x, aux = out[0], out[-1]
        aux_total = _add_aux(aux_total, aux)
        if return_weights and out[1] is not None:
            maps[f"encoder_layer{i + 1}"] = out[1]
    if return_weights and aux_total is not None:
        maps["moe_aux_encoder"] = aux_total
    if cfg.norm_scheme == "pre":
        x = layernorm_apply(params["final_ln"], x, cfg.layernorm_epsilon)
    out = (x, maps) if return_weights else (x,)
    return (*out, aux_total) if return_aux else (out if return_weights else x)
