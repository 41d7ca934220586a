"""Shared layer plumbing: the embedding prologue and the residual sublayer.

Port of the parts of ``transformer_tpu/models/encoder.py`` the serving and
training slices run. Dropout sits where the JAX twin puts it: after each
sublayer's function and at the end of the prologue; it is the identity
when ``deterministic`` (the default, which serving keeps).
"""

from __future__ import annotations

import torch

from transformer_tpu_torch.config import ModelConfig
from transformer_tpu_torch.ops.ffn import ffn_apply
from transformer_tpu_torch.ops.nn import (
    GlobalSlice,
    Params,
    dropout,
    embedding_lookup,
    layernorm_apply,
)
from transformer_tpu_torch.ops.positional import sinusoidal_rows


def layer_uses_moe(cfg: ModelConfig, layer_index: int) -> bool:
    """Whether layer ``layer_index`` (0-based) carries a MoE FFN."""
    return cfg.moe_experts > 0 and (layer_index + 1) % cfg.moe_every == 0


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
    x = x * torch.tensor(cfg.d_model**0.5, dtype=dtype, device=x.device)
    if cfg.position_scheme == "sinusoidal":
        offset = torch.as_tensor(position_offset, device=ids.device).long()
        offset = torch.clamp(offset, 0, cfg.max_position).reshape(-1, 1)
        positions = offset + torch.arange(seq_len, device=ids.device)[None, :]
        x = x + sinusoidal_rows(positions, cfg.d_model, dtype)
    return dropout(generator, x, cfg.dropout_rate, deterministic, dropout_slice)
