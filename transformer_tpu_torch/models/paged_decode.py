"""The batched decode forward over the paged KV pool, on the two kernels.

Port of ``transformer_tpu/models/paged_decode.py``: one forward over every
pool slot, where attention reads the pool in place through the block
table (``kernels/paged_flash.py``, CUDA kernel ``paged_attention.cu``) and
each dense FFN sublayer is one fused residual+LN+FFN kernel
(``ops/ffn.py``, CUDA kernel ``fused_ln_ffn.cu``). Everything else
(embedding prologue, q/k/v/out projections, RoPE, LayerNorms, the pool
scatter) is plain torch.

Write-then-attend: each layer scatters its new K/V rows (quantized for
int8 pools) into the pool first, then attends through the table with
``lengths = index + S_q``. The pool is updated in place (the JAX twin
returns new buffers); the returned list holds the same tensors.
"""

from __future__ import annotations

from typing import Any

import torch

from transformer_tpu_torch.config import ModelConfig
from transformer_tpu_torch.kernels.kv_pool import block_row_ids, scatter_rows
from transformer_tpu_torch.kernels.paged_flash import (
    paged_flash_attention,
    paged_flash_attention_plain,
)
from transformer_tpu_torch.models.encoder import _sublayer, embed_prologue, layer_uses_moe
from transformer_tpu_torch.models.transformer import project_logits
from transformer_tpu_torch.ops.attention import (
    _project,
    _quantize_kv,
    kv_buffer_keys,
    out_project,
)
from transformer_tpu_torch.ops.ffn import fused_ln_ffn, fused_ln_ffn_plain
from transformer_tpu_torch.ops.nn import Params, layernorm_apply
from transformer_tpu_torch.ops.positional import apply_rope


def check_paged_flash_config(cfg: ModelConfig) -> None:
    """Reject configs the fused path cannot serve."""
    if not cfg.decoder_only:
        raise ValueError("paged_flash decode serves decoder-only LM configs")
    if cfg.attention_window:
        raise ValueError(
            "paged_flash decode has no sliding-window band mask; "
            "attention_window configs are not served by the port"
        )
    if cfg.moe_experts:
        raise NotImplementedError("MoE layers are a later slice of the port")


def _scatter_layer_kv(pool: dict[str, Any], k, v, rids) -> None:
    """Write (N, S_q, H_kv, D) projections into the pool at flat rows
    ``rids`` (codes and their scales together for int8 pools)."""
    n, s_q = k.shape[:2]

    def flat(t):
        return t.reshape(n * s_q, *t.shape[2:])

    if "k_scale" in pool:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        vals = {"k": kq, "k_scale": ks, "v": vq, "v_scale": vs}
    else:
        vals = {"k": k, "v": v}
    for key in kv_buffer_keys(pool):
        scatter_rows(pool[key], rids, flat(vals[key]))


def paged_decode_forward(
    params: Params,
    toks: torch.Tensor,
    pool_caches: list[dict[str, Any]],
    table: torch.Tensor,
    index: torch.Tensor,
    cfg: ModelConfig,
    *,
    block_tokens: int,
    reference: bool = False,
) -> tuple[torch.Tensor, list[dict[str, Any]]]:
    """One decode (S_q = 1) or verify (S_q > 1) forward over every slot.

    toks: (N, S_q) token ids; pool_caches: per-layer ``init_block_pool``
    dicts (updated in place); table: (N, nmax) int32; index: (N,) int32
    positions before this forward. Returns ((N, S_q, V) logits, pools).

    ``reference=True`` runs both kernels' plain versions instead (on any
    device): the comparison a test or the chip smoke makes; serving never
    sets it.
    """
    attend = paged_flash_attention_plain if reference else paged_flash_attention
    ffn = fused_ln_ffn_plain if reference else fused_ln_ffn
    dec = params["decoder"]
    n, s_q = toks.shape
    index = index.to(torch.int32)
    lengths = index + s_q
    rids = block_row_ids(table, index, s_q, block_tokens).reshape(-1)
    x = embed_prologue(dec["embedding"], toks, cfg, index)  # (N, S_q, d)
    dtype = x.dtype
    rope = cfg.position_scheme == "rope"
    positions = index.long()[:, None] + torch.arange(s_q, device=toks.device)
    for i, layer in enumerate(dec["layers"]):
        if layer_uses_moe(cfg, i):
            raise NotImplementedError("MoE layers are a later slice of the port")
        pool = pool_caches[i]

        def self_attn(h, layer=layer, pool=pool):
            mp = layer["self_mha"]
            q = _project(mp["query"], h, dtype)
            k = _project(mp["key"], h, dtype)
            v = _project(mp["value"], h, dtype)
            if rope:
                q = apply_rope(q, positions)
                k = apply_rope(k, positions)
            _scatter_layer_kv(pool, k, v, rids)
            quant = (
                {"k_scale": pool["k_scale"], "v_scale": pool["v_scale"]}
                if "k_scale" in pool else {}
            )
            out = attend(q, pool["k"], pool["v"], table, lengths, **quant)
            return out_project(mp["out"], out, dtype)

        x = _sublayer(cfg, layer["ln1"], x, self_attn)
        x = ffn(
            layer["ln_ffn"], layer["ffn"], x,
            activation=cfg.ffn_activation,
            norm_scheme=cfg.norm_scheme,
            epsilon=cfg.layernorm_epsilon,
        )
    if cfg.norm_scheme == "pre":
        x = layernorm_apply(dec["final_ln"], x, cfg.layernorm_epsilon)
    return project_logits(params, x, cfg), pool_caches
