"""LM assembly: parameter layout, random init, forward, vocab projection,
prefill.

Port of ``transformer_hidden_apply``, ``transformer_apply``,
``project_logits`` and ``transformer_prefill`` from
``transformer_tpu/models/transformer.py`` for decoder-only models, plus
``param_spec`` (the JAX package's parameter tree, flattened with its
checkpoint naming) and ``init_params`` (a random init of that tree from a
``torch.Generator``; same distributions as the JAX init, different
numbers).
"""

from __future__ import annotations

from typing import Any

import torch

from transformer_tpu_torch.config import PAD_ID, ModelConfig, is_gated
from transformer_tpu_torch.device import resolve_device
from transformer_tpu_torch.models.decoder import decoder_apply, decoder_prefill
from transformer_tpu_torch.ops.masks import make_padding_mask
from transformer_tpu_torch.ops.nn import GlobalSlice, Params, dense_apply, embedding_attend

SEP = "/"


def param_spec(cfg: ModelConfig) -> dict[str, tuple[tuple[int, ...], str]]:
    """Flat key -> (shape, init) for a decoder-only model, keys in the JAX
    checkpoint naming (``decoder/layers/0/self_mha/query/kernel``). init is
    one of "normal_embed", "glorot", "glorot_out", "zeros", "ones"."""
    if not cfg.decoder_only:
        raise NotImplementedError(
            "the port holds decoder-only LMs; seq2seq and encoder-only "
            "models are later slices"
        )
    d, h, hd, kv = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.kv_heads
    spec: dict[str, tuple[tuple[int, ...], str]] = {
        "decoder/embedding/table": ((cfg.target_vocab_size, d), "normal_embed"),
    }
    for i in range(cfg.num_layers):
        p = f"decoder/layers/{i}/"
        for name, heads in (("query", h), ("key", kv), ("value", kv)):
            spec[p + f"self_mha/{name}/kernel"] = ((d, heads, hd), "glorot")
            spec[p + f"self_mha/{name}/bias"] = ((heads, hd), "zeros")
        spec[p + "self_mha/out/kernel"] = ((h, hd, d), "glorot_out")
        spec[p + "self_mha/out/bias"] = ((d,), "zeros")
        if cfg.moe_experts and (i + 1) % cfg.moe_every == 0:
            raise NotImplementedError("MoE layers are a later slice of the port")
        dense = [("in", d, cfg.dff), ("out", cfg.dff, d)]
        if is_gated(cfg.ffn_activation):
            dense.append(("gate", d, cfg.dff))
        for name, d_in, d_out in dense:
            spec[p + f"ffn/{name}/kernel"] = ((d_in, d_out), "glorot")
            spec[p + f"ffn/{name}/bias"] = ((d_out,), "zeros")
        for ln in ("ln1", "ln_ffn"):
            spec[p + f"{ln}/scale"] = ((d,), "ones")
            spec[p + f"{ln}/bias"] = ((d,), "zeros")
    if cfg.norm_scheme == "pre":
        spec["decoder/final_ln/scale"] = ((d,), "ones")
        spec["decoder/final_ln/bias"] = ((d,), "zeros")
    if not cfg.tie_output:
        spec["final/kernel"] = ((d, cfg.target_vocab_size), "glorot")
        spec["final/bias"] = ((cfg.target_vocab_size,), "zeros")
    return spec


def unflatten(flat: dict[str, Any]) -> Params:
    """Flat ``a/b/0/c`` keys -> nested dicts, with all-digit levels as lists."""
    root: dict = {}
    for key, val in flat.items():
        parts = key.split(SEP)
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out

    return listify(root)


def flatten(params: Params, prefix: str = "") -> dict[str, Any]:
    """Nested params -> flat ``a/b/0/c`` keys (the inverse of ``unflatten``)."""
    flat: dict[str, Any] = {}
    items = enumerate(params) if isinstance(params, list) else params.items()
    for k, v in items:
        key = f"{prefix}{k}"
        if isinstance(v, (dict, list)):
            flat.update(flatten(v, key + SEP))
        else:
            flat[key] = v
    return flat


def init_params(
    cfg: ModelConfig, generator: torch.Generator, device="cuda"
) -> Params:
    """Random parameters for ``cfg`` (in ``param_dtype``): glorot-uniform
    kernels, N(0, 1)/sqrt(d_model) embeddings, zero biases, unit LN scales.
    Values come from ``generator`` on the CPU, then move to ``device``."""
    dev = resolve_device(device)
    dtype = cfg.params_dtype
    flat = {}
    for key, (shape, init) in param_spec(cfg).items():
        if init == "normal_embed":
            t = torch.randn(shape, generator=generator) * cfg.d_model**-0.5
        elif init in ("glorot", "glorot_out"):
            if init == "glorot_out":  # (H, D, d_model), drawn as (d, d)
                fan_in = fan_out = cfg.d_model
            else:
                fan_in, fan_out = shape[0], int(torch.tensor(shape[1:]).prod())
            limit = (6.0 / (fan_in + fan_out)) ** 0.5
            t = (torch.rand(shape, generator=generator) * 2.0 - 1.0) * limit
        elif init == "ones":
            t = torch.ones(shape)
        else:
            t = torch.zeros(shape)
        flat[key] = t.to(dtype=dtype, device=dev)
    return unflatten(flat)


def project_logits(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(..., d_model) hiddens -> (..., V) raw logits, tied or untied."""
    if cfg.tie_output:
        return embedding_attend(params["decoder"]["embedding"], x)
    return dense_apply(params["final"], x)


def transformer_hidden_apply(
    params: Params,
    inp: torch.Tensor | None,
    tar: torch.Tensor,
    cfg: ModelConfig,
    key: tuple[int, ...] | None = None,
    deterministic: bool = True,
    reference: bool = False,
    pad_id: int = PAD_ID,
    position_offset: int = 0,
    dropout_slice: GlobalSlice | None = None,
) -> torch.Tensor:
    """(B, S) token ids -> (B, S, d_model) hiddens of the decoder-only LM,
    before the vocab projection. ``inp`` is ignored (the JAX signature's
    source side); the self-mask is ``make_padding_mask(tar)``, ANDed with
    causality inside attention. ``key`` seeds dropout when not
    ``deterministic``; ``reference`` runs the flash kernels' plain
    versions. Under sequence parallelism ``tar`` is this process's chunk:
    ``position_offset`` is its first global position and ``dropout_slice``
    its place in the global batch."""
    if not cfg.decoder_only:
        raise NotImplementedError(
            "the port trains decoder-only LMs; seq2seq and encoder-only models are later slices"
        )
    x, _ = decoder_apply(
        params["decoder"], tar, cfg, position_offset=position_offset,
        self_mask=make_padding_mask(tar, pad_id), key=key, deterministic=deterministic,
        reference=reference, dropout_slice=dropout_slice,
    )
    return x


def transformer_apply(
    params: Params,
    inp: torch.Tensor | None,
    tar: torch.Tensor,
    cfg: ModelConfig,
    key: tuple[int, ...] | None = None,
    deterministic: bool = True,
    reference: bool = False,
    pad_id: int = PAD_ID,
    position_offset: int = 0,
    dropout_slice: GlobalSlice | None = None,
) -> torch.Tensor:
    """(B, S) token ids -> (B, S, V) raw logits (the JAX twin also returns
    attention maps; the port has none)."""
    x = transformer_hidden_apply(
        params, inp, tar, cfg, key, deterministic, reference, pad_id, position_offset,
        dropout_slice,
    )
    return project_logits(params, x, cfg)


def transformer_prefill(
    params: Params,
    tokens: torch.Tensor,
    caches: list[dict[str, Any]],
    position: int,
    cfg: ModelConfig,
    chunk: int = 0,
) -> tuple[torch.Tensor, list[dict[str, Any]]]:
    """(B, n) prompt tokens at positions ``position ..`` -> ((B, V) logits of
    the next position, caches holding every prompt position's K/V)."""
    x_last, caches = decoder_prefill(
        params["decoder"], tokens, caches, cfg, start=position, chunk=chunk
    )
    return project_logits(params, x_last[:, None, :], cfg)[:, -1, :], caches
