"""Model assembly: parameter layout, random init, forward, vocab
projection, prefill and the decode step.

Port of ``transformer_hidden_apply``, ``transformer_apply``,
``project_logits``, ``transformer_prefill``, ``transformer_verify`` and
``transformer_decode_step`` from ``transformer_tpu/models/transformer.py``
for decoder-only LMs, seq2seq (encoder-decoder) models and encoder-only
masked LMs (the encoder stack under the key-padding mask alone, with the
vocabulary head; no decode path), plus
``param_spec`` (the JAX package's parameter tree, flattened with its
checkpoint naming) and ``init_params`` (a random init of that tree from a
``torch.Generator``; same distributions as the JAX init, different
numbers).

``tie_embeddings`` ties the source and target tables at init only, as the
JAX package does: its decoder starts from the encoder's table, but the
tree holds two leaves, each with its own gradient and Adam update. The
port keeps two tensors, the decoder's a copy of the encoder's at init.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch

from transformer_tpu_torch.config import PAD_ID, ModelConfig, is_gated
from transformer_tpu_torch.device import resolve_device
from transformer_tpu_torch.models.decoder import CrossKV, decoder_apply, decoder_prefill
from transformer_tpu_torch.models.encoder import _add_aux, _subkey, encoder_apply, layer_uses_moe
from transformer_tpu_torch.ops.masks import make_padding_mask
from transformer_tpu_torch.ops.moe import glorot_experts
from transformer_tpu_torch.ops.nn import GlobalSlice, Params, dense_apply, embedding_attend
from transformer_tpu_torch.parallel import collectives as _collectives

SEP = "/"


def _mha_spec(prefix: str, cfg: ModelConfig) -> dict[str, tuple[tuple[int, ...], str]]:
    d, h, hd, kv = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.kv_heads
    spec = {}
    for name, heads in (("query", h), ("key", kv), ("value", kv)):
        spec[prefix + f"{name}/kernel"] = ((d, heads, hd), "glorot")
        spec[prefix + f"{name}/bias"] = ((heads, hd), "zeros")
    spec[prefix + "out/kernel"] = ((h, hd, d), "glorot_out")
    spec[prefix + "out/bias"] = ((d,), "zeros")
    return spec


def _stack_spec(tower: str, cfg: ModelConfig, vocab: int, embed_init: str):
    """One tower's embedding, layers and (pre-LN) final LayerNorm."""
    d = cfg.d_model
    spec: dict[str, tuple[tuple[int, ...], str]] = {
        f"{tower}/embedding/table": ((vocab, d), embed_init),
    }
    seq2seq_decoder = tower == "decoder" and not cfg.decoder_only
    for i in range(cfg.num_layers):
        p = f"{tower}/layers/{i}/"
        if tower == "encoder":
            spec.update(_mha_spec(p + "mha/", cfg))
        else:
            spec.update(_mha_spec(p + "self_mha/", cfg))
        if seq2seq_decoder:
            spec.update(_mha_spec(p + "cross_mha/", cfg))
        if layer_uses_moe(cfg, i):
            e = cfg.moe_experts
            spec[p + "moe/router/kernel"] = ((d, e), "glorot")
            for name, d_in, d_out in (("in", d, cfg.dff), ("out", cfg.dff, d)):
                spec[p + f"moe/{name}/kernel"] = ((e, d_in, d_out), "glorot_expert")
                spec[p + f"moe/{name}/bias"] = ((e, d_out), "zeros")
        else:
            dense = [("in", d, cfg.dff), ("out", cfg.dff, d)]
            if is_gated(cfg.ffn_activation):
                dense.append(("gate", d, cfg.dff))
            for name, d_in, d_out in dense:
                spec[p + f"ffn/{name}/kernel"] = ((d_in, d_out), "glorot")
                spec[p + f"ffn/{name}/bias"] = ((d_out,), "zeros")
        norms = ("ln1", "ln2") if tower == "encoder" else ("ln1", "ln_ffn")
        if seq2seq_decoder:
            norms += ("ln2",)
        for ln in norms:
            spec[p + f"{ln}/scale"] = ((d,), "ones")
            spec[p + f"{ln}/bias"] = ((d,), "zeros")
    if cfg.norm_scheme == "pre":
        spec[f"{tower}/final_ln/scale"] = ((d,), "ones")
        spec[f"{tower}/final_ln/bias"] = ((d,), "zeros")
    return spec


def param_spec(cfg: ModelConfig) -> dict[str, tuple[tuple[int, ...], str]]:
    """Flat key -> (shape, init) in the JAX checkpoint naming
    (``decoder/layers/0/self_mha/query/kernel``), encoder first. init is
    one of "normal_embed", "glorot", "glorot_out", "glorot_expert" (an
    (E, d_in, d_out) stack, each expert drawn with fans (d_in, d_out)),
    "zeros", "ones", and "tied" for a decoder table that starts as a copy
    of the encoder's. An encoder-only model has the encoder tower alone.
    A MoE layer (``layer_uses_moe``) holds ``moe/router``, ``moe/in`` and
    ``moe/out`` in place of ``ffn/``."""
    spec: dict[str, tuple[tuple[int, ...], str]] = {}
    decoder_embed = "normal_embed"
    if cfg.encoder_only:
        spec.update(_stack_spec("encoder", cfg, cfg.input_vocab_size, "normal_embed"))
    elif not cfg.decoder_only:
        if cfg.tie_embeddings:
            if cfg.input_vocab_size != cfg.target_vocab_size:
                raise ValueError(
                    "tie_embeddings requires input_vocab_size == target_vocab_size "
                    f"({cfg.input_vocab_size} != {cfg.target_vocab_size})"
                )
            decoder_embed = "tied"
        spec.update(_stack_spec("encoder", cfg, cfg.input_vocab_size, "normal_embed"))
    if not cfg.encoder_only:
        spec.update(_stack_spec("decoder", cfg, cfg.target_vocab_size, decoder_embed))
    if not cfg.tie_output:
        spec["final/kernel"] = ((cfg.d_model, cfg.target_vocab_size), "glorot")
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
    Values come from ``generator`` on the CPU, then move to ``device``; a
    tied decoder table is a copy of the encoder's."""
    dev = resolve_device(device)
    dtype = cfg.params_dtype
    flat = {}
    for key, (shape, init) in param_spec(cfg).items():
        if init == "tied":
            t = flat["encoder/embedding/table"].clone()
        elif init == "normal_embed":
            t = torch.randn(shape, generator=generator) * cfg.d_model**-0.5
        elif init == "glorot_expert":
            t = glorot_experts(generator, *shape)
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
    """(..., d_model) hiddens -> (..., V) raw logits, tied (through the
    one tower's table) or untied; inside a model-parallel context with the
    vocabulary split over ``model``, this rank's (..., V/tp) columns."""
    if cfg.tie_output:
        tower = "encoder" if cfg.encoder_only else "decoder"
        return embedding_attend(params[tower]["embedding"], x)
    tp = _collectives.current()
    if tp is not None and tp.vocab:  # this rank's vocabulary columns
        x = _collectives.copy_to_model(x)
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
    *,
    src_offset: int = 0,
    src_slice: GlobalSlice | None = None,
    source_mask: torch.Tensor | None = None,
    return_weights: bool = False,
    return_aux: bool = False,
):
    """(B, S) target ids -> (B, S, d_model) decoder hiddens, before the
    vocab projection; with ``return_weights``, (hiddens, the attention
    maps of ``encoder_apply`` and ``decoder_apply``, with a MoE model's
    ``moe_aux_encoder`` / ``moe_aux_decoder`` sums), as the JAX twin;
    ``return_aux`` appends the whole model's summed MoE load-balance loss
    (None without MoE layers), the twin's ``_collect_moe_aux`` of those
    keys. Decoder-only: ``inp`` is ignored; the self-mask is
    ``make_padding_mask(tar)``, ANDed with causality inside attention.
    Encoder-only: ``inp`` is ignored; ``tar`` goes through the encoder
    stack under ``make_padding_mask(tar)`` alone (bidirectional), its
    dropout keyed as the encoder's (``key + (0, site)``, ``key + (layer +
    1, site)``).
    Seq2seq: ``inp`` (B, S_src) goes through the encoder under its padding
    mask, which also masks cross-attention; encoder dropout is keyed ``key
    + (0,)`` and decoder dropout ``key + (1,)``. ``key`` seeds dropout
    when not ``deterministic``; ``reference`` runs the flash kernels'
    plain versions.

    Under a data × sequence split, ``tar`` (and ``inp``) are this
    process's part: ``position_offset`` and ``dropout_slice`` place the
    target part in the global batch, ``src_offset`` and ``src_slice`` the
    source part (each side is padded to its own multiple of ``seq``). With
    a sequence-parallel context active over more than one process, the
    encoder output is gathered to the whole source once, before the
    decoder stack (``parallel.seq_context.gather_sequence``), and
    cross-attention reads it under ``source_mask``, the whole source's
    (B, 1, 1, S_src) padding mask."""
    def result(x, maps, aux):
        out = (x, maps) if return_weights else (x,)
        return (*out, aux) if return_aux else (out if return_weights else x)

    self_mask = make_padding_mask(tar, pad_id)
    if cfg.encoder_only:
        out = encoder_apply(
            params["encoder"], tar, self_mask, cfg, key, deterministic, reference,
            position_offset=position_offset, dropout_slice=dropout_slice,
            return_weights=return_weights, return_aux=True,
        )
        return result(out[0], out[1] if return_weights else None, out[-1])
    kw = dict(self_mask=self_mask, deterministic=deterministic, reference=reference,
              position_offset=position_offset, dropout_slice=dropout_slice,
              return_weights=return_weights, return_aux=True)
    if cfg.decoder_only:
        out = decoder_apply(params["decoder"], tar, cfg, key=key, **kw)
        return result(out[0], out[2] if return_weights else None, out[-1])
    if inp is None:
        raise ValueError("a seq2seq model needs the source ids")
    from transformer_tpu_torch.parallel.seq_context import (
        current_seq_context, gather_sequence, sequence_parallel,
    )

    enc_mask = make_padding_mask(inp, pad_id)
    ctx = current_seq_context()
    # The source chunk starts at its own offset (rope rotates at it).
    with (contextlib.nullcontext() if ctx is None
          else sequence_parallel(dataclasses.replace(ctx, offset=src_offset))):
        enc = encoder_apply(
            params["encoder"], inp, enc_mask, cfg, _subkey(key, 0), deterministic, reference,
            position_offset=src_offset, dropout_slice=src_slice, return_weights=return_weights,
            return_aux=True,
        )
    enc_out, enc_maps, enc_aux = enc[0], enc[1] if return_weights else {}, enc[-1]
    if ctx is not None and ctx.size > 1:
        if source_mask is None:
            raise ValueError("under sequence parallelism cross-attention needs the whole "
                             "source's padding mask (source_mask)")
        enc_out, enc_mask = gather_sequence(enc_out, ctx), source_mask
    out = decoder_apply(
        params["decoder"], tar, cfg, enc_out=enc_out, cross_mask=enc_mask,
        key=_subkey(key, 1), **kw,
    )
    return result(out[0], {**enc_maps, **out[2]} if return_weights else None,
                  _add_aux(enc_aux, out[-1]))


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
    return_weights: bool = False,
    return_aux: bool = False,
):
    """(B, S) target ids (and, seq2seq, (B, S_src) source ids) -> (B, S, V)
    raw logits; with ``return_weights``, (logits, the attention maps), as
    the JAX twin returns them; ``return_aux`` appends the summed MoE
    load-balance loss (None without MoE layers)."""
    out = transformer_hidden_apply(
        params, inp, tar, cfg, key, deterministic, reference, pad_id, position_offset,
        dropout_slice, return_weights=return_weights, return_aux=return_aux,
    )
    if not (return_weights or return_aux):
        return project_logits(params, out, cfg)
    return (project_logits(params, out[0], cfg), *out[1:])


def transformer_prefill(
    params: Params,
    tokens: torch.Tensor,
    caches: list[dict[str, Any]],
    position: int,
    cfg: ModelConfig,
    chunk: int = 0,
    *,
    enc_out: torch.Tensor | None = None,
    cross_mask: torch.Tensor | None = None,
    cross_kvs: list[CrossKV] | None = None,
) -> tuple[torch.Tensor, list[dict[str, Any]]]:
    """(B, n) prompt tokens at positions ``position ..`` -> ((B, V) logits of
    the next position, caches holding every prompt position's K/V). A
    seq2seq decoder attends over ``enc_out`` (or its ``cross_kvs``) under
    ``cross_mask``."""
    x_last, caches = decoder_prefill(
        params["decoder"], tokens, caches, cfg, start=position, chunk=chunk,
        enc_out=enc_out, cross_mask=cross_mask, cross_kvs=cross_kvs,
    )
    return project_logits(params, x_last[:, None, :], cfg)[:, -1, :], caches


def transformer_verify(
    params: Params,
    tokens: torch.Tensor,
    caches: list[dict[str, Any]],
    position: int,
    cfg: ModelConfig,
) -> tuple[torch.Tensor, list[dict[str, Any]]]:
    """Speculative decoding's verify forward over dense caches: (B, W)
    candidate tokens at positions ``position .. position + W - 1`` ->
    ((B, W, V) logits of EVERY fed position, updated caches).
    ``logits[:, j]`` is the next-token distribution after ``tokens[:, :j +
    1]``, which the acceptance rule compares with ``tokens[:, j + 1]``.
    The S_q > 1 cache write is ``transformer_prefill``'s; unlike prefill,
    every position is projected to the vocab. Rejected candidates roll back
    with ``ops.attention.rollback_cache`` (decoder-only models)."""
    x, caches = decoder_apply(params["decoder"], tokens, cfg, caches, position_offset=position)
    return project_logits(params, x, cfg), caches


def transformer_decode_step(
    params: Params,
    token: torch.Tensor,
    caches: list[dict[str, Any]],
    position: int,
    cfg: ModelConfig,
    *,
    enc_out: torch.Tensor | None = None,
    cross_mask: torch.Tensor | None = None,
    cross_kvs: list[CrossKV] | None = None,
) -> tuple[torch.Tensor, list[dict[str, Any]]]:
    """One KV-cached step: (B, 1) token at ``position`` -> ((B, V) logits of
    the next position, updated caches). Pass ``cross_kvs`` from
    ``precompute_cross_kvs`` so the encoder output is projected once."""
    x, caches = decoder_apply(
        params["decoder"], token, cfg, caches, position_offset=position,
        enc_out=enc_out, cross_mask=cross_mask, cross_kvs=cross_kvs,
    )
    return project_logits(params, x, cfg)[:, -1, :], caches
