"""The config matrix the analyses trace.

Port of ``transformer_tpu/analysis/configs.py``, the same names and values
in the port's ``ModelConfig`` and ``TrainConfig``. Tiny on purpose: the
cost model traces on the ``meta`` device (no device execution), so its
cost is trace time, which scales with layer COUNT, not width.
``FAST_MATRIX`` is the set of every cache variant; ``FULL_MATRIX`` adds
the architectural spread (pre-LN, RoPE, tied weights, gated FFN, fp32).
"""

from __future__ import annotations

import dataclasses

from transformer_tpu_torch.config import ModelConfig, TrainConfig

_TINY = dict(
    num_layers=2,
    d_model=16,
    num_heads=2,
    dff=32,
    input_vocab_size=64,
    target_vocab_size=64,
    max_position=64,
    dropout_rate=0.0,
    dtype="bfloat16",
)


def _cfg(**over) -> ModelConfig:
    return ModelConfig(**{**_TINY, **over})


# name -> ModelConfig. Names are stable identifiers (baseline-able, and the
# CLI/json output keys results by them).
FAST_MATRIX: dict[str, ModelConfig] = {
    "seq2seq_bf16": _cfg(),
    "lm_bf16": _cfg(decoder_only=True),
    "lm_int8_cache": _cfg(decoder_only=True, kv_cache_int8=True),
    "lm_window": _cfg(decoder_only=True, attention_window=8),
    "lm_gqa": _cfg(decoder_only=True, num_kv_heads=1),
}

FULL_MATRIX: dict[str, ModelConfig] = {
    **FAST_MATRIX,
    "seq2seq_fp32": _cfg(dtype="float32"),
    "seq2seq_prenorm": _cfg(norm_scheme="pre"),
    "seq2seq_tied": _cfg(tie_embeddings=True, tie_output=True),
    "lm_rope": _cfg(decoder_only=True, position_scheme="rope"),
    "lm_gqa_int8": _cfg(decoder_only=True, num_kv_heads=1, kv_cache_int8=True),
    "lm_window_int8": _cfg(
        decoder_only=True, attention_window=8, kv_cache_int8=True
    ),
    "lm_swiglu": _cfg(decoder_only=True, ffn_activation="swiglu"),
    "mlm_bf16": _cfg(encoder_only=True),
}

TINY_TRAIN = TrainConfig(
    batch_size=2,
    sequence_length=8,
    epochs=1,
    warmup_steps=10,
    label_smoothing=0.1,
)


def matrix(name: str) -> dict[str, ModelConfig]:
    if name == "fast":
        return dict(FAST_MATRIX)
    if name == "full":
        return dict(FULL_MATRIX)
    raise ValueError(f"unknown config matrix {name!r} (fast|full)")


def describe(cfg: ModelConfig) -> str:
    """Short human label: the non-default knobs only."""
    base = ModelConfig()
    diffs = []
    for f in dataclasses.fields(ModelConfig):
        v = getattr(cfg, f.name)
        if v != getattr(base, f.name):
            diffs.append(f"{f.name}={v}")
    return ", ".join(diffs) or "defaults"
