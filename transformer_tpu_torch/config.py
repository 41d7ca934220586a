"""Model configuration for the PyTorch port.

Field-for-field twins of ``transformer_tpu/config.py`` ``ModelConfig``,
``TrainConfig`` and ``MeshConfig``: same names, same defaults, same validation, so an
export's ``config.json`` loads into either package. The only difference
is what the dtype properties return: ``torch.dtype`` objects instead of
jnp dtypes. The activation list is kept here (the JAX package reads it
from its FFN op module, which imports jax).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping

import torch

# Special-token convention: pad = 0; BOS = subword_vocab_size; EOS =
# subword_vocab_size + 1, so a model's embedding table has
# subword_vocab_size + 2 rows.
PAD_ID = 0

# The six FFN activations; the gated variants apply the activation to the
# gate branch (ops/ffn.py).
GATED_ACTIVATIONS = ("geglu", "reglu", "swiglu")
FFN_ACTIVATIONS = ("geglu", "gelu", "reglu", "relu", "silu", "swiglu")

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def is_gated(activation: str) -> bool:
    return activation in GATED_ACTIVATIONS


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture of one Transformer; see the JAX twin for what each
    field means. Defaults: 4 layers, d_model=512, dff=1024, 4 heads."""

    num_layers: int = 4
    d_model: int = 512
    num_heads: int = 4
    num_kv_heads: int = 0  # 0 = num_heads (plain multi-head attention)
    dff: int = 1024
    input_vocab_size: int = 32000
    target_vocab_size: int = 32000
    dropout_rate: float = 0.1
    max_position: int = 4096
    norm_scheme: str = "post"  # "post" | "pre"
    position_scheme: str = "sinusoidal"  # "sinusoidal" | "rope"
    layernorm_epsilon: float = 1e-6
    tie_embeddings: bool = False
    tie_output: bool = False
    decoder_only: bool = False
    encoder_only: bool = False
    ffn_activation: str = "relu"  # relu | gelu | silu | swiglu | geglu | reglu
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    attention_impl: str = "xla"
    flash_block_q: int = 128
    flash_block_k: int = 128
    remat: bool = False
    remat_policy: str = "full"  # "full" | "dots"
    attention_window: int = 0
    kv_cache_int8: bool = False
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_every: int = 1
    moe_aux_weight: float = 0.01

    def __post_init__(self) -> None:
        if self.d_model % self.num_heads != 0:
            raise ValueError(
                f"d_model ({self.d_model}) must be divisible by num_heads "
                f"({self.num_heads})"
            )
        if self.encoder_only and self.decoder_only:
            raise ValueError(
                "encoder_only and decoder_only are mutually exclusive"
            )
        if self.encoder_only and self.input_vocab_size != self.target_vocab_size:
            raise ValueError(
                "encoder_only models use one id space: input_vocab_size "
                f"({self.input_vocab_size}) must equal target_vocab_size "
                f"({self.target_vocab_size})"
            )
        if self.norm_scheme not in ("post", "pre"):
            raise ValueError(f"norm_scheme must be 'post' or 'pre', got {self.norm_scheme!r}")
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(
                f"remat_policy must be 'full' or 'dots', got {self.remat_policy!r}"
            )
        if self.attention_window < 0:
            raise ValueError(
                f"attention_window must be >= 0, got {self.attention_window}"
            )
        if self.position_scheme not in ("sinusoidal", "rope"):
            raise ValueError(
                f"position_scheme must be 'sinusoidal' or 'rope', got "
                f"{self.position_scheme!r}"
            )
        if self.position_scheme == "rope" and (self.d_model // self.num_heads) % 2:
            raise ValueError(
                "position_scheme='rope' needs an even head_dim "
                f"(got {self.d_model // self.num_heads})"
            )
        if self.ffn_activation not in FFN_ACTIVATIONS:
            raise ValueError(f"unknown ffn_activation {self.ffn_activation!r}")
        if self.moe_experts and is_gated(self.ffn_activation):
            raise ValueError(
                "MoE experts use the ungated FFN: pick an ungated activation "
                f"with moe_experts > 0 (got {self.ffn_activation!r})"
            )
        if self.attention_impl not in ("xla", "flash", "ring", "ulysses"):
            raise ValueError(f"unknown attention_impl {self.attention_impl!r}")
        if self.moe_experts < 0 or self.moe_top_k < 1 or self.moe_every < 1:
            raise ValueError(
                "moe_experts must be >= 0, moe_top_k and moe_every >= 1 "
                f"(got {self.moe_experts}/{self.moe_top_k}/{self.moe_every})"
            )
        if self.moe_experts and self.moe_top_k > self.moe_experts:
            raise ValueError(
                f"moe_top_k ({self.moe_top_k}) cannot exceed moe_experts "
                f"({self.moe_experts})"
            )
        if self.num_kv_heads < 0 or self.num_kv_heads > self.num_heads or (
            self.num_kv_heads and self.num_heads % self.num_kv_heads
        ):
            raise ValueError(
                f"num_kv_heads ({self.num_kv_heads}) must be 0 (= num_heads) "
                f"or a positive divisor of num_heads ({self.num_heads})"
            )

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def params_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-engine knobs; see the JAX twin for what each field means.
    The pipeline-parallel fields (``pp_microbatches``, ``pp_schedule``)
    are validated but not used: the port has no pipe axis yet.
    ``buffer_size`` is the streaming shuffle buffer the CLI passes to
    ``load_dataset``."""

    batch_size: int = 64
    sequence_length: int = 50
    epochs: int = 4
    warmup_steps: int = 60000
    lr_schedule: str = "noam"  # "noam" | "cosine" | "constant"
    peak_lr: float = 0.0
    lr_decay_steps: int = 0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.98
    adam_epsilon: float = 1e-9
    optimizer: str = "adam"  # "adam" | "adafactor" | "adamw"
    weight_decay: float = 0.0  # adamw only
    label_smoothing: float = 0.0
    loss_normalization: str = "tokens"  # "tokens" | "batch"
    max_grad_norm: float = 0.0  # 0 disables clipping
    buffer_size: int = 100000
    eval_every_steps: int = 500
    eval_max_batches: int = 8  # in-loop eval cap; 0 = the full test set
    early_stop_patience: int = 0
    log_every_steps: int = 100
    checkpoint_every_epochs: int = 5
    max_ckpt_keep: int = 5
    ckpt_path: str = "model_dist"
    enable_function: bool = True
    seed: int = 0
    pp_microbatches: int = 0
    pp_schedule: str = "gpipe"  # "gpipe" | "1f1b"
    grad_accum_steps: int = 1
    loss_chunks: int = 1
    steps_per_dispatch: int = 1
    objective: str = "causal"  # "causal" | "mlm"
    mlm_mask_rate: float = 0.15
    mlm_excluded_ids: tuple[int, ...] | None = None

    def __post_init__(self) -> None:
        if self.loss_normalization not in ("tokens", "batch"):
            raise ValueError(
                f"loss_normalization must be 'tokens' or 'batch', got {self.loss_normalization!r}"
            )
        if self.objective not in ("causal", "mlm"):
            raise ValueError(
                f"objective must be 'causal' or 'mlm', got {self.objective!r}"
            )
        if not 0.0 < self.mlm_mask_rate < 1.0:
            raise ValueError(
                f"mlm_mask_rate must be in (0, 1), got {self.mlm_mask_rate}"
            )
        if self.pp_schedule not in ("gpipe", "1f1b"):
            raise ValueError(
                f"pp_schedule must be 'gpipe' or '1f1b', got {self.pp_schedule!r}"
            )
        if self.optimizer not in ("adam", "adafactor", "adamw"):
            raise ValueError(
                "optimizer must be 'adam', 'adafactor' or 'adamw', got "
                f"{self.optimizer!r}"
            )
        if self.weight_decay and self.optimizer != "adamw":
            raise ValueError(
                "weight_decay > 0 requires optimizer='adamw' (adam/adafactor "
                "would silently ignore it)"
            )
        if self.lr_schedule not in ("noam", "cosine", "constant"):
            raise ValueError(
                f"lr_schedule must be noam/cosine/constant, got {self.lr_schedule!r}"
            )
        if self.lr_schedule != "noam" and self.peak_lr <= 0:
            raise ValueError(
                f"lr_schedule={self.lr_schedule!r} needs peak_lr > 0"
            )
        if self.lr_schedule == "cosine" and self.lr_decay_steps <= self.warmup_steps:
            raise ValueError(
                "lr_schedule='cosine' needs lr_decay_steps > warmup_steps "
                f"(got {self.lr_decay_steps} <= {self.warmup_steps})"
            )
        if self.steps_per_dispatch < 1:
            raise ValueError(
                f"steps_per_dispatch must be >= 1, got {self.steps_per_dispatch}"
            )


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical process mesh, the JAX twin's axes in its order: ``data``
    (gradient sum), ``fsdp``, ``model``, ``seq`` (ring attention),
    ``pipe``, ``expert``; ``dcn_data`` is how many hosts the data axis
    spans. The port runs ``data`` and ``seq``: ``DistributedTrainer``
    raises ``NotImplementedError`` on any other axis above 1 and on
    ``dcn_data`` above 1."""

    data: int = 1
    fsdp: int = 1
    model: int = 1
    seq: int = 1
    pipe: int = 1
    expert: int = 1
    dcn_data: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.fsdp * self.model * self.seq * self.pipe * self.expert

    @property
    def axis_names(self) -> tuple[str, ...]:
        return ("data", "fsdp", "model", "seq", "pipe", "expert")

    @property
    def axis_sizes(self) -> tuple[int, ...]:
        return (self.data, self.fsdp, self.model, self.seq, self.pipe, self.expert)


def config_to_json(cfg: Any) -> str:
    """Serialize a config dataclass to JSON (the export's ``config.json``)."""
    return json.dumps(dataclasses.asdict(cfg), indent=2, sort_keys=True)


def config_from_json(cls: type, payload: str | Mapping[str, Any]):
    data = json.loads(payload) if isinstance(payload, str) else dict(payload)
    known = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in data.items() if k in known})
