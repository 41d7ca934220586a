"""Train state and the optimizer.

Port of ``transformer_tpu/train/state.py`` for ``optimizer="adam"``:
``TrainState`` (step, params, optimizer state), the learning-rate schedule
and Adam with optional global-norm clipping, written as plain tensor
arithmetic over the flat parameter dict so that it follows optax's
``clip_by_global_norm`` -> ``scale_by_adam`` -> ``scale_by_learning_rate``
chain operation for operation: bias-corrected moments, ``eps`` outside the
square root, and ``lr = schedule(count)`` at the count before the update
(0 on the first). "adamw" and "adafactor" are not ported.
"""

from __future__ import annotations

import dataclasses

import torch

from transformer_tpu_torch.config import ModelConfig, TrainConfig
from transformer_tpu_torch.models.transformer import flatten, init_params
from transformer_tpu_torch.ops.nn import Params
from transformer_tpu_torch.train.schedule import (
    constant_schedule,
    cosine_schedule,
    noam_schedule,
)


@dataclasses.dataclass
class AdamState:
    count: int
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    step: int
    params: Params  # nested, leaves are fp32 tensors that require grad
    opt_state: AdamState


def make_lr_schedule(model_cfg: ModelConfig, train_cfg: TrainConfig):
    """The learning-rate schedule the optimizer applies."""
    if train_cfg.lr_schedule == "cosine":
        return cosine_schedule(train_cfg.peak_lr, train_cfg.warmup_steps, train_cfg.lr_decay_steps)
    if train_cfg.lr_schedule == "constant":
        return constant_schedule(train_cfg.peak_lr, train_cfg.warmup_steps)
    return noam_schedule(model_cfg.d_model, train_cfg.warmup_steps)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (fp32 scalar)."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


class Adam:
    """optax.adam(schedule, b1, b2, eps), optionally chained after
    optax.clip_by_global_norm(max_grad_norm), on flat dicts of tensors."""

    def __init__(self, schedule, b1: float, b2: float, eps: float, max_grad_norm: float = 0.0):
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps
        self.max_grad_norm = max_grad_norm

    def init(self, params: dict[str, torch.Tensor]) -> AdamState:
        mu = {k: torch.zeros_like(p) for k, p in params.items()}
        return AdamState(0, mu, {k: torch.zeros_like(p) for k, p in params.items()})

    def update(
        self, grads: dict[str, torch.Tensor], state: AdamState
    ) -> tuple[dict[str, torch.Tensor], AdamState]:
        """(updates to add to the params, the new state)."""
        if self.max_grad_norm > 0:
            g_norm = global_norm(grads.values())
            keep = g_norm < self.max_grad_norm
            grads = {
                k: torch.where(keep, g, (g / g_norm) * self.max_grad_norm)
                for k, g in grads.items()
            }
        count = state.count + 1
        one = torch.tensor(1.0, dtype=torch.float32)
        bc1 = float(one - torch.tensor(self.b1, dtype=torch.float32) ** count)
        bc2 = float(one - torch.tensor(self.b2, dtype=torch.float32) ** count)
        step_size = -self.schedule(state.count)
        mu, nu, updates = {}, {}, {}
        for k, g in grads.items():
            mu[k] = (1 - self.b1) * g + self.b1 * state.mu[k]
            nu[k] = (1 - self.b2) * (g * g) + self.b2 * state.nu[k]
            updates[k] = step_size * ((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + self.eps))
        return updates, AdamState(count, mu, nu)


def make_optimizer(model_cfg: ModelConfig, train_cfg: TrainConfig) -> Adam:
    if train_cfg.optimizer != "adam":
        raise NotImplementedError(
            f"optimizer={train_cfg.optimizer!r} is not ported yet; the port trains with adam"
        )
    return Adam(
        make_lr_schedule(model_cfg, train_cfg), train_cfg.adam_beta1, train_cfg.adam_beta2,
        train_cfg.adam_epsilon, train_cfg.max_grad_norm,
    )


def create_train_state(
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    params: Params | None = None,
    generator: torch.Generator | None = None,
    device="cuda",
) -> TrainState:
    """Step 0 from ``params`` (e.g. converted from a JAX init), or from a
    random init drawn from ``generator`` (default: seeded with
    ``train_cfg.seed``) on ``device``."""
    if params is None:
        gen = generator or torch.Generator().manual_seed(train_cfg.seed)
        params = init_params(model_cfg, gen, device=device)
    for p in flatten(params).values():
        p.requires_grad_(True)
    tx = make_optimizer(model_cfg, train_cfg)
    return TrainState(step=0, params=params, opt_state=tx.init(flatten(params)))
