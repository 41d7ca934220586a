"""Train state and the optimizer.

Port of ``transformer_tpu/train/state.py`` for ``optimizer="adam"`` and
``"adamw"``: ``TrainState`` (step, params, optimizer state), the
learning-rate schedule and Adam with optional global-norm clipping and
decoupled weight decay, written as plain tensor arithmetic over the flat
parameter dict so that it follows optax's ``clip_by_global_norm`` ->
``scale_by_adam`` -> ``add_decayed_weights`` (adamw, masked) ->
``scale_by_learning_rate`` chain operation for operation: bias-corrected
moments, ``eps`` outside the square root, and ``lr = schedule(count)`` at
the count before the update (0 on the first). "adafactor" is not ported.

``state_to_flat``/``state_from_flat`` give the state the JAX
``TrainState``'s flat checkpoint names, the ones optax's state tree takes
(``step``, ``params/<name>``, ``opt_state/0/mu/<name>``, ...), so a
checkpoint written by either package restores in the other.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from transformer_tpu_torch.config import ModelConfig, TrainConfig
from transformer_tpu_torch.models.transformer import SEP, flatten, init_params, unflatten
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
    # Where optax's chain keeps the moments and the schedule's count in the
    # flat checkpoint names: adam's chain is (scale_by_adam, schedule);
    # adamw's puts its masked decay (no leaves) between them, pushing the
    # schedule to index 2; clipping nests the chain under index 1.
    path: str = "opt_state/0"
    schedule_path: str = "opt_state/1"


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


def decays(name: str, p: torch.Tensor) -> bool:
    """adamw's decay mask: leaves of rank >= 2 not named ``bias`` (the
    pre-split attention biases are 2-D and still exempt)."""
    return p.dim() >= 2 and name.rsplit(SEP, 1)[-1] != "bias"


class Adam:
    """optax.adam(schedule, b1, b2, eps), or optax.adamw with the same and
    ``weight_decay`` on the leaves ``decays`` picks (``adamw=True``),
    optionally chained after optax.clip_by_global_norm(max_grad_norm), on
    flat dicts of tensors."""

    def __init__(
        self, schedule, b1: float, b2: float, eps: float, max_grad_norm: float = 0.0,
        weight_decay: float = 0.0, adamw: bool = False,
    ):
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps
        self.max_grad_norm = max_grad_norm
        self.weight_decay, self.adamw = weight_decay, adamw

    def init(self, params: dict[str, torch.Tensor]) -> AdamState:
        mu = {k: torch.zeros_like(p) for k, p in params.items()}
        chain = "opt_state/1/" if self.max_grad_norm > 0 else "opt_state/"
        return AdamState(
            0, mu, {k: torch.zeros_like(p) for k, p in params.items()},
            path=chain + "0", schedule_path=chain + ("2" if self.adamw else "1"),
        )

    def update(
        self, grads: dict[str, torch.Tensor], state: AdamState,
        params: dict[str, torch.Tensor] | None = None,
    ) -> tuple[dict[str, torch.Tensor], AdamState]:
        """(updates to add to the params, the new state); adamw reads
        ``params``."""
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
            u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + self.eps)
            if self.adamw and decays(k, params[k]):
                u = u + self.weight_decay * params[k].detach()
            updates[k] = step_size * u
        return updates, dataclasses.replace(state, count=count, mu=mu, nu=nu)


def make_optimizer(model_cfg: ModelConfig, train_cfg: TrainConfig) -> Adam:
    if train_cfg.optimizer not in ("adam", "adamw"):
        raise NotImplementedError(
            f"optimizer={train_cfg.optimizer!r} is not ported yet; the port trains with "
            "adam or adamw"
        )
    return Adam(
        make_lr_schedule(model_cfg, train_cfg), train_cfg.adam_beta1, train_cfg.adam_beta2,
        train_cfg.adam_epsilon, train_cfg.max_grad_norm, train_cfg.weight_decay,
        adamw=train_cfg.optimizer == "adamw",
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


def state_to_flat(state: TrainState) -> dict[str, Any]:
    """The state under the JAX ``TrainState``'s flat checkpoint names:
    ``step`` and the two optimizer counts as 0-d int32 arrays, the params
    and moments as the state's own tensors (not copied)."""
    opt = state.opt_state
    flat: dict[str, Any] = {"step": np.asarray(state.step, np.int32)}
    flat.update({f"params/{k}": v for k, v in flatten(state.params).items()})
    flat[f"{opt.path}/count"] = np.asarray(opt.count, np.int32)
    flat.update({f"{opt.path}/mu/{k}": v for k, v in opt.mu.items()})
    flat.update({f"{opt.path}/nu/{k}": v for k, v in opt.nu.items()})
    flat[f"{opt.schedule_path}/count"] = np.asarray(opt.count, np.int32)
    return flat


def state_from_flat(flat: dict[str, Any], template: TrainState) -> TrainState:
    """The inverse of ``state_to_flat`` in ``template``'s layout: ``flat``
    holds tensors under the template's names (checked by the caller).
    Raises ValueError when the two optimizer counts disagree."""
    opt = template.opt_state
    count = int(flat[f"{opt.path}/count"])
    if int(flat[f"{opt.schedule_path}/count"]) != count:
        raise ValueError(
            f"the schedule's count {int(flat[f'{opt.schedule_path}/count'])} differs from "
            f"adam's {count}"
        )
    names = list(opt.mu)
    params = {k: flat[f"params/{k}"].requires_grad_(True) for k in names}
    state = dataclasses.replace(
        opt, count=count,
        mu={k: flat[f"{opt.path}/mu/{k}"] for k in names},
        nu={k: flat[f"{opt.path}/nu/{k}"] for k in names},
    )
    return TrainState(int(flat["step"]), unflatten(params), state)
