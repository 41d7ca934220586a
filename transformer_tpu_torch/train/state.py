"""Train state and the optimizer.

Port of ``transformer_tpu/train/state.py`` for ``optimizer="adam"`` and
``"adamw"``: ``TrainState`` (step, params, optimizer state), the
learning-rate schedule and Adam with optional global-norm clipping and
decoupled weight decay, written as plain tensor arithmetic over the flat
parameter dict so that it follows optax's ``clip_by_global_norm`` ->
``scale_by_adam`` -> ``add_decayed_weights`` (adamw, masked) ->
``scale_by_learning_rate`` chain operation for operation: bias-corrected
moments, ``eps`` outside the square root, and ``lr = schedule(count)`` at
the count before the update (0 on the first). The moments and the
parameters are updated in place, and the per-update scalars (the bias
corrections and the learning rate) are computed on the host and read from
device memory, so a CUDA graph of the step stays valid from one update to
the next. "adafactor" is not ported.

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

    def scalars(self, count: int) -> np.ndarray:
        """The per-update scalars of the update after ``count`` updates, as
        (3,) fp32: the bias corrections ``1 - b1^(count+1)`` and ``1 -
        b2^(count+1)`` (fp32 powers, as the jitted optax step rounds
        them) and ``-schedule(count)``. The host computes them; the update
        reads them from device memory, so a captured step reads each
        replay's own values."""
        n = count + 1
        one = torch.tensor(1.0, dtype=torch.float32)
        bc1 = one - torch.tensor(self.b1, dtype=torch.float32) ** n
        bc2 = one - torch.tensor(self.b2, dtype=torch.float32) ** n
        return np.asarray([float(bc1), float(bc2), -self.schedule(count)], dtype=np.float32)

    def _clip(self, grads: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        if self.max_grad_norm <= 0:
            return grads
        g_norm = global_norm(grads.values())
        keep = g_norm < self.max_grad_norm
        return {k: torch.where(keep, g, (g / g_norm) * self.max_grad_norm)
                for k, g in grads.items()}

    def _leaf_update(self, name, g, mu, nu, p, scalars) -> torch.Tensor:
        """Moves ``mu`` and ``nu`` in place; returns the leaf's update.
        ``b1·mu + (1-b1)·g`` rounds as optax's ``(1-b1)·g + b1·mu``."""
        mu.mul_(self.b1).add_((1 - self.b1) * g)
        nu.mul_(self.b2).add_((1 - self.b2) * (g * g))
        u = (mu / scalars[0]) / (torch.sqrt(nu / scalars[1]) + self.eps)
        if self.adamw and decays(name, p):
            u = u + self.weight_decay * p.detach()
        return u * scalars[2]

    def _scalars_on(self, count: int, scalars, like: torch.Tensor) -> torch.Tensor:
        if scalars is None:
            return torch.from_numpy(self.scalars(count)).to(like.device)
        return scalars

    def update(
        self, grads: dict[str, torch.Tensor], state: AdamState,
        params: dict[str, torch.Tensor] | None = None,
        scalars: torch.Tensor | None = None,
    ) -> tuple[dict[str, torch.Tensor], AdamState]:
        """(updates to add to the params, the new state), the moments moved
        in place; adamw reads ``params``. ``scalars`` is
        ``self.scalars(state.count)`` on the grads' device (made here when
        None)."""
        grads = self._clip(grads)
        scalars = self._scalars_on(state.count, scalars, next(iter(grads.values())))
        updates = {
            k: self._leaf_update(k, g, state.mu[k], state.nu[k], None if params is None
                                 else params[k], scalars)
            for k, g in grads.items()
        }
        return updates, dataclasses.replace(state, count=state.count + 1)

    def step_(
        self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
        state: AdamState, scalars: torch.Tensor | None = None,
    ) -> AdamState:
        """``update`` added to ``params`` in place, a leaf at a time (no
        whole second copy of the parameters); returns the new state. Every
        tensor it touches keeps its address, so a CUDA graph of the step
        replays onto the same parameters and moments."""
        grads = self._clip(grads)
        scalars = self._scalars_on(state.count, scalars, next(iter(grads.values())))
        with torch.no_grad():
            for k, g in grads.items():
                params[k].add_(
                    self._leaf_update(k, g, state.mu[k], state.nu[k], params[k], scalars)
                )
        return dataclasses.replace(state, count=state.count + 1)


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
