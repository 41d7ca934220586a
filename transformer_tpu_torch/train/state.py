"""Train state and the optimizers.

Port of ``transformer_tpu/train/state.py``: ``TrainState`` (step, params,
optimizer state), the learning-rate schedule, and the three optimizers
with optional global-norm clipping, written as plain tensor arithmetic
over the flat parameter dict so that each follows its optax chain
operation for operation:

- Adam / AdamW: ``clip_by_global_norm`` -> ``scale_by_adam`` ->
  ``add_decayed_weights`` (adamw, masked) -> ``scale_by_learning_rate``:
  bias-corrected moments, ``eps`` outside the square root;
- Adafactor, ``optax.adafactor(learning_rate=schedule)`` with optax
  0.2.6's defaults: ``clip_by_global_norm`` -> ``scale_by_factored_rms``
  (second moments factored into row and column means over the two largest
  dims of a leaf when both hold at least 128, decay ``1 - (count + 1) **
  -0.8``, ``eps`` 1e-30 added to the squared gradient) ->
  ``clip_by_block_rms(1.0)`` -> ``scale_by_learning_rate(flip_sign=False)``
  -> ``scale_by_param_block_rms`` (``min_scale`` 1e-3) -> the sign flip;
  no momentum, no weight decay.

``lr = schedule(count)`` at the count before the update (0 on the first).
The moments and the parameters are updated in place, and the per-update
scalars (Adam's bias corrections and learning rate, Adafactor's decay and
learning rate) are computed on the host and read from device memory, so a
CUDA graph of the step stays valid from one update to the next.

``state_to_flat``/``state_from_flat`` give the state the JAX
``TrainState``'s flat checkpoint names, the ones optax's state tree takes
(``step``, ``params/<name>``, ``opt_state/0/mu/<name>``,
``opt_state/0/v_row/<name>``, ...), so a checkpoint written by either
package restores in the other.
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
    FIELDS = ("mu", "nu")

    def tensors(self) -> list[torch.Tensor]:
        """Every state tensor, in a fixed order."""
        return [t for f in self.FIELDS for t in getattr(self, f).values()]


@dataclasses.dataclass
class AdafactorState:
    """optax's ``FactoredState``: per leaf, the row and column means of
    the squared gradients (factored leaves; ``(1,)`` zeros elsewhere) or
    their whole average (``v``; ``(1,)`` zeros for factored leaves)."""

    count: int
    v_row: dict[str, torch.Tensor]
    v_col: dict[str, torch.Tensor]
    v: dict[str, torch.Tensor]
    # adafactor's chain is (scale_by_factored_rms, clip_by_block_rms,
    # schedule, scale_by_param_block_rms, scale): only index 0 and the
    # schedule's count at index 2 hold leaves; clipping nests it under 1.
    path: str = "opt_state/0"
    schedule_path: str = "opt_state/2"
    FIELDS = ("v_row", "v_col", "v")

    tensors = AdamState.tensors


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


def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm: float, norm=None):
    """optax.clip_by_global_norm: every gradient scaled by ``max_norm /
    norm`` when the global norm reaches ``max_norm`` (0 = off). ``norm``
    replaces ``global_norm`` of the dict (a norm over leaves split across
    processes)."""
    if max_norm <= 0:
        return grads
    g_norm = global_norm(grads.values()) if norm is None else norm(grads)
    keep = g_norm < max_norm
    return {k: torch.where(keep, g, (g / g_norm) * max_norm) for k, g in grads.items()}


def _chain_prefix(max_grad_norm: float) -> str:
    """Where the optimizer's chain sits in the flat names: clipping nests
    it under index 1 of an outer chain."""
    return "opt_state/1/" if max_grad_norm > 0 else "opt_state/"


def decays(name: str, p: torch.Tensor) -> bool:
    """adamw's decay mask: leaves of rank >= 2 not named ``bias`` (the
    pre-split attention biases are 2-D and still exempt)."""
    return p.dim() >= 2 and name.rsplit(SEP, 1)[-1] != "bias"


class _Optimizer:
    """The update loop the optimizers share: global-norm clipping
    (``max_grad_norm`` > 0), then each leaf's ``_leaf_update`` (which
    moves that leaf's optimizer state in place) under the update's
    per-update ``scalars``."""

    max_grad_norm = 0.0
    norm = None  # the global norm of a grads dict (None: global_norm)
    # Leaves split over processes (``parallel.distributed.ParamSharding``):
    # each leaf's whole shape, this process's window of it, and sums over
    # the processes holding its other slices. None: every leaf is whole.
    sharding = None

    def _clip_and_scalars(self, grads, state, scalars):
        grads = clip_by_global_norm(grads, self.max_grad_norm, self.norm)
        if scalars is None:
            device = next(iter(grads.values())).device
            scalars = torch.from_numpy(self.scalars(state.count)).to(device)
        return grads, scalars

    def update(
        self, grads: dict[str, torch.Tensor], state,
        params: dict[str, torch.Tensor] | None = None,
        scalars: torch.Tensor | None = None,
    ):
        """(updates to add to the params, the new state), the state moved
        in place. ``scalars`` is ``self.scalars(state.count)`` on the
        grads' device (made here when None)."""
        grads, scalars = self._clip_and_scalars(grads, state, scalars)
        updates = {k: self._leaf_update(k, g, state, None if params is None else params[k],
                                        scalars)
                   for k, g in grads.items()}
        return updates, dataclasses.replace(state, count=state.count + 1)

    def step_(
        self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor], state,
        scalars: torch.Tensor | None = None,
    ):
        """``update`` added to ``params`` in place, a leaf at a time (no
        whole second copy of the parameters); returns the new state. Every
        tensor it touches keeps its address, so a CUDA graph of the step
        replays onto the same parameters and optimizer state."""
        grads, scalars = self._clip_and_scalars(grads, state, scalars)
        with torch.no_grad():
            for k, g in grads.items():
                params[k].add_(self._leaf_update(k, g, state, params[k], scalars))
        return dataclasses.replace(state, count=state.count + 1)


class Adam(_Optimizer):
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
        chain = _chain_prefix(self.max_grad_norm)
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

    def _leaf_update(self, k, g, state: AdamState, p, scalars) -> torch.Tensor:
        """Moves the leaf's ``mu`` and ``nu`` in place; returns its update.
        ``b1·mu + (1-b1)·g`` rounds as optax's ``(1-b1)·g + b1·mu``; adamw
        reads ``p``."""
        mu, nu = state.mu[k], state.nu[k]
        mu.mul_(self.b1).add_((1 - self.b1) * g)
        nu.mul_(self.b2).add_((1 - self.b2) * (g * g))
        u = (mu / scalars[0]) / (torch.sqrt(nu / scalars[1]) + self.eps)
        if self.adamw and decays(k, p):
            u = u + self.weight_decay * p.detach()
        return u * scalars[2]


def factored_dims(shape, min_dim_size_to_factor: int = 128) -> tuple[int, int] | None:
    """optax's ``_factored_dims``: (second-largest dim, largest dim) of a
    leaf of rank >= 2 whose second-largest dim holds at least
    ``min_dim_size_to_factor``, else None. numpy's argsort, as optax's, so
    ties pick the same dims."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


class Adafactor(_Optimizer):
    """optax.adafactor(learning_rate=schedule) with optax 0.2.6's defaults
    (see the module docstring), optionally chained after
    optax.clip_by_global_norm(max_grad_norm), on flat dicts of tensors."""

    # optax 0.2.6's defaults, the only values the JAX package uses.
    MIN_DIM_SIZE_TO_FACTOR = 128
    DECAY_RATE = 0.8
    CLIPPING_THRESHOLD = 1.0
    MIN_SCALE = 1e-3  # scale_by_param_block_rms
    EPS = 1e-30

    def __init__(self, schedule, max_grad_norm: float = 0.0):
        self.schedule, self.max_grad_norm = schedule, max_grad_norm

    def _split(self, k) -> bool:
        return self.sharding is not None and self.sharding.split(k)

    def _dims(self, p: torch.Tensor, k=None):
        """The factored dims, from the whole leaf's shape."""
        shape = self.sharding.shape(k) if self._split(k) else tuple(p.shape)
        return factored_dims(shape, self.MIN_DIM_SIZE_TO_FACTOR)

    def _mean(self, k, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the whole leaf ``k`` (this process holds
        its window of it)."""
        if not self._split(k):
            return torch.mean(t)
        total = torch.sum(t).reshape(1)
        self.sharding.sum_(k, [total])
        return total[0] / float(np.prod(self.sharding.shape(k)))

    def _whole_sum(self, k, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole leaf's sum of ``t`` over ``dim``: this process's
        partial sums written at its window of the other dims, then summed
        over the processes holding the leaf's other slices."""
        part = t.sum(dim=dim)
        if not self._split(k):
            return part
        shape = list(self.sharding.shape(k))
        window = list(self.sharding.bounds(k))
        del shape[dim], window[dim]
        whole = part.new_zeros(shape)
        whole[tuple(slice(a, b) for a, b in window)] = part
        self.sharding.sum_(k, [whole])
        return whole

    def _window(self, k, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This process's window of ``t``, a whole statistic that lacks the
        leaf's dim ``dim``."""
        if not self._split(k):
            return t
        window = list(self.sharding.bounds(k))
        del window[dim]
        return t[tuple(slice(a, b) for a, b in window)]

    def init(self, params: dict[str, torch.Tensor]) -> AdafactorState:
        rows, cols, full = {}, {}, {}
        for k, p in params.items():
            dims = self._dims(p, k)
            one = torch.zeros((1,), dtype=p.dtype, device=p.device)
            if dims is None:
                rows[k], cols[k], full[k] = one, one.clone(), torch.zeros_like(p)
            else:
                d1, d0 = dims
                shape = list(p.shape)
                rows[k] = torch.zeros(shape[:d0] + shape[d0 + 1:], dtype=p.dtype, device=p.device)
                cols[k] = torch.zeros(shape[:d1] + shape[d1 + 1:], dtype=p.dtype, device=p.device)
                full[k] = one
        chain = _chain_prefix(self.max_grad_norm)
        return AdafactorState(0, rows, cols, full, path=chain + "0", schedule_path=chain + "2")

    def scalars(self, count: int) -> np.ndarray:
        """The per-update scalars of the update after ``count`` updates, as
        (2,) fp32: the second moments' decay ``1 - (count + 1) ** -0.8``
        and ``-schedule(count)``. The power is numpy's fp32 one, which
        rounds as XLA's does on the CPU (torch's fp32 power is an ulp off at
        32 of the first 5,000 counts)."""
        decay = np.float32(1.0) - np.float32(count + 1) ** np.float32(-self.DECAY_RATE)
        return np.asarray([decay, -self.schedule(count)], dtype=np.float32)

    def _leaf_update(self, k, g, state: AdafactorState, p, scalars) -> torch.Tensor:
        """Moves the leaf's second moments in place; returns its update,
        which reads ``p`` (the block RMS scale)."""
        if p is None:
            raise ValueError("adafactor's update needs the params")
        decay = scalars[0]
        grad_sqr = g * g + self.EPS
        dims = self._dims(p, k)
        if dims is None:
            v = state.v[k]  # this process's window, as the leaf's
            v.mul_(decay).add_((1.0 - decay) * grad_sqr)
            u = g * v ** -0.5
        else:
            d1, d0 = dims
            v_row, v_col = state.v_row[k], state.v_col[k]  # whole on every process
            if self._split(k):
                shape = self.sharding.shape(k)
                rows = self._whole_sum(k, grad_sqr, d0) / float(shape[d0])
                cols = self._whole_sum(k, grad_sqr, d1) / float(shape[d1])
            else:
                rows, cols = grad_sqr.mean(dim=d0), grad_sqr.mean(dim=d1)
            v_row.mul_(decay).add_((1.0 - decay) * rows)
            v_col.mul_(decay).add_((1.0 - decay) * cols)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)) ** -0.5
            u = (g * self._window(k, row_factor, d0).unsqueeze(d0)
                 * (self._window(k, v_col, d1) ** -0.5).unsqueeze(d1))
        u = u / torch.clamp(torch.sqrt(self._mean(k, u * u)) / self.CLIPPING_THRESHOLD,
                            min=1.0)
        u = u * scalars[1]  # -lr: the learning rate and the final sign flip
        p = p.detach()
        rms = torch.sqrt(self._mean(k, p * p))
        return u * torch.where(rms <= self.MIN_SCALE, torch.full_like(rms, self.MIN_SCALE), rms)


def make_optimizer(model_cfg: ModelConfig, train_cfg: TrainConfig) -> Adam | Adafactor:
    """The optimizer ``train_cfg.optimizer`` names, under the schedule and
    (``max_grad_norm`` > 0) after global-norm clipping."""
    schedule = make_lr_schedule(model_cfg, train_cfg)
    if train_cfg.optimizer == "adafactor":
        return Adafactor(schedule, train_cfg.max_grad_norm)
    return Adam(
        schedule, train_cfg.adam_beta1, train_cfg.adam_beta2,
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
    for field in opt.FIELDS:
        flat.update({f"{opt.path}/{field}/{k}": v for k, v in getattr(opt, field).items()})
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
            f"the optimizer's {count}"
        )
    names = list(getattr(opt, opt.FIELDS[0]))
    params = {k: flat[f"params/{k}"].requires_grad_(True) for k in names}
    state = dataclasses.replace(opt, count=count, **{
        field: {k: flat[f"{opt.path}/{field}/{k}"] for k in names} for field in opt.FIELDS
    })
    return TrainState(int(flat["step"]), unflatten(params), state)
