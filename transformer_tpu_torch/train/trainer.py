"""Train and eval steps and the epoch loop.

Port of ``transformer_tpu/train/trainer.py`` on its plain single-card
path, for decoder-only LMs and seq2seq models (``src`` into the encoder,
``tgt[:, :-1]`` into the decoder, ``tgt[:, 1:]`` scored):
``make_train_step`` (teacher-forcing shift, forward with dropout
keyed on (seed, step), masked CE, backward, Adam with the pre-clip
``grad_norm`` metric), ``make_eval_step``, ``MetricAccumulator`` and
``Trainer.fit`` reduced to epochs, periodic logging, bounded in-loop eval
and the full end-of-epoch eval. The steps take two hooks that
``parallel.distributed.DistributedTrainer`` fills: the forward-and-loss
function, and a sum across processes for the gradients and the metric
sums. Checkpoints, telemetry, preemption,
gradient accumulation, multi-step dispatch and the chunked loss are not
ported: the configs that ask for them raise.
"""

from __future__ import annotations

import time
from collections.abc import Callable, Iterable
from typing import Any

import numpy as np
import torch

from transformer_tpu_torch.config import ModelConfig, TrainConfig
from transformer_tpu_torch.device import resolve_device, synchronize
from transformer_tpu_torch.models.transformer import flatten, transformer_apply
from transformer_tpu_torch.train.loss import masked_cross_entropy
from transformer_tpu_torch.train.state import Adam, TrainState, global_norm, make_optimizer


def _check_supported(model_cfg: ModelConfig, train_cfg: TrainConfig) -> None:
    if train_cfg.objective != "causal" or model_cfg.encoder_only:
        raise NotImplementedError(
            "the port trains decoder-only LMs and seq2seq models with the causal "
            "objective; masked-LM training is a later slice"
        )
    for name in ("grad_accum_steps", "steps_per_dispatch", "loss_chunks"):
        if getattr(train_cfg, name) > 1:
            raise NotImplementedError(f"{name} > 1 is not ported yet")


def _batch(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x)).to(device=device, dtype=torch.long)


def _source(src, model_cfg: ModelConfig, device) -> torch.Tensor | None:
    """The source batch on ``device`` for a seq2seq model, else None (an LM
    batch's src repeats its tgt)."""
    return None if model_cfg.decoder_only else _batch(src, device)


def _forward_loss(params, tgt, model_cfg, train_cfg, key, reference=False, src=None):
    """Feed ``tgt[:, :-1]`` (and, seq2seq, ``src`` to the encoder), predict
    ``tgt[:, 1:]``: (loss, metric sums). Dropout is keyed on ``key``; None
    runs deterministically."""
    logits = transformer_apply(
        params, src, tgt[:, :-1], model_cfg, key=key, deterministic=key is None,
        reference=reference,
    )
    return masked_cross_entropy(
        logits, tgt[:, 1:], label_smoothing=train_cfg.label_smoothing,
        normalization=train_cfg.loss_normalization, batch_size=train_cfg.batch_size,
    )


def loss_and_grads(
    params,
    tgt: torch.Tensor,
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    key: tuple[int, ...] | None,
    reference: bool = False,
    forward_loss: Callable | None = None,
    src: torch.Tensor | None = None,
) -> tuple[dict, dict[str, torch.Tensor]]:
    """One forward and backward on a (B, L) batch (dropout keyed on
    ``key``, none for None); ``src`` is the seq2seq source batch. Returns
    (metrics, grads by flat parameter name). ``reference`` runs the flash
    kernels' plain versions, to hold the kernels against them.
    ``forward_loss`` replaces the single-process forward (same signature
    as ``_forward_loss``)."""
    leaves = flatten(params)
    loss, metrics = (forward_loss or _forward_loss)(
        params, tgt, model_cfg, train_cfg, key, reference, src=src
    )
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    return {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()}}, grads


def make_train_step(
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    tx: Adam | None = None,
    forward_loss: Callable | None = None,
    sum_across: Callable[[list[torch.Tensor]], None] | None = None,
) -> Callable[[TrainState, Any, Any], tuple[TrainState, dict]]:
    """``step(state, src, tgt) -> (state, metrics)``: ``loss_and_grads``
    with dropout keyed on (seed, step), then Adam, updating the params in
    place. Metrics are device scalars (``loss``, ``loss_sum``, ``weight``,
    ``correct``, ``grad_norm``); nothing here waits for the device. With
    ``sum_across`` (an in-place sum over processes) the gradients and the
    metrics are summed before ``grad_norm`` and Adam, so every process
    takes the same update and reports the same metrics."""
    _check_supported(model_cfg, train_cfg)
    tx = tx or make_optimizer(model_cfg, train_cfg)

    def train_step(state: TrainState, src, tgt):
        leaves = flatten(state.params)
        device = next(iter(leaves.values())).device
        metrics, grads = loss_and_grads(
            state.params, _batch(tgt, device), model_cfg, train_cfg,
            (train_cfg.seed, state.step), forward_loss=forward_loss,
            src=_source(src, model_cfg, device),
        )
        if sum_across is not None:
            sum_across([*grads.values(), *metrics.values()])
        metrics["grad_norm"] = global_norm(grads.values())
        updates, opt_state = tx.update(grads, state.opt_state)
        with torch.no_grad():
            for name, p in leaves.items():
                p.add_(updates[name])
        return TrainState(state.step + 1, state.params, opt_state), metrics

    return train_step


def make_eval_step(
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    forward_loss: Callable | None = None,
    sum_across: Callable[[list[torch.Tensor]], None] | None = None,
) -> Callable[[TrainState, Any, Any], dict]:
    """Forward-only ``eval(state, src, tgt) -> metrics`` (no dropout);
    the hooks as in ``make_train_step``."""
    _check_supported(model_cfg, train_cfg)

    @torch.no_grad()
    def eval_step(state: TrainState, src, tgt):
        device = next(iter(flatten(state.params).values())).device
        loss, metrics = (forward_loss or _forward_loss)(
            state.params, _batch(tgt, device), model_cfg, train_cfg, None,
            src=_source(src, model_cfg, device),
        )
        metrics = {"loss": loss, **metrics}
        if sum_across is not None:
            sum_across(list(metrics.values()))
        return metrics

    return eval_step


class MetricAccumulator:
    """Exact sums of ``loss_sum``/``weight``/``correct`` across steps, kept
    on the device; reading ``loss`` or ``accuracy`` waits for it."""

    _KEYS = ("loss_sum", "weight", "correct")

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._sums: dict[str, Any] | None = None

    def update(self, metrics: dict[str, Any]) -> None:
        part = {k: metrics[k].detach() for k in self._KEYS}
        if self._sums is None:
            self._sums = part
        else:
            self._sums = {k: self._sums[k] + part[k] for k in self._KEYS}

    def _get(self, key: str) -> float:
        return 0.0 if self._sums is None else float(self._sums[key])

    @property
    def loss_sum(self) -> float:
        return self._get("loss_sum")

    @property
    def weight(self) -> float:
        return self._get("weight")

    @property
    def correct(self) -> float:
        return self._get("correct")

    @property
    def loss(self) -> float:
        return self.loss_sum / max(self.weight, 1.0)

    @property
    def accuracy(self) -> float:
        return self.correct / max(self.weight, 1.0)


class Trainer:
    """Epoch-driven training loop on one device.

    Each train step ends in a device synchronize, so ``step_seconds`` holds
    the wall time of every step (host enqueue plus device work)."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        train_cfg: TrainConfig,
        state: TrainState,
        log_fn: Callable[[str], None] = print,
        forward_loss: Callable | None = None,
        sum_across: Callable[[list[torch.Tensor]], None] | None = None,
    ) -> None:
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.state = state
        self.log_fn = log_fn
        hooks = dict(forward_loss=forward_loss, sum_across=sum_across)
        self.train_step = make_train_step(model_cfg, train_cfg, **hooks)
        self.eval_step = make_eval_step(model_cfg, train_cfg, **hooks)
        self.train_metrics = MetricAccumulator()
        self.eval_metrics = MetricAccumulator()
        self.device = resolve_device(next(iter(flatten(state.params).values())).device)
        self.step_seconds: list[float] = []
        self.tokens = 0
        self.eval_batches = 0

    def evaluate(self, batches: Iterable, max_batches: int | None = None) -> None:
        self.eval_metrics.reset()
        for i, (src, tgt) in enumerate(batches):
            if max_batches is not None and i >= max_batches:
                break
            self.eval_metrics.update(self.eval_step(self.state, src, tgt))
            self.eval_batches += 1

    def fit(self, train_ds, test_ds=None) -> None:
        cfg = self.train_cfg
        step = self.state.step
        for epoch in range(cfg.epochs):
            self.train_metrics.reset()
            epoch_start = time.perf_counter()
            for src, tgt in train_ds.batches(epoch):
                t0 = time.perf_counter()
                self.state, m = self.train_step(self.state, src, tgt)
                synchronize(self.device)
                self.step_seconds.append(time.perf_counter() - t0)
                self.tokens += tgt.shape[0] * max(tgt.shape[1] - 1, 1)
                self.train_metrics.update(m)
                step += 1
                if cfg.log_every_steps and step % cfg.log_every_steps == 0:
                    self.log_fn(
                        f"epoch {epoch + 1} step {step} loss {self.train_metrics.loss:.4f} "
                        f"acc {self.train_metrics.accuracy:.4f} "
                        f"grad_norm {float(m['grad_norm']):.4f}"
                    )
                every = cfg.eval_every_steps
                if test_ds is not None and every and step % every == 0:
                    self.evaluate(test_ds.batches(epoch), max_batches=cfg.eval_max_batches or None)
                    self.log_fn(
                        f"  eval loss {self.eval_metrics.loss:.4f} "
                        f"acc {self.eval_metrics.accuracy:.4f}"
                    )
            epoch_loss = self.train_metrics.loss
            if test_ds is not None:
                self.evaluate(test_ds.batches(epoch))
            synchronize(self.device)
            self.log_fn(
                f"epoch {epoch + 1}/{cfg.epochs} done in {time.perf_counter() - epoch_start:.1f}s: "
                f"loss {epoch_loss:.4f} acc {self.train_metrics.accuracy:.4f}"
                + (f"; eval loss {self.eval_metrics.loss:.4f}" if test_ds is not None else "")
            )
