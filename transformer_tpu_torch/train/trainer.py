"""Train and eval steps and the epoch loop.

Port of ``transformer_tpu/train/trainer.py`` for decoder-only LMs and
seq2seq models (``src`` into the encoder, ``tgt[:, :-1]`` into the
decoder, ``tgt[:, 1:]`` scored): ``make_train_step`` (teacher-forcing
shift, forward with dropout keyed on (seed, step), masked CE, backward,
Adam with the pre-clip ``grad_norm`` metric; with ``grad_accum_steps``
micro-steps summed in the loss-sum domain and divided once; with
``loss_chunks`` the chunked CE), ``make_eval_step``,
``make_multistep_train_step`` (``steps_per_dispatch``: K steps a host
dispatch, their batches and per-update scalars staged on the device in one
copy, the metrics summed on the device; on the card the step replays a
CUDA graph, ``train/graph.py``), ``_dispatch_groups``, ``MetricAccumulator``
and ``Trainer.fit``: restore before training, resume at the right epoch,
periodic logging, bounded in-loop eval, the full end-of-epoch eval, the
plateau early stop, checkpoints on a cadence and on SIGTERM/SIGINT. The
steps take two hooks that ``parallel.distributed.DistributedTrainer``
fills: the forward-and-loss function, and a sum across processes for the
gradients and the metric sums. Telemetry and tracing are not ported.
"""

from __future__ import annotations

import json
import os
import time
from collections.abc import Callable, Iterable
from typing import Any

import numpy as np
import torch

from transformer_tpu_torch.config import ModelConfig, TrainConfig
from transformer_tpu_torch.device import resolve_device, synchronize
from transformer_tpu_torch.models.transformer import (
    flatten,
    project_logits,
    transformer_hidden_apply,
)
from transformer_tpu_torch.train.checkpoint import CheckpointManager
from transformer_tpu_torch.train.loss import chunked_cross_entropy_from_hidden, masked_cross_entropy
from transformer_tpu_torch.train.state import Adam, TrainState, global_norm, make_optimizer
from transformer_tpu_torch.utils.preemption import PreemptionGuard


def _check_supported(model_cfg: ModelConfig, train_cfg: TrainConfig) -> None:
    if train_cfg.objective != "causal" or model_cfg.encoder_only:
        raise NotImplementedError(
            "the port trains decoder-only LMs and seq2seq models with the causal "
            "objective; masked-LM training is a later slice"
        )


def _batch(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x)).to(device=device, dtype=torch.long)


def stage(arrays: list[np.ndarray], scalars: np.ndarray, device) -> list[torch.Tensor]:
    """``arrays`` (integer batches) and ``scalars`` (fp32) on ``device`` in
    one host-to-device copy: packed as 32-bit words into one buffer (pinned
    on the host for a CUDA device), returned as views of the copy in their
    shapes, int32 and fp32."""
    parts = [np.ascontiguousarray(a, dtype=np.int32) for a in arrays]
    parts.append(np.ascontiguousarray(scalars, dtype=np.float32).view(np.int32))
    flat = torch.from_numpy(np.concatenate([a.ravel() for a in parts]))
    device = torch.device(device)
    if device.type == "cuda":
        flat = flat.pin_memory().to(device, non_blocking=True)
    out, at = [], 0
    for a in parts:
        out.append(flat[at : at + a.size].view(a.shape))
        at += a.size
    out[-1] = out[-1].view(torch.float32)
    return out


def _source(src, model_cfg: ModelConfig, device) -> torch.Tensor | None:
    """The source batch on ``device`` for a seq2seq model, else None (an LM
    batch's src repeats its tgt)."""
    return None if model_cfg.decoder_only else _batch(src, device)


def loss_from_hidden(params, hidden, targets, model_cfg, train_cfg, total_weight=None):
    """(loss, metric sums) of the (B, S, d_model) decoder hiddens against
    ``targets``: the logits' masked CE, or with ``loss_chunks > 1`` the
    chunked CE that never holds the whole (B, S, V) logits.
    ``total_weight`` is the "tokens" divisor of a batch split over
    processes (see ``masked_cross_entropy``)."""
    kw = dict(
        label_smoothing=train_cfg.label_smoothing, normalization=train_cfg.loss_normalization,
        batch_size=train_cfg.batch_size, total_weight=total_weight,
    )
    if train_cfg.loss_chunks > 1:
        return chunked_cross_entropy_from_hidden(
            params, hidden, targets, model_cfg, num_chunks=train_cfg.loss_chunks, **kw
        )
    return masked_cross_entropy(project_logits(params, hidden, model_cfg), targets, **kw)


def _forward_loss(params, tgt, model_cfg, train_cfg, key, reference=False, src=None):
    """Feed ``tgt[:, :-1]`` (and, seq2seq, ``src`` to the encoder), predict
    ``tgt[:, 1:]``: (loss, metric sums). Dropout is keyed on ``key``; None
    runs deterministically."""
    hidden = transformer_hidden_apply(
        params, src, tgt[:, :-1], model_cfg, key=key, deterministic=key is None,
        reference=reference,
    )
    return loss_from_hidden(params, hidden, tgt[:, 1:], model_cfg, train_cfg)


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
    with dropout keyed on (seed, step), then Adam, updating the params and
    its moments in place. Metrics are device scalars (``loss``,
    ``loss_sum``, ``weight``, ``correct``, ``grad_norm``); nothing here
    waits for the device. With
    ``sum_across`` (an in-place sum over processes) the gradients and the
    metrics are summed before ``grad_norm`` and Adam, so every process
    takes the same update and reports the same metrics. ``step.core(state,
    src, tgt, scalars)`` is the same step on device tensors, with Adam's
    per-update scalars read from the device (``step.scalars(state, k)``
    gives the next k updates' on the host): the function a CUDA graph
    captures.

    With ``grad_accum_steps`` = n > 1 the batch runs as n micro-batches of
    B / n rows (n must divide B), micro-step i's dropout keyed on (seed,
    step, i): each one's gradient of its loss *sum* is added up, and the
    total divided once by the whole batch's non-PAD token count ("tokens")
    or the batch size ("batch"), so the update is the whole batch's."""
    _check_supported(model_cfg, train_cfg)
    tx = tx or make_optimizer(model_cfg, train_cfg)
    accum = max(1, train_cfg.grad_accum_steps)
    forward = forward_loss or _forward_loss

    def apply(state, leaves, grads, metrics, scalars):
        metrics["grad_norm"] = global_norm(grads.values())
        if isinstance(tx, Adam):
            opt_state = tx.step_(leaves, grads, state.opt_state, scalars)
        else:  # any optimizer with optax's update(grads, state, params)
            updates, opt_state = tx.update(grads, state.opt_state, leaves)
            with torch.no_grad():
                for name, p in leaves.items():
                    p.add_(updates[name])
        return TrainState(state.step + 1, state.params, opt_state), metrics

    def core(state: TrainState, src, tgt, scalars):
        leaves = flatten(state.params)
        tgt, src = tgt.long(), None if src is None else src.long()
        if accum > 1:
            return accum_core(state, leaves, src, tgt, scalars)
        metrics, grads = loss_and_grads(
            state.params, tgt, model_cfg, train_cfg, (train_cfg.seed, state.step),
            forward_loss=forward_loss, src=src,
        )
        if sum_across is not None:
            sum_across([*grads.values(), *metrics.values()])
        return apply(state, leaves, grads, metrics, scalars)

    def accum_core(state: TrainState, leaves, src, tgt, scalars):
        device = tgt.device
        if tgt.shape[0] % accum:
            raise ValueError(f"grad_accum_steps {accum} must divide the batch {tgt.shape[0]}")
        mb = tgt.shape[0] // accum
        grads = sums = None
        for i in range(accum):
            rows = slice(i * mb, (i + 1) * mb)
            _, m = forward(
                state.params, tgt[rows], model_cfg, train_cfg, (train_cfg.seed, state.step, i),
                src=None if src is None else src[rows],
            )
            g = torch.autograd.grad(m["loss_sum"], list(leaves.values()))
            m = {k: v.detach() for k, v in m.items()}
            if grads is None:
                grads, sums = list(g), m
            else:
                for a, b in zip(grads, g):
                    a.add_(b)
                sums = {k: sums[k] + m[k] for k in sums}
        grads = dict(zip(leaves, grads))
        if sum_across is not None:
            sum_across([*grads.values(), *sums.values()])
        if train_cfg.loss_normalization == "tokens":
            denom = torch.clamp(sums["weight"], min=1.0)
        else:  # filled on the device: no copy from the host, capturable
            denom = torch.full((), float(train_cfg.batch_size), device=device)
        grads = {k: g / denom for k, g in grads.items()}
        return apply(state, leaves, grads, {"loss": sums["loss_sum"] / denom, **sums}, scalars)

    def scalars(state: TrainState, k: int = 1) -> np.ndarray:
        """(k, n) fp32: Adam's per-update scalars of the next k updates
        (no columns for another optimizer)."""
        if not isinstance(tx, Adam):
            return np.zeros((k, 0), np.float32)
        return np.stack([tx.scalars(state.opt_state.count + i) for i in range(k)])

    def train_step(state: TrainState, src, tgt):
        device = next(iter(flatten(state.params).values())).device
        return core(state, _source(src, model_cfg, device), _batch(tgt, device),
                    torch.from_numpy(scalars(state)[0]).to(device))

    train_step.core, train_step.scalars = core, scalars
    train_step.uses_src = not model_cfg.decoder_only
    return train_step


def _dispatch_metrics(sums: dict, k: int, loss_normalization: str, batch_size: int) -> dict:
    """The K steps' summed metrics in ``MetricAccumulator.update``'s form,
    with ``loss`` normalised as one step's is and ``grad_norm`` the mean
    over the K steps."""
    out = {key: sums[key] for key in ("loss_sum", "weight", "correct")}
    if loss_normalization == "batch" and batch_size:
        # The mean of the K per-step losses, each loss_sum / B.
        out["loss"] = out["loss_sum"] / float(batch_size * k)
    else:
        out["loss"] = out["loss_sum"] / torch.clamp(out["weight"], min=1.0)
    if "grad_norm" in sums:
        out["grad_norm"] = sums["grad_norm"] / k
    return out


def make_multistep_train_step(
    step_fn: Callable,
    loss_normalization: str = "tokens",
    batch_size: int = 0,
    run: Callable | None = None,
) -> Callable[[TrainState, Any, Any], tuple[TrainState, dict]]:
    """K optimizer steps per host dispatch (``steps_per_dispatch``):
    ``multistep(state, src, tgt)`` with (K, B, S) stacked batches.

    The twin of the JAX package's ``lax.scan`` over ``step_fn``. The K
    batches and K rows of Adam's per-update scalars go to the device in
    one copy (``stage``); then ``run`` (default ``step_fn.core``; on the
    card a ``graph.CapturedStep`` replaying the step's CUDA graph) takes
    the K steps back to back, with nothing waiting for the device. Dropout
    stays keyed on (seed, step) per step, so the K steps are exactly K
    calls of ``step_fn``. Metrics come back summed on the device over the
    K steps (``loss_sum``, ``weight``, ``correct``; ``loss`` as one step
    normalises it; ``grad_norm`` the mean), in the form
    ``MetricAccumulator.update`` takes."""
    run = run or step_fn.core

    def multistep(state: TrainState, src, tgt):
        device = next(iter(flatten(state.params).values())).device
        k = tgt.shape[0]
        arrays = [tgt] + ([src] if step_fn.uses_src else [])
        staged = stage(arrays, step_fn.scalars(state, k), device)
        tgts, srcs, scals = staged[0], staged[1] if step_fn.uses_src else None, staged[-1]
        sums = None
        for i in range(k):
            state, m = run(state, None if srcs is None else srcs[i], tgts[i], scals[i])
            if sums is None:
                sums = {key: v.clone() for key, v in m.items()}  # run's may be reused
            else:
                sums = {key: sums[key] + m[key] for key in sums}
        return state, _dispatch_metrics(sums, k, loss_normalization, batch_size)

    return multistep


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


def _dispatch_groups(batches, k: int):
    """Group consecutive same-shape batches into stacks of up to ``k``:
    yields ``(src, tgt, n)`` with src/tgt stacked to (n, B, S) when n > 1,
    or the single batch unstacked when a group has one member (a shape
    change mid-group, the epoch's tail). Length-bucketed batches group by
    bucket; each distinct signature costs one capture on the card."""
    buf: list = []
    sig = None
    for b in batches:
        s = (b[0].shape, b[1].shape)
        if buf and s != sig:
            yield _stack_group(buf)
            buf = []
        buf.append(b)
        sig = s
        if len(buf) == k:
            yield _stack_group(buf)
            buf = []
    if buf:
        yield _stack_group(buf)


def _stack_group(buf: list):
    if len(buf) == 1:
        src, tgt = buf[0]
        return src, tgt, 1
    return np.stack([b[0] for b in buf]), np.stack([b[1] for b in buf]), len(buf)


class Trainer:
    """Epoch-driven training loop on one device.

    Each host dispatch (one step, or ``steps_per_dispatch`` = K steps) ends
    in a device synchronize: ``step_seconds`` holds every step's wall time
    (host enqueue plus device work; a K-step dispatch's time divided by its
    steps), ``dispatches`` each dispatch's (steps, seconds), ``losses``
    each dispatch's train loss (read after the synchronize). With K > 1 on
    the card the steps replay a CUDA graph of the step (``graph``, a
    ``CapturedStep``; one capture per batch signature); on the CPU, or with
    the gradients summed across processes (the ``sum_across`` hook), the
    same K-step dispatch runs uncaptured. With a ``checkpoint`` manager,
    ``fit`` restores the newest intact checkpoint before training and
    saves on its cadence, on early stop and on SIGTERM/SIGINT."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        train_cfg: TrainConfig,
        state: TrainState,
        log_fn: Callable[[str], None] = print,
        forward_loss: Callable | None = None,
        sum_across: Callable[[list[torch.Tensor]], None] | None = None,
        checkpoint: CheckpointManager | None = None,
    ) -> None:
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.state = state
        self.log_fn = log_fn
        self.checkpoint = checkpoint
        hooks = dict(forward_loss=forward_loss, sum_across=sum_across)
        self.train_step = make_train_step(model_cfg, train_cfg, **hooks)
        self.eval_step = make_eval_step(model_cfg, train_cfg, **hooks)
        self.train_metrics = MetricAccumulator()
        self.eval_metrics = MetricAccumulator()
        self.device = resolve_device(next(iter(flatten(state.params).values())).device)
        distributed = sum_across is not None
        self.graph = self.multi_step = None
        # The distributed trainer runs its K-step dispatch whatever
        # enable_function says, as the JAX one always jits its own.
        if train_cfg.steps_per_dispatch > 1 and (train_cfg.enable_function or distributed):
            if self.device.type == "cuda" and not distributed:
                from transformer_tpu_torch.train.graph import CapturedStep

                self.graph = CapturedStep(self.train_step.core, train_cfg.seed, self.device)
            self.multi_step = make_multistep_train_step(
                self.train_step, train_cfg.loss_normalization, train_cfg.batch_size,
                run=self.graph,
            )
        self.step_seconds: list[float] = []
        self.dispatches: list[tuple[int, float]] = []
        self.losses: list[float] = []
        self.tokens = 0
        self.eval_batches = 0
        self._best_eval = float("inf")
        self._epochs_since_best = 0

    def evaluate(
        self, batches: Iterable, max_batches: int | None = None,
        guard: PreemptionGuard | None = None,
    ) -> None:
        self.eval_metrics.reset()
        for i, (src, tgt) in enumerate(batches):
            if max_batches is not None and i >= max_batches:
                break
            if guard is not None and guard.should_stop:
                return  # preemption: the caller checkpoints
            self.eval_metrics.update(self.eval_step(self.state, src, tgt))
            self.eval_batches += 1

    def _restore(self) -> None:
        def fallback(step, exc):
            self.log_fn(f"checkpoint at step {step} unreadable ({type(exc).__name__}); falling back")

        restored = self.checkpoint.restore_latest(self.state, on_fallback=fallback)
        if restored is not None:
            self.state = restored
            self.log_fn(f"restored checkpoint at step {self.state.step}")

    def fit(
        self,
        train_ds,
        test_ds=None,
        epoch_callback: Callable[[int, "Trainer"], object] | None = None,
    ) -> None:
        """Train the epochs left after the restored step: a run restored at
        step s resumes at epoch ``s // len(train_ds)`` (a mid-epoch
        checkpoint replays its epoch from the start, the (seed,
        epoch)-keyed data order and (seed, step)-keyed dropout as the
        uninterrupted run had them). ``epoch_callback(epoch, trainer)``
        runs after each epoch's eval and before its checkpoint; a truthy
        return stops the run after that checkpoint."""
        cfg = self.train_cfg
        if cfg.steps_per_dispatch > 1 and self.multi_step is None:
            raise ValueError(
                "steps_per_dispatch > 1 requires enable_function=True on the "
                "single-process Trainer: the multi-step dispatch replays a captured "
                "CUDA graph of the step; in eager-debug mode it would silently fall "
                "back to single-step dispatch"
            )
        if self.checkpoint is not None:
            self._restore()
        step = self.state.step
        start_epoch = 0
        if step and len(train_ds):
            start_epoch = min(step // len(train_ds), cfg.epochs)
            if start_epoch:
                self.log_fn(f"resuming at epoch {start_epoch + 1}/{cfg.epochs} (step {step})")
        if cfg.early_stop_patience and self._early_stop_marker_exists():
            self.log_fn(
                "early-stop marker present in checkpoint dir; not training further "
                "(delete the EARLY_STOPPED file to continue)"
            )
            return
        best_eval, epochs_since_best = float("inf"), 0
        if cfg.early_stop_patience:
            best_eval, epochs_since_best = self._load_plateau_state(step)
            if epochs_since_best:
                self.log_fn(
                    f"resumed early-stop window: best eval {best_eval:.4f}, "
                    f"{epochs_since_best} epoch(s) without improvement"
                )
        with PreemptionGuard() as guard:
            for epoch in range(start_epoch, cfg.epochs):
                self.train_metrics.reset()
                epoch_start = time.perf_counter()
                batches = train_ds.batches(epoch)
                if self.multi_step is not None:
                    groups = _dispatch_groups(batches, cfg.steps_per_dispatch)
                else:
                    groups = ((s, t, 1) for s, t in batches)
                for src, tgt, k in groups:
                    t0 = time.perf_counter()
                    if self.multi_step is None:
                        self.state, m = self.train_step(self.state, src, tgt)
                        tokens = tgt.shape[0] * max(tgt.shape[1] - 1, 1)
                    else:
                        if k == 1:  # a group of one replays the step too
                            src, tgt = np.asarray(src)[None], np.asarray(tgt)[None]
                        self.state, m = self.multi_step(self.state, src, tgt)
                        tokens = k * tgt.shape[1] * max(tgt.shape[2] - 1, 1)
                    synchronize(self.device)
                    seconds = time.perf_counter() - t0
                    self.dispatches.append((k, seconds))
                    self.step_seconds.extend([seconds / k] * k)
                    self.losses.append(float(m["loss"]))
                    self.tokens += tokens
                    self.train_metrics.update(m)
                    prev_step, step = step, step + k
                    if guard.should_stop:
                        self._preempt(step, guard)
                        return
                    # Boundary-crossing, so that a K-step dispatch that jumps
                    # over a log or eval step still logs or evaluates; for
                    # k == 1 this is step % N == 0.
                    every = cfg.log_every_steps
                    if every and step // every != prev_step // every:
                        self.log_fn(
                            f"epoch {epoch + 1} step {step} loss {self.train_metrics.loss:.4f} "
                            f"acc {self.train_metrics.accuracy:.4f} "
                            f"grad_norm {float(m['grad_norm']):.4f}"
                        )
                    every = cfg.eval_every_steps
                    if test_ds is not None and every and step // every != prev_step // every:
                        self.evaluate(test_ds.batches(epoch),
                                      max_batches=cfg.eval_max_batches or None, guard=guard)
                        self.log_fn(
                            f"  eval loss {self.eval_metrics.loss:.4f} "
                            f"acc {self.eval_metrics.accuracy:.4f}"
                        )
                epoch_loss = self.train_metrics.loss
                if guard.should_stop:
                    self._preempt(step, guard)
                    return
                if test_ds is not None:
                    self.evaluate(test_ds.batches(epoch), guard=guard)
                    if guard.should_stop:
                        self._preempt(step, guard)
                        return
                synchronize(self.device)
                self.log_fn(
                    f"epoch {epoch + 1}/{cfg.epochs} done in {time.perf_counter() - epoch_start:.1f}s: "
                    f"loss {epoch_loss:.4f} acc {self.train_metrics.accuracy:.4f}"
                    + (f"; eval loss {self.eval_metrics.loss:.4f}" if test_ds is not None else "")
                )
                callback_stop = bool(epoch_callback(epoch, self)) if epoch_callback else False
                stop_early = False
                if cfg.early_stop_patience and test_ds is not None and self.eval_metrics.weight > 0:
                    if self.eval_metrics.loss < best_eval - 1e-6:
                        best_eval, epochs_since_best = self.eval_metrics.loss, 0
                    else:
                        epochs_since_best += 1
                        stop_early = epochs_since_best >= cfg.early_stop_patience
                self._best_eval, self._epochs_since_best = best_eval, epochs_since_best
                if self.checkpoint is not None and (
                    (epoch + 1) % cfg.checkpoint_every_epochs == 0
                    or epoch + 1 == cfg.epochs or stop_early or callback_stop
                ):
                    self.checkpoint.save(self.state)
                    if cfg.early_stop_patience:
                        self._save_plateau_state(step)
                if stop_early:
                    self.log_fn(
                        f"early stop after epoch {epoch + 1}: eval loss has not improved for "
                        f"{epochs_since_best} epoch(s) (best {best_eval:.4f})"
                    )
                    self._mark_early_stopped(epoch + 1)
                    break
                if callback_stop:
                    self.log_fn(f"stop requested by epoch callback after epoch {epoch + 1}")
                    break
        if self.checkpoint is not None:
            self.checkpoint.wait()  # the last save is durable before fit returns

    def _preempt(self, step: int, guard: PreemptionGuard) -> None:
        """On SIGTERM/SIGINT: save, wait until the save is durable, report."""
        prefix = f"preemption (signal {guard.signal_received}) at step {step}: "
        if self.checkpoint is None:
            self.log_fn(prefix + "no checkpoint manager configured, state lost")
            return
        path = self.checkpoint.save(self.state)
        self.checkpoint.wait()
        if self.train_cfg.early_stop_patience:
            self._save_plateau_state(step)
        if path is None:
            self.log_fn(prefix + "checkpoint written by primary process")
        else:
            self.log_fn(prefix + f"checkpoint saved to {path}")

    # The plateau window and the early-stop marker live beside the
    # checkpoints, written by the primary process, read by every process,
    # so that a resumed run keeps its patience window and a relaunch after
    # an early stop does not train past it.
    def _sidecar(self, name: str) -> str | None:
        return None if self.checkpoint is None else os.path.join(self.checkpoint.directory, name)

    def _load_plateau_state(self, step: int) -> tuple[float, int]:
        path = self._sidecar("plateau.json")
        if path is None or not os.path.exists(path):
            return float("inf"), 0
        try:
            with open(path) as f:
                d = json.load(f)
        except (ValueError, OSError):
            return float("inf"), 0
        if int(d.get("step", -1)) > step:
            # Written after the restored checkpoint (an older one was
            # restored): its counts describe evals this run will redo.
            return float("inf"), 0
        return float(d.get("best_eval", float("inf"))), int(d.get("epochs_since_best", 0))

    def _save_plateau_state(self, step: int) -> None:
        path = self._sidecar("plateau.json")
        if path is None or not self.checkpoint.is_primary:
            return
        with open(f"{path}.tmp", "w") as f:
            json.dump({"step": step, "best_eval": self._best_eval,
                       "epochs_since_best": self._epochs_since_best}, f)
        os.replace(f"{path}.tmp", path)

    def _early_stop_marker_exists(self) -> bool:
        path = self._sidecar("EARLY_STOPPED")
        return path is not None and os.path.exists(path)

    def _mark_early_stopped(self, epoch: int) -> None:
        path = self._sidecar("EARLY_STOPPED")
        if path is None or not self.checkpoint.is_primary:
            return
        with open(path, "w") as f:
            f.write(f"early stop after epoch {epoch}\n")
