"""Train and eval steps and the epoch loop.

Port of ``transformer_tpu/train/trainer.py`` for decoder-only LMs and
seq2seq models (``src`` into the encoder, ``tgt[:, :-1]`` into the
decoder, ``tgt[:, 1:]`` scored) under the causal objective, and
encoder-only models under the masked-LM one (``_prepare_batch``: the
whole window masked from the step's generator, the masked positions
scored): ``make_train_step`` (the shift or the masking, forward with
dropout keyed on (seed, step), masked CE, backward, the optimizer (Adam,
AdamW or Adafactor) with the pre-clip ``grad_norm`` metric; with
``grad_accum_steps`` micro-steps summed in the loss-sum domain and divided once; with
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
gradients and the metric sums.

Telemetry (the JAX trainer's hooks): with a ``telemetry`` bundle
(``obs.Telemetry``) the loop records the ``train_*`` gauges and counters,
the ``train_step_seconds`` histogram (``StepTimer``'s), the
``train_dispatch_seconds`` histogram and the profiler's ``train.step``
stream, and emits ``train.window`` / ``train.eval`` / ``train.memory`` /
``train.compile`` / ``train.preempt`` events, and at fit start one
``train.predicted`` (``_emit_cost_prediction``); with its tracer,
``train.fit`` / ``train.step`` / ``train.eval`` / ``ckpt.*`` spans on the
``train`` lane. Every record is taken at a point where the loop has
already synchronized the device (each dispatch ends in one), so the
numbers are device time and telemetry adds no device work: the same
losses, captures and kernel launches with it on and off. ``profiler``
(``utils.profiling.Profiler``) records a ``torch.profiler`` window of
steps, and ``log_dir`` gets TensorBoard scalars under ``train/`` and
``test/`` at every epoch end.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections.abc import Callable, Iterable
from typing import Any

import numpy as np
import torch

from transformer_tpu_torch.config import PAD_ID, ModelConfig, TrainConfig
from transformer_tpu_torch.device import resolve_device, synchronize
from transformer_tpu_torch.models.transformer import (
    flatten,
    project_logits,
    transformer_hidden_apply,
)
from transformer_tpu_torch.ops.nn import dropout_generator, key_seed
from transformer_tpu_torch.train.checkpoint import CheckpointManager
from transformer_tpu_torch.train.loss import chunked_cross_entropy_from_hidden, masked_cross_entropy
from transformer_tpu_torch.train.mlm import mask_tokens
from transformer_tpu_torch.train.state import (
    Adafactor,
    Adam,
    TrainState,
    global_norm,
    make_optimizer,
)
from transformer_tpu_torch.utils.preemption import PreemptionGuard
from transformer_tpu_torch.utils.profiling import StepTimer, annotate


_NO_SPAN = contextlib.nullcontext()


def _check_objective(model_cfg: ModelConfig, train_cfg: TrainConfig) -> None:
    if (train_cfg.objective == "mlm") != model_cfg.encoder_only:
        raise ValueError(
            "objective='mlm' and ModelConfig.encoder_only go together "
            "(the masked-LM loss needs the bidirectional encoder stack, and "
            "an encoder-only model has no causal shift to train on): got "
            f"objective={train_cfg.objective!r}, "
            f"encoder_only={model_cfg.encoder_only}"
        )


def _prepare_batch(model_cfg: ModelConfig, train_cfg: TrainConfig, tgt: torch.Tensor, key):
    """-> (model input, labels, forward key) of one step's (B, L) batch.

    causal: the teacher-forcing shift, dropout keyed on ``key``. mlm: the
    whole window masked (``train.mlm.mask_tokens``) from the generator
    keyed ``key + (0,)``, dropout keyed ``key + (1,)``, as the JAX twin
    splits the step key in two; eval (``key`` None) masks from a constant
    generator seeded from ``train_cfg.seed``, so every eval scores the
    same positions. Under a CUDA graph capture the masking generator is
    the tape's (``ops.nn.DropoutTape``), reseeded every replay. The ids
    never selected nor drawn are ``mlm_excluded_ids``, by default BOS and
    EOS, the two ids below [MASK] in the MLM vocabulary's layout."""
    if train_cfg.objective != "mlm":
        return tgt[:, :-1], tgt[:, 1:], key
    if key is None:
        gen = torch.Generator(device=tgt.device).manual_seed(key_seed((train_cfg.seed,)))
        fwd_key = None
    else:
        gen, fwd_key = dropout_generator(tuple(key) + (0,), tgt.device), tuple(key) + (1,)
    mask_id = model_cfg.input_vocab_size - 1
    excluded = train_cfg.mlm_excluded_ids
    if excluded is None:
        excluded = (mask_id - 2, mask_id - 1)
    inp, labels = mask_tokens(tgt, gen, model_cfg.input_vocab_size, train_cfg.mlm_mask_rate,
                              excluded)
    return inp, labels, fwd_key


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


def uses_source(model_cfg: ModelConfig) -> bool:
    """Whether the model reads a source batch: seq2seq only (an LM batch's
    src repeats its tgt)."""
    return not (model_cfg.decoder_only or model_cfg.encoder_only)


def _source(src, model_cfg: ModelConfig, device) -> torch.Tensor | None:
    """The source batch on ``device`` for a seq2seq model, else None."""
    return _batch(src, device) if uses_source(model_cfg) else None


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


def _forward_loss(params, tgt, model_cfg, train_cfg, key, reference=False, src=None,
                  prepared=None):
    """Feed ``tgt[:, :-1]`` (and, seq2seq, ``src`` to the encoder), predict
    ``tgt[:, 1:]``, or under the MLM objective feed the masked window and
    predict the masked positions: (loss, metric sums). Dropout is keyed on
    ``key``; None runs deterministically. ``prepared`` is
    ``_prepare_batch``'s (input, labels, forward key), made once for a
    batch whose micro-batches share its masks; None prepares ``tgt``."""
    inp, labels, key = prepared or _prepare_batch(model_cfg, train_cfg, tgt, key)
    hidden, aux = transformer_hidden_apply(
        params, src, inp, model_cfg, key=key, deterministic=key is None, reference=reference,
        return_aux=True,
    )
    return with_moe_aux(loss_from_hidden(params, hidden, labels, model_cfg, train_cfg), aux,
                        model_cfg)


def with_moe_aux(loss_metrics, aux, model_cfg: ModelConfig):
    """(loss, metrics) with ``metrics["moe_aux"]``, the summed MoE
    load-balance loss (0 when the forward had none), whenever the config
    has experts: the key follows the config, as in the JAX trainer. It
    still carries its gradient; the steps add ``moe_aux_weight`` times it
    to the objective, and report ``loss`` as the plain CE."""
    loss, metrics = loss_metrics
    if model_cfg.moe_experts:
        metrics["moe_aux"] = torch.zeros((), device=loss.device) if aux is None else aux
    return loss, metrics


def _objective(loss, metrics, model_cfg: ModelConfig):
    """``loss + moe_aux_weight * moe_aux``, or ``loss`` without experts."""
    if "moe_aux" not in metrics:
        return loss
    return loss + model_cfg.moe_aux_weight * metrics["moe_aux"]


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
    as ``_forward_loss``); the batch is prepared (shifted or masked) here,
    on the whole batch every process holds."""
    leaves = flatten(params)
    loss, metrics = (forward_loss or _forward_loss)(
        params, tgt, model_cfg, train_cfg, key, reference, src=src,
        prepared=_prepare_batch(model_cfg, train_cfg, tgt, key),
    )
    objective = _objective(loss, metrics, model_cfg)
    grads = dict(zip(leaves, torch.autograd.grad(objective, list(leaves.values()))))
    return {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()}}, grads


def make_train_step(
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    tx: Adam | Adafactor | None = None,
    forward_loss: Callable | None = None,
    sum_across: Callable[[dict, dict], None] | None = None,
    grads_fn: Callable | None = None,
) -> Callable[[TrainState, Any, Any], tuple[TrainState, dict]]:
    """``step(state, src, tgt) -> (state, metrics)``: ``loss_and_grads``
    with dropout (and the MLM's masks) keyed on (seed, step), then the
    optimizer (``train_cfg.optimizer``), updating the params and its state
    in place. Metrics are device scalars (``loss``,
    ``loss_sum``, ``weight``, ``correct``, ``grad_norm``); nothing here
    waits for the device. With
    ``sum_across(grads, metrics)`` (an in-place sum over processes: each
    gradient over the processes that hold its leaf, the metric sums over
    every process) they are summed before ``grad_norm`` and the update, so
    every process takes the same update and reports the same metrics.
    ``grad_norm`` is ``tx.norm(grads)`` where the optimizer has one (the
    norm that clipping uses: over leaves split across processes, each
    slice's squares added once), else ``global_norm`` of the gradients.
    ``step.core(state, src, tgt, scalars)`` is the same step on device
    tensors, with the optimizer's per-update scalars read from the device
    (``step.scalars(state, k)`` gives the next k updates' on the host): the
    function a CUDA graph captures.

    With ``grad_accum_steps`` = n > 1 the batch runs as n micro-batches of
    B / n rows (n must divide B), micro-step i's dropout keyed on (seed,
    step, i) (MLM: the whole batch masked once, from (seed, step, 0), and
    micro-step i's dropout keyed on (seed, step, 1, i)): each one's
    gradient of its loss *sum* is added up, and the total divided once by
    the whole batch's non-PAD token count ("tokens") or the batch size
    ("batch"), so the update is the whole batch's.

    ``grads_fn(params, tgt, src, key) -> (metrics, grads)`` replaces
    ``loss_and_grads`` (a pipeline schedule's backward, on the pipe axis);
    under ``grad_accum_steps`` each micro-step calls it with
    ``prepared=`` its rows of the prepared batch and ``accumulate=`` its
    MoE aux scale, for the gradient of its loss sum."""
    _check_objective(model_cfg, train_cfg)
    tx = tx or make_optimizer(model_cfg, train_cfg)
    accum = max(1, train_cfg.grad_accum_steps)
    forward = forward_loss or _forward_loss
    norm = getattr(tx, "norm", None) or (lambda grads: global_norm(grads.values()))

    def apply(state, leaves, grads, metrics, scalars):
        metrics["grad_norm"] = norm(grads)
        if hasattr(tx, "step_"):  # the port's optimizers: in place
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
        key = (train_cfg.seed, state.step)
        if grads_fn is not None:
            metrics, grads = grads_fn(state.params, tgt, src, key)
        else:
            metrics, grads = loss_and_grads(state.params, tgt, model_cfg, train_cfg, key,
                                            forward_loss=forward_loss, src=src)
        if sum_across is not None:
            sum_across(grads, metrics)
        return apply(state, leaves, grads, metrics, scalars)

    def accum_core(state: TrainState, leaves, src, tgt, scalars):
        device = tgt.device
        if tgt.shape[0] % accum:
            raise ValueError(f"grad_accum_steps {accum} must divide the batch {tgt.shape[0]}")
        mb = tgt.shape[0] // accum
        inp, labels, fwd_key = _prepare_batch(model_cfg, train_cfg, tgt,
                                              (train_cfg.seed, state.step))
        grads = sums = None
        for i in range(accum):
            rows = slice(i * mb, (i + 1) * mb)
            micro_key = tuple(fwd_key) + (i,)
            # JAX's aux scale: the /denom below then makes the aux a
            # token-weighted ("tokens") or uniform ("batch") mean over the
            # micro-steps. The micro-batch's global token count (every
            # process holds the whole batch).
            aux_scale = ((labels[rows] != PAD_ID).sum().float()
                         if train_cfg.loss_normalization == "tokens"
                         else torch.full((), train_cfg.batch_size / accum, device=device))
            micro_src = None if src is None else src[rows]
            prepared = (inp[rows], labels[rows], micro_key)
            if grads_fn is not None:  # the schedule's gradients of the loss sum
                m, g = grads_fn(state.params, tgt[rows], micro_src, micro_key,
                                prepared=prepared, accumulate=aux_scale)
                m.pop("loss")
                if "moe_aux" in m:
                    m["moe_aux"] = m["moe_aux"] * aux_scale
                g = [g[n] for n in leaves]
            else:
                _, m = forward(state.params, tgt[rows], model_cfg, train_cfg, micro_key,
                               src=micro_src, prepared=prepared)
                if "moe_aux" in m:
                    m["moe_aux"] = m["moe_aux"] * aux_scale
                g = torch.autograd.grad(_objective(m["loss_sum"], m, model_cfg),
                                        list(leaves.values()))
            m = {k: v.detach() for k, v in m.items()}
            if grads is None:
                grads, sums = list(g), m
            else:
                for a, b in zip(grads, g):
                    a.add_(b)
                sums = {k: sums[k] + m[k] for k in sums}
        grads = dict(zip(leaves, grads))
        if sum_across is not None:
            sum_across(grads, sums)
        if train_cfg.loss_normalization == "tokens":
            denom = torch.clamp(sums["weight"], min=1.0)
        else:  # filled on the device: no copy from the host, capturable
            denom = torch.full((), float(train_cfg.batch_size), device=device)
        grads = {k: g / denom for k, g in grads.items()}
        if "moe_aux" in sums:
            sums["moe_aux"] = sums["moe_aux"] / denom
        return apply(state, leaves, grads, {"loss": sums["loss_sum"] / denom, **sums}, scalars)

    def scalars(state: TrainState, k: int = 1) -> np.ndarray:
        """(k, n) fp32: the optimizer's per-update scalars of the next k
        updates (no columns for an optimizer without them)."""
        if not hasattr(tx, "scalars"):
            return np.zeros((k, 0), np.float32)
        return np.stack([tx.scalars(state.opt_state.count + i) for i in range(k)])

    def train_step(state: TrainState, src, tgt):
        device = next(iter(flatten(state.params).values())).device
        return core(state, _source(src, model_cfg, device), _batch(tgt, device),
                    torch.from_numpy(scalars(state)[0]).to(device))

    train_step.core, train_step.scalars = core, scalars
    train_step.uses_src = uses_source(model_cfg)
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
    if "moe_aux" in sums:  # summed weighted by each step's weight (multistep)
        out["moe_aux"] = sums["moe_aux"] / torch.clamp(out["weight"], min=1.0)
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
    batches and K rows of the optimizer's per-update scalars go to the
    device in one copy (``stage``); then ``run`` (default ``step_fn.core``;
    on the card a ``graph.CapturedStep`` replaying the step's CUDA graph)
    takes the K steps back to back, with nothing waiting for the device.
    Dropout (and the MLM's masks) stay keyed on (seed, step) per step, so
    the K steps are exactly K calls of ``step_fn``. Metrics come back summed on the device over the
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
            if "moe_aux" in m:  # token-weighted, as MetricAccumulator.update
                m = {**m, "moe_aux": m["moe_aux"] * m["weight"]}
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
    sum_across: Callable[[dict, dict], None] | None = None,
) -> Callable[[TrainState, Any, Any], dict]:
    """Forward-only ``eval(state, src, tgt) -> metrics`` (no dropout;
    MLM: the constant eval masks); the hooks as in ``make_train_step``."""
    _check_objective(model_cfg, train_cfg)

    @torch.no_grad()
    def eval_step(state: TrainState, src, tgt):
        device = next(iter(flatten(state.params).values())).device
        tgt = _batch(tgt, device)
        loss, metrics = (forward_loss or _forward_loss)(
            state.params, tgt, model_cfg, train_cfg, None,
            src=_source(src, model_cfg, device),
            prepared=_prepare_batch(model_cfg, train_cfg, tgt, None),
        )
        metrics = {"loss": loss, **metrics}
        if sum_across is not None:
            sum_across({}, metrics)
        return metrics

    return eval_step


class MetricAccumulator:
    """Exact sums of ``loss_sum``/``weight``/``correct`` across steps, kept
    on the device; reading ``loss`` or ``accuracy`` waits for it. A MoE
    run's ``moe_aux`` is summed weighted by each step's ``weight``, so
    ``moe_aux`` is the token-weighted mean, as in the JAX trainer."""

    _KEYS = ("loss_sum", "weight", "correct")

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._sums: dict[str, Any] | None = None

    def update(self, metrics: dict[str, Any]) -> None:
        part = {k: metrics[k].detach() for k in self._KEYS}
        if "moe_aux" in metrics:
            part["moe_aux_w"] = metrics["moe_aux"].detach() * part["weight"]
        if self._sums is None:
            self._sums = part
        else:
            self._sums = {k: self._sums.get(k, 0.0) + part[k] for k in part}

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

    @property
    def moe_aux(self) -> float | None:
        """The token-weighted mean MoE load-balance loss, or None for a
        dense run."""
        if self._sums is None or "moe_aux_w" not in self._sums:
            return None
        return float(self._sums["moe_aux_w"]) / max(self.weight, 1.0)


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
    saves on its cadence, on early stop and on SIGTERM/SIGINT. ``log_dir``,
    ``profiler`` and ``telemetry`` are the JAX trainer's hooks (the module
    docstring); ``step_hooks`` go to ``make_train_step`` (its ``tx`` and
    ``grads_fn``)."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        train_cfg: TrainConfig,
        state: TrainState,
        log_fn: Callable[[str], None] = print,
        forward_loss: Callable | None = None,
        sum_across: Callable[[dict, dict], None] | None = None,
        checkpoint: CheckpointManager | None = None,
        log_dir: str | None = None,
        profiler=None,
        telemetry=None,
        step_hooks: dict | None = None,
    ) -> None:
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.state = state
        self.log_fn = log_fn
        self.checkpoint = checkpoint
        hooks = dict(forward_loss=forward_loss, sum_across=sum_across)
        self.train_step = make_train_step(model_cfg, train_cfg, **hooks, **(step_hooks or {}))
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
        self.profiler = profiler
        self.step_timer = StepTimer(tokens_per_step=train_cfg.batch_size * train_cfg.sequence_length)
        self.writers = {}
        if log_dir:
            from transformer_tpu_torch.utils.tensorboard import SummaryWriter

            self.writers = {"train": SummaryWriter(f"{log_dir}/train"),
                            "test": SummaryWriter(f"{log_dir}/test")}
        self.telemetry = telemetry
        self._tracer = getattr(telemetry, "tracer", None)
        self._last_metrics: dict | None = None
        self._window_mark = (0, 0, 0.0)  # (steps, tokens, seconds) at the last record
        # The dispatch callables: a step (or K) and the device synchronize
        # that ends it, which every dispatch has with telemetry on or off.
        # Telemetry's wrappers go around them, outside any CUDA graph
        # capture (CapturedStep captures inside multi_step), so what they
        # time is the dispatch up to that synchronize.
        self._dispatch_step = self._synced(self.train_step)
        self._dispatch_multi = None if self.multi_step is None else self._synced(self.multi_step)
        if telemetry is not None:
            reg = telemetry.registry
            self._m_loss = reg.gauge("train_loss", "streaming epoch train loss")
            self._m_acc = reg.gauge("train_accuracy", "streaming token accuracy")
            self._m_gnorm = reg.gauge("train_grad_norm", "latest global grad norm")
            self._m_eloss = reg.gauge("train_eval_loss", "latest eval loss")
            self._m_eacc = reg.gauge("train_eval_accuracy", "latest eval accuracy")
            self._m_steps = reg.counter("train_steps_total", "optimizer steps")
            self._m_tokens = reg.counter("train_tokens_total", "target tokens")
            # The sample stream StepTimer fills, exported as it is.
            reg.histogram(
                "train_step_seconds",
                "per-step wall time: each dispatch up to its device synchronize, "
                "divided by its steps",
                hist=self.step_timer.histogram,
            )
            self._wrap_steps_for_dispatch_timing()

    def _synced(self, fn: Callable) -> Callable:
        def dispatch(state, src, tgt):
            out = fn(state, src, tgt)
            synchronize(self.device)
            return out

        dispatch.__wrapped__ = fn
        return dispatch

    def _wrap_steps_for_dispatch_timing(self) -> None:
        """The dispatch callables through ``obs.telemetry.timed_call``, then
        the profiler's ``profile_call("train.step")``, then, with a tracer,
        ``obs.trace.traced_call`` (one ``train.step`` span per dispatch,
        under ``train.fit``), chained through ``__wrapped__``. Each wraps a
        callable that ends in the device synchronize, so each times the
        dispatch's device work, not its launch."""
        from transformer_tpu_torch.obs.telemetry import timed_call

        self._m_dispatch = self.telemetry.registry.histogram(
            "train_dispatch_seconds",
            "host seconds per dispatch call (one step, or K), up to its device synchronize",
        )
        names = ["_dispatch_step"] + (["_dispatch_multi"] if self._dispatch_multi else [])
        for name in names:
            setattr(self, name, timed_call(getattr(self, name), self._m_dispatch))
        profiler = getattr(self.telemetry, "profiler", None)
        if profiler is not None:
            from transformer_tpu_torch.obs.profile import profile_call

            for name in names:
                setattr(self, name, profile_call(getattr(self, name), profiler, "train.step"))
        if self._tracer is not None:
            from transformer_tpu_torch.obs.trace import traced_call

            for name in names:
                setattr(self, name, traced_call(getattr(self, name), self._tracer, "train.step",
                                                lane="train"))

    def _span(self, name: str, **attrs):
        """A ``train``-lane span, or a no-op context without a tracer; the
        trainer's spans parent through the tracer's thread-local stack
        (everything nests under ``train.fit``)."""
        if self._tracer is None:
            return _NO_SPAN
        return self._tracer.span(name, lane="train", **attrs)

    def evaluate(
        self, batches: Iterable, max_batches: int | None = None,
        guard: PreemptionGuard | None = None,
    ) -> None:
        with self._span("train.eval"):
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
            if self.telemetry is not None:
                self.telemetry.emit("ckpt.fallback", step=int(step),
                                    reason=f"{type(exc).__name__}: {exc}")

        with self._span("ckpt.restore"):
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
        return stops the run after that checkpoint. With a tracer the whole
        run is one ``train.fit`` span."""
        with self._span("train.fit", epochs=self.train_cfg.epochs):
            self._fit(train_ds, test_ds, epoch_callback)

    def _fit(self, train_ds, test_ds, epoch_callback) -> None:
        cfg = self.train_cfg
        if cfg.steps_per_dispatch > 1 and self.multi_step is None:
            raise ValueError(
                "steps_per_dispatch > 1 requires enable_function=True on the "
                "single-process Trainer: the multi-step dispatch replays a captured "
                "CUDA graph of the step; in eager-debug mode it would silently fall "
                "back to single-step dispatch"
            )
        self._emit_cost_prediction()
        if self.checkpoint is not None:
            self._restore()
        step = self.state.step
        start_epoch = 0
        try:  # a streaming dataset has no length: it restarts at epoch 1
            steps_per_epoch = len(train_ds)
        except TypeError:
            steps_per_epoch = 0
        if step and steps_per_epoch:
            start_epoch = min(step // steps_per_epoch, cfg.epochs)
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
                self.step_timer.reset()
                self._window_mark = (0, 0, 0.0)
                epoch_start = time.perf_counter()
                batches = train_ds.batches(epoch)
                if self.multi_step is not None:
                    groups = _dispatch_groups(batches, cfg.steps_per_dispatch)
                else:
                    groups = ((s, t, 1) for s, t in batches)
                for src, tgt, k in groups:
                    if self.profiler is not None:
                        self.profiler.maybe_trace(step, block_on=self.state)
                    t0 = time.perf_counter()
                    with annotate("train.step") if self.profiler is not None else _NO_SPAN:
                        if self.multi_step is None:
                            self.state, m = self._dispatch_step(self.state, src, tgt)
                            tokens = tgt.shape[0] * self._width(tgt.shape[1])
                        else:
                            if k == 1:  # a group of one replays the step too
                                src, tgt = np.asarray(src)[None], np.asarray(tgt)[None]
                            self.state, m = self._dispatch_multi(self.state, src, tgt)
                            tokens = k * tgt.shape[1] * self._width(tgt.shape[2])
                    seconds = time.perf_counter() - t0
                    self.dispatches.append((k, seconds))
                    self.step_seconds.extend([seconds / k] * k)
                    self.step_timer.observe(seconds, tokens, steps=k)
                    self.losses.append(float(m["loss"]))
                    self.tokens += tokens
                    self.train_metrics.update(m)
                    self._last_metrics = m
                    prev_step, step = step, step + k
                    if guard.should_stop:
                        self._preempt(step, guard)
                        return
                    # Boundary-crossing, so that a K-step dispatch that jumps
                    # over a log or eval step still logs or evaluates; for
                    # k == 1 this is step % N == 0.
                    every = cfg.log_every_steps
                    if every and step // every != prev_step // every:
                        aux = self.train_metrics.moe_aux
                        self.log_fn(
                            f"epoch {epoch + 1} step {step} loss {self.train_metrics.loss:.4f} "
                            f"acc {self.train_metrics.accuracy:.4f} "
                            + (f"moe_aux {aux:.3f} " if aux is not None else "")
                            + f"grad_norm {float(m['grad_norm']):.4f}"
                        )
                        self._record_train_window(epoch, step)
                    every = cfg.eval_every_steps
                    if test_ds is not None and every and step // every != prev_step // every:
                        self.evaluate(test_ds.batches(epoch),
                                      max_batches=cfg.eval_max_batches or None, guard=guard)
                        self.log_fn(
                            f"  eval loss {self.eval_metrics.loss:.4f} "
                            f"acc {self.eval_metrics.accuracy:.4f}"
                        )
                        self._record_eval(epoch, step)
                epoch_loss = self.train_metrics.loss
                if guard.should_stop:
                    self._preempt(step, guard)
                    return
                if test_ds is not None:
                    self.evaluate(test_ds.batches(epoch), guard=guard)
                    if guard.should_stop:
                        self._preempt(step, guard)
                        return
                    self._record_eval(epoch, step)
                synchronize(self.device)
                self._write_epoch_summaries(epoch)
                self._record_train_window(epoch, step)
                self._record_epoch_telemetry(epoch, step)
                self.log_fn(
                    f"epoch {epoch + 1}/{cfg.epochs} done in {time.perf_counter() - epoch_start:.1f}s: "
                    f"loss {epoch_loss:.4f} acc {self.train_metrics.accuracy:.4f}"
                    + (f"; eval loss {self.eval_metrics.loss:.4f}" if test_ds is not None else "")
                    + f"; {self.step_timer.summary()}"
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
                    with self._span("ckpt.save", step=step):
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
        if self.profiler is not None:
            self.profiler.stop(block_on=self.state)
        if self.telemetry is not None:
            self.telemetry.maybe_flush(force=True)

    # ------------------------------------------------------------- telemetry
    # The recorders run where the loop has already synchronized the device
    # (every dispatch ends in one) and read the metrics back: host float
    # reads, never device work.

    def _record_train_window(self, epoch: int, step: int) -> None:
        if self.telemetry is None:
            return
        st = self.step_timer
        m_steps, m_tokens, m_time = self._window_mark
        d_steps = st.count - m_steps
        if d_steps <= 0:
            return
        d_tokens = st.total_tokens - m_tokens
        window_s = st.total_time_s - m_time
        self._window_mark = (st.count, st.total_tokens, st.total_time_s)
        loss, acc = self.train_metrics.loss, self.train_metrics.accuracy
        self._m_loss.set(loss)
        self._m_acc.set(acc)
        self._m_steps.inc(d_steps)
        self._m_tokens.inc(d_tokens)
        event = {
            "epoch": epoch + 1, "step": step, "steps": d_steps,
            "tokens": d_tokens, "window_s": round(window_s, 6),
            "loss": round(loss, 6), "accuracy": round(acc, 6),
        }
        if window_s > 0:
            event["steps_per_sec"] = round(d_steps / window_s, 3)
            event["tokens_per_sec"] = round(d_tokens / window_s, 1)
        if self._last_metrics is not None and "grad_norm" in self._last_metrics:
            gnorm = float(self._last_metrics["grad_norm"])
            self._m_gnorm.set(gnorm)
            event["grad_norm"] = round(gnorm, 6)
        self.telemetry.emit("train.window", **event)
        self.telemetry.maybe_flush()

    def _record_eval(self, epoch: int, step: int) -> None:
        if self.telemetry is None or self.eval_metrics.weight <= 0:
            return
        loss, acc = self.eval_metrics.loss, self.eval_metrics.accuracy
        self._m_eloss.set(loss)
        self._m_eacc.set(acc)
        self.telemetry.emit("train.eval", epoch=epoch + 1, step=step,
                            loss=round(loss, 6), accuracy=round(acc, 6))

    def _emit_cost_prediction(self) -> None:
        """One ``train.predicted`` event at fit start: the cost model's
        peak bytes, FLOPs and bytes moved for THIS run's plain train step
        (``analysis/costs.py`` ``train_step_costs``, traced on the
        ``meta`` device: nothing runs on the card), and the
        ``train_predicted_peak_bytes`` gauge. ``obs summarize`` holds it
        against the ``train.memory`` samples and reports measured /
        predicted. One device's prediction: a ``DistributedTrainer``
        inherits it as a per-replica bound. Advisory, as in the JAX
        trainer: a config the model cannot trace logs "cost-model
        prediction unavailable" and training goes on. Emitted once per
        Trainer (``cli.train`` may call ``fit`` more than once)."""
        if self.telemetry is None or getattr(self, "_cost_predicted", False):
            return
        self._cost_predicted = True
        try:
            from transformer_tpu_torch.analysis.costs import train_step_costs

            r = train_step_costs(self.model_cfg, self.train_cfg)
        except Exception as e:  # advisory: a failed trace never fails training
            self.log_fn(f"cost-model prediction unavailable ({type(e).__name__}: {e})")
            return
        self.telemetry.registry.gauge(
            "train_predicted_peak_bytes",
            "cost model (meta-device trace): train-step peak live-buffer bytes",
        ).set(r.peak_bytes)
        self.telemetry.emit(
            "train.predicted",
            program="train_step",
            peak_bytes=r.peak_bytes,
            flops=r.flops,
            bytes_moved=r.bytes_moved,
            tokens_per_step=r.extras.get("tokens_per_step"),
        )

    def _record_epoch_telemetry(self, epoch: int, step: int) -> None:
        """Epoch-end extras: the card's allocator statistics
        (``train.memory``, none on the CPU) and the captured CUDA graphs of
        the step callables (``train.compile``: JAX's compiled-program
        accounting; the port compiles nothing at run time, its counterpart
        is a graph per batch signature, and an uncaptured callable counts
        0)."""
        if self.telemetry is None:
            return
        from transformer_tpu_torch.device import device_memory_stats

        stats = device_memory_stats(self.device)
        if stats:
            for key in ("bytes_in_use", "peak_bytes_in_use"):
                self.telemetry.registry.gauge(
                    f"device_{key}", "CUDA caching allocator stats, this process's card"
                ).set(stats[key])
            index = self.device.index if self.device.index is not None else torch.cuda.current_device()
            self.telemetry.emit("train.memory", epoch=epoch + 1, step=step,
                                devices={str(index): stats})
        cache_sizes = {"train_step": 0}
        if self.multi_step is not None:
            cache_sizes["multi_step"] = 0 if self.graph is None else len(self.graph.graphs)
        cache_sizes["eval_step"] = 0
        self.telemetry.registry.gauge(
            "train_compiled_programs", "CUDA graphs captured across the step callables",
        ).set(sum(cache_sizes.values()))
        self.telemetry.emit("train.compile", epoch=epoch + 1, step=step,
                            cache_sizes=cache_sizes)
        self.telemetry.maybe_flush(force=True)

    def _write_epoch_summaries(self, epoch: int) -> None:
        if not self.writers:
            return
        from transformer_tpu_torch.train.state import make_lr_schedule

        w = self.writers["train"]
        w.scalar("loss", self.train_metrics.loss, epoch)
        w.scalar("accuracy", self.train_metrics.accuracy, epoch)
        if self.train_metrics.moe_aux is not None:
            w.scalar("moe_aux", self.train_metrics.moe_aux, epoch)
        lr = make_lr_schedule(self.model_cfg, self.train_cfg)(self.state.step)
        w.scalar("learning_rate", float(lr), epoch)
        w.scalar("tokens_per_sec", self.step_timer.tokens_per_sec, epoch)
        if self._last_metrics is not None and "grad_norm" in self._last_metrics:
            w.scalar("grad_norm", float(self._last_metrics["grad_norm"]), epoch)
        # The step-duration distribution in TensorBoard's histogram dashboard.
        w.histogram("step_time_s", self.step_timer.histogram, epoch)
        w.flush()
        if self.eval_metrics.weight > 0:
            w = self.writers["test"]
            w.scalar("loss", self.eval_metrics.loss, epoch)
            w.scalar("accuracy", self.eval_metrics.accuracy, epoch)
            w.flush()

    def _width(self, length: int) -> int:
        """Positions a (B, length) batch feeds the model: the whole window
        under the MLM objective, one fewer under the causal shift."""
        return length if self.train_cfg.objective == "mlm" else max(length - 1, 1)

    def _preempt(self, step: int, guard: PreemptionGuard) -> None:
        """On SIGTERM/SIGINT: save, wait until the save is durable, report."""
        if self.profiler is not None:
            self.profiler.stop(block_on=self.state)
        prefix = f"preemption (signal {guard.signal_received}) at step {step}: "
        if self.checkpoint is None:
            self.log_fn(prefix + "no checkpoint manager configured, state lost")
        else:
            with self._span("ckpt.save", step=step, preempt=True):
                path = self.checkpoint.save(self.state)
                self.checkpoint.wait()
            if self.train_cfg.early_stop_patience:
                self._save_plateau_state(step)
            if path is None:
                self.log_fn(prefix + "checkpoint written by primary process")
            else:
                self.log_fn(prefix + f"checkpoint saved to {path}")
        for w in self.writers.values():
            w.flush()
        if self.telemetry is not None:
            self.telemetry.emit("train.preempt", step=step, signal=guard.signal_received)
            self.telemetry.maybe_flush(force=True)

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
