"""The distributed trainer: data × sequence parallelism over processes.

Port of ``put_batch``, ``DistributedTrainer`` and the sequence logic of
``_seq_parallel_forward`` from ``transformer_tpu/parallel/distributed.py``.
The JAX package jits one step over global arrays and lets GSPMD split
them; here every process runs the same step on its own part:

- every process reads the same global batch and keeps its slice: rows by
  its ``data`` coordinate and, with ``seq > 1``, one sequence chunk by its
  ``seq`` coordinate, after the teacher-forcing input (and a seq2seq
  model's source, on its own) is padded with PAD to a multiple of ``seq``
  (4095 -> 4096 at long4k); the padded positions' logits are dropped. An
  encoder-only model's masked-LM batch is masked on the whole global batch
  first, from the step's generator, so each process's rows carry the
  masks the one-process step draws for them (``seq`` > 1 is refused for
  it, as in JAX);
- the forward runs under the sequence-parallel context at the chunk's
  global offset, so ``mha_apply(impl="ring" | "ulysses")`` runs its core
  over the process group of this ``seq`` ring; a seq2seq decoder's
  cross-attention reads the encoder output gathered to the whole source
  under the whole source's padding mask; dropout draws the global masks
  (``ops.nn.GlobalSlice``), on the source and target sides each;
- the loss is normalised by the global token count (or global batch);
  a MoE layer's first-choice counts and live-token count are summed over
  the processes before its load-balance loss is formed
  (``ops.moe.moe_stats_reducer``), so the aux is the global batch's, as
  in the JAX package's single program, and each process's share of it
  (and of its gradient, through the router probabilities) sums to it;
  gradients and metric sums are summed over all processes before
  ``grad_norm`` and Adam, so every process takes the same update;
- the parameters are broadcast from rank 0 at start;
- with ``steps_per_dispatch`` = K > 1 the K steps of a dispatch are the
  single-process trainer's (one staged copy, metrics summed on the device,
  one synchronize a dispatch) but run uncaptured: over gloo the sums go
  through host memory, which a CUDA graph cannot capture, and capture over
  NCCL is not ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch

from transformer_tpu_torch.config import PAD_ID, ModelConfig, TrainConfig
from transformer_tpu_torch.models.transformer import flatten, transformer_hidden_apply
from transformer_tpu_torch.ops.masks import make_padding_mask
from transformer_tpu_torch.ops.moe import moe_stats_reducer
from transformer_tpu_torch.ops.nn import GlobalSlice
from transformer_tpu_torch.parallel.mesh import Mesh
from transformer_tpu_torch.parallel.seq_context import SeqParallelContext, sequence_parallel
from transformer_tpu_torch.train.checkpoint import CheckpointManager
from transformer_tpu_torch.train.state import TrainState, create_train_state
from transformer_tpu_torch.train.trainer import (
    Trainer,
    _prepare_batch,
    loss_from_hidden,
    with_moe_aux,
)


def _pad_to(batch: torch.Tensor, multiple: int) -> torch.Tensor:
    extra = (-batch.shape[1]) % multiple
    return torch.nn.functional.pad(batch, (0, extra), value=PAD_ID) if extra else batch


def put_batch(batch: torch.Tensor, mesh: Mesh) -> tuple[torch.Tensor, int, int]:
    """This process's part of a global (B, S) batch: its rows, and with
    ``seq > 1`` its chunk of the sequence padded with PAD to a multiple of
    ``seq``. Returns (part, first global row, first global position)."""
    sp, dp = mesh.shape["seq"], mesh.shape["data"]
    batch = _pad_to(batch, sp)
    b, s = batch.shape
    rows, chunk = b // dp, s // sp
    row, col = mesh.index("data") * rows, mesh.index("seq") * chunk
    return batch[row : row + rows, col : col + chunk], row, col


def _seq_parallel_forward_loss(mesh: Mesh) -> Callable:
    """The ``forward_loss`` hook of ``Trainer``: the teacher-forcing shift
    (or the MLM's masking) on the global batch, this process's part of it
    (and of a seq2seq source), the forward under the sequence-parallel
    context (when ``seq > 1``), and the masked CE (chunked with
    ``loss_chunks > 1``) over the part's real positions, normalised
    globally."""
    sp = mesh.shape["seq"]

    def forward_loss(params, tgt, model_cfg, train_cfg, key, reference=False, src=None,
                     prepared=None):
        inp, out, key = prepared or _prepare_batch(model_cfg, train_cfg, tgt, key)
        inp_part, row, col = put_batch(inp, mesh)
        out_part, _, _ = put_batch(out, mesh)
        rows = inp_part.shape[0]
        kw = dict(key=key, deterministic=key is None, reference=reference,
                  position_offset=col,
                  dropout_slice=GlobalSlice(inp.shape[0], inp.shape[1], row, col))
        src_part = None
        if src is not None:
            src_part, _, src_col = put_batch(src, mesh)
            kw.update(src_offset=src_col,
                      src_slice=GlobalSlice(src.shape[0], src.shape[1], row, src_col))
            if sp > 1:  # every process holds the whole batch: the whole source's mask
                kw["source_mask"] = make_padding_mask(_pad_to(src, sp)[row : row + rows])
        if sp > 1:
            ctx = SeqParallelContext(mesh.seq_group, mesh.index("seq"), sp, col)
            with sequence_parallel(ctx):
                hidden, aux = transformer_hidden_apply(params, src_part, inp_part, model_cfg,
                                                       return_aux=True, **kw)
        else:
            with moe_stats_reducer(_sum_over_processes(mesh)):
                hidden, aux = transformer_hidden_apply(params, src_part, inp_part, model_cfg,
                                                       return_aux=True, **kw)
        real = min(inp_part.shape[1], inp.shape[1] - col)  # drop the padded positions
        total = (out != PAD_ID).sum().float()  # every process holds the whole batch
        return with_moe_aux(loss_from_hidden(
            params, hidden[:, :real], out_part[:, :real], model_cfg, train_cfg, total_weight=total
        ), aux, model_cfg)

    return forward_loss


def _sum_over_processes(mesh: Mesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """The MoE statistics' sum over every process (``ops.moe``): the
    counts the JAX package's single program takes over the global batch.
    Outside autograd: the counts carry no gradient."""

    def reduce(stats: torch.Tensor) -> torch.Tensor:
        out = stats.detach().clone()
        mesh.all_reduce_sum_([out])
        return out

    return reduce


def check_moe_mesh(model_cfg: ModelConfig, axes: dict[str, int]) -> None:
    """MoE runs over the ``data`` axis alone in the port: the expert,
    sequence and pipeline axes with experts are a later slice."""
    if not model_cfg.moe_experts:
        return
    for axis, flag in (("expert", "ep"), ("seq", "sp"), ("pipe", "pp")):
        if axes.get(axis, 1) > 1:
            raise NotImplementedError(
                f"--{flag} > 1 with --moe_experts: MoE over the {axis} axis is a later slice "
                "of the port (it trains MoE on one card and under --dp)"
            )


def check_mesh(model_cfg: ModelConfig, train_cfg: TrainConfig, mesh: Mesh) -> None:
    """The JAX trainer's checks, and the axes the port does not run over
    processes."""
    shape = mesh.shape
    check_moe_mesh(model_cfg, shape)
    if model_cfg.encoder_only and (shape["pipe"] > 1 or shape["seq"] > 1):
        raise ValueError(
            "encoder_only models support data/fsdp/model/expert mesh axes; "
            "pipe and seq are not wired for the encoder-only forward"
        )
    others = {a: n for a, n in shape.items() if a not in ("data", "seq") and n > 1}
    if others or mesh.cfg.dcn_data > 1:
        raise NotImplementedError(
            f"the port runs data and seq parallelism; {others or {'dcn_data': mesh.cfg.dcn_data}} "
            "is not ported yet"
        )
    if train_cfg.batch_size % shape["data"]:
        raise ValueError(
            f"global batch size {train_cfg.batch_size} must be divisible "
            f"by data×fsdp×expert = {shape['data']} "
            "(reference check: distributed_train.py:154-158)"
        )
    micro = train_cfg.batch_size // max(1, train_cfg.grad_accum_steps)
    if train_cfg.grad_accum_steps > 1 and micro % shape["data"]:
        raise ValueError(
            f"the micro-batch of {micro} rows (batch {train_cfg.batch_size} / grad_accum_steps "
            f"{train_cfg.grad_accum_steps}) must be divisible by data = {shape['data']}"
        )
    if shape["seq"] > 1:
        if model_cfg.attention_impl not in ("ring", "ulysses"):
            raise ValueError(
                f"MeshConfig(seq={shape['seq']}) needs a sequence-"
                "parallel attention impl: set ModelConfig(attention_impl="
                "'ring') (or 'ulysses'); plain "
                f"{model_cfg.attention_impl!r} attention would all-gather "
                "the sequence and defeat the axis"
            )
        if model_cfg.attention_impl == "ulysses" and model_cfg.num_heads % shape["seq"]:
            raise ValueError(
                f"ulysses needs num_heads ({model_cfg.num_heads}) divisible by the seq axis "
                f"({shape['seq']})"
            )


class DistributedTrainer(Trainer):
    """``Trainer`` whose steps run over the processes of ``mesh``: each
    process holds the whole (replicated) train state and its part of each
    batch; the ``data × seq`` sums make the update the same everywhere.
    ``state`` defaults to a fresh one from ``train_cfg.seed`` on the mesh's
    device; rank 0's parameters are broadcast to every process. With a
    ``checkpoint`` manager rank 0 writes and every process restores the
    same checkpoint at the start of ``fit``. ``log_dir``, ``profiler`` and
    ``telemetry`` are ``Trainer``'s (``cli.distributed_train`` gives them to
    rank 0 alone)."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        train_cfg: TrainConfig,
        mesh: Mesh,
        state: TrainState | None = None,
        log_fn: Callable[[str], None] = print,
        checkpoint: CheckpointManager | None = None,
        log_dir: str | None = None,
        profiler=None,
        telemetry=None,
    ) -> None:
        check_mesh(model_cfg, train_cfg, mesh)
        if state is None:
            state = create_train_state(model_cfg, train_cfg, device=mesh.device)
        mesh.broadcast_(list(flatten(state.params).values()))
        self.mesh = mesh
        super().__init__(
            model_cfg, train_cfg, state, log_fn,
            forward_loss=_seq_parallel_forward_loss(mesh), sum_across=mesh.all_reduce_sum_,
            checkpoint=checkpoint, log_dir=log_dir, profiler=profiler, telemetry=telemetry,
        )
        if train_cfg.steps_per_dispatch > 1:
            why = {
                "gloo": "its sums go through host memory, which a CUDA graph cannot capture",
                "nccl": "capture over NCCL is not ported yet",
            }.get(mesh.process.transport, "the distributed trainer does not capture its steps")
            log_fn(
                f"steps_per_dispatch {train_cfg.steps_per_dispatch}: the steps of a dispatch "
                f"run uncaptured (transport {mesh.process.transport}: {why})"
            )

