"""The distributed trainer: data × sequence parallelism over processes.

Port of ``put_batch``, ``DistributedTrainer`` and the sequence logic of
``_seq_parallel_forward`` from ``transformer_tpu/parallel/distributed.py``.
The JAX package jits one step over global arrays and lets GSPMD split
them; here every process runs the same step on its own part:

- every process reads the same global batch and keeps its slice: rows by
  its ``data`` coordinate and, with ``seq > 1``, one sequence chunk by its
  ``seq`` coordinate, after the teacher-forcing input (and a seq2seq
  model's source, on its own) is padded with PAD to a multiple of ``seq``
  (4095 -> 4096 at long4k); the padded positions' logits are dropped;
- the forward runs under the sequence-parallel context at the chunk's
  global offset, so ``mha_apply(impl="ring" | "ulysses")`` runs its core
  over the process group of this ``seq`` ring; a seq2seq decoder's
  cross-attention reads the encoder output gathered to the whole source
  under the whole source's padding mask; dropout draws the global masks
  (``ops.nn.GlobalSlice``), on the source and target sides each;
- the loss is normalised by the global token count (or global batch);
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
from transformer_tpu_torch.ops.nn import GlobalSlice
from transformer_tpu_torch.parallel.mesh import Mesh
from transformer_tpu_torch.parallel.seq_context import SeqParallelContext, sequence_parallel
from transformer_tpu_torch.train.checkpoint import CheckpointManager
from transformer_tpu_torch.train.state import TrainState, create_train_state
from transformer_tpu_torch.train.trainer import Trainer, loss_from_hidden


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
    on the global batch, this process's part of it (and of a seq2seq
    source), the forward under the sequence-parallel context (when ``seq >
    1``), and the masked CE (chunked with ``loss_chunks > 1``) over the
    part's real positions, normalised globally."""
    sp = mesh.shape["seq"]

    def forward_loss(params, tgt, model_cfg, train_cfg, key, reference=False, src=None):
        inp, out = tgt[:, :-1], tgt[:, 1:]
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
                hidden = transformer_hidden_apply(params, src_part, inp_part, model_cfg, **kw)
        else:
            hidden = transformer_hidden_apply(params, src_part, inp_part, model_cfg, **kw)
        real = min(inp_part.shape[1], inp.shape[1] - col)  # drop the padded positions
        total = (out != PAD_ID).sum().float()  # every process holds the whole batch
        return loss_from_hidden(
            params, hidden[:, :real], out_part[:, :real], model_cfg, train_cfg, total_weight=total
        )

    return forward_loss


def check_mesh(model_cfg: ModelConfig, train_cfg: TrainConfig, mesh: Mesh) -> None:
    """The JAX trainer's checks, and the axes and models the port does not
    run over processes."""
    if model_cfg.encoder_only:
        raise NotImplementedError(
            "encoder-only (masked-LM) models are not trained over processes in the port yet"
        )
    shape = mesh.shape
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
    same checkpoint at the start of ``fit``."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        train_cfg: TrainConfig,
        mesh: Mesh,
        state: TrainState | None = None,
        log_fn: Callable[[str], None] = print,
        checkpoint: CheckpointManager | None = None,
    ) -> None:
        check_mesh(model_cfg, train_cfg, mesh)
        if state is None:
            state = create_train_state(model_cfg, train_cfg, device=mesh.device)
        mesh.broadcast_(list(flatten(state.params).values()))
        self.mesh = mesh
        super().__init__(
            model_cfg, train_cfg, state, log_fn,
            forward_loss=_seq_parallel_forward_loss(mesh), sum_across=mesh.all_reduce_sum_,
            checkpoint=checkpoint,
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

