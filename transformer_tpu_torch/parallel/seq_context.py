"""Sequence-parallel execution context.

Port of ``transformer_tpu/parallel/seq_context.py``. The model code
(``ops.attention.mha_apply``) knows nothing of processes; the distributed
trainer enters ``sequence_parallel(ctx)`` around its forward, and
``mha_apply(impl="ring" | "ulysses")`` reads the context to run its
attention core over the ring's processes. Unlike the JAX twin, whose
context holds a mesh and whose attention sees global arrays under
``shard_map``, each process here holds its own chunk of every activation,
so the context says where that chunk sits: the ring's process group, this
process's rank in it, the ring size and the chunk's global offset (for
rope). Where GSPMD would all-gather a sequence-split activation that a
later op reads whole (the encoder output under cross-attention),
``gather_sequence`` does it explicitly.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from transformer_tpu_torch.parallel import mesh as _mesh

@dataclasses.dataclass(frozen=True)
class SeqParallelContext:
    group: Any  # the seq ring's process group; None is a ring of one
    rank: int  # this process's position in the ring
    size: int  # processes in the ring
    offset: int  # global position of this chunk's first token


_ctx: contextvars.ContextVar[SeqParallelContext | None] = contextvars.ContextVar(
    "sequence_parallel_context", default=None
)


@contextlib.contextmanager
def sequence_parallel(ctx: SeqParallelContext):
    """Activate sequence parallelism for every ``mha_apply`` run inside."""
    token = _ctx.set(ctx)
    try:
        yield ctx
    finally:
        _ctx.reset(token)


def current_seq_context() -> SeqParallelContext | None:
    return _ctx.get()


def seq_parallel_attention(
    ctx: SeqParallelContext,
    impl: str,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor | None,
    causal: bool,
    window: int = 0,
) -> torch.Tensor:
    """Ring or Ulysses attention over this process's (B, C, H, D) chunks.
    Grouped kv heads ride at their own count, as in the JAX twin, except in
    its one corner the port can reach: Ulysses splits the heads over the
    ring, so kv heads that the ring size does not divide are repeated to
    the query heads first. (The JAX twin's other corner, kv heads
    misaligned with a ``model`` axis, needs an axis the port has not.)"""
    from transformer_tpu_torch.parallel.ring_attention import ring_attention, ulysses_attention

    if impl == "ulysses":
        if k.shape[2] != q.shape[2] and k.shape[2] % ctx.size:
            reps = q.shape[2] // k.shape[2]
            k, v = k.repeat_interleave(reps, dim=2), v.repeat_interleave(reps, dim=2)
        return ulysses_attention(q, k, v, group=ctx.group, kv_mask=kv_mask, causal=causal,
                                 window=window)
    return ring_attention(q, k, v, group=ctx.group, kv_mask=kv_mask, causal=causal,
                          window=window)


class _GatherSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, size, x):
        ctx.group, ctx.rank, ctx.chunk = group, dist.get_rank(group), x.shape[1]
        raw = x.contiguous().view(torch.uint8)  # any dtype rides gloo as bytes
        stage = _mesh.staged(x.device, group)
        send = raw.cpu() if stage else raw
        parts = [torch.empty_like(send) for _ in range(size)]
        dist.all_gather(parts, send, group=group)
        full = torch.cat(parts, dim=1)
        if stage:
            _mesh.staged_bytes["gather"] += send.numel() + full.numel()
            full = full.to(x.device)
        return full.view(x.dtype)

    @staticmethod
    def backward(ctx, d_full):
        grad = d_full.float().contiguous()
        stage = _mesh.staged(grad.device, ctx.group)
        buf = grad.cpu() if stage else grad.clone()  # the sum must not write into d_full
        dist.all_reduce(buf, group=ctx.group)
        start = ctx.rank * ctx.chunk
        mine = buf[:, start : start + ctx.chunk]
        if stage:
            _mesh.staged_bytes["gather"] += buf.numel() * 4 + mine.numel() * 4
            mine = mine.to(grad.device)
        return None, None, mine.to(d_full.dtype)


def gather_sequence(x: torch.Tensor, ctx: SeqParallelContext) -> torch.Tensor:
    """This process's (B, C, ...) chunk -> the whole (B, S, ...) sequence,
    chunk i from ring rank i; differentiable. The backward sums the whole
    sequence's gradient over the ring (each process's consumers read every
    chunk) and keeps this process's slice. Under gloo, CUDA tensors go
    through host memory (``mesh.staged_bytes["gather"]``). A ring of one
    returns ``x``."""
    if ctx.group is None or ctx.size == 1:
        return x
    return _GatherSequence.apply(ctx.group, ctx.size, x)
