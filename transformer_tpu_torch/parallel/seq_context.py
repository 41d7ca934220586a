"""Sequence-parallel execution context.

Port of ``transformer_tpu/parallel/seq_context.py``. The model code
(``ops.attention.mha_apply``) knows nothing of processes; the distributed
trainer enters ``sequence_parallel(ctx)`` around its forward, and
``mha_apply(impl="ring")`` reads the context to run its attention core
over the ring. Unlike the JAX twin, whose context holds a mesh and whose
attention sees global arrays under ``shard_map``, each process here holds
its own chunk of every activation, so the context says where that chunk
sits: the ring's process group, this process's rank in it, the ring size
and the chunk's global offset (for rope).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any

import torch


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
    """Ring attention over this process's (B, C, H, D) chunks. Grouped kv
    heads ride the ring at their own count: the JAX twin repeats them only
    when a ``model`` axis misaligns the groups, and the port has no model
    axis. Ulysses is not ported."""
    if impl == "ulysses":
        raise NotImplementedError(
            "attention_impl='ulysses' is not ported yet; use attention_impl='ring'"
        )
    from transformer_tpu_torch.parallel.ring_attention import ring_attention

    return ring_attention(q, k, v, group=ctx.group, kv_mask=kv_mask, causal=causal,
                          window=window)
