"""Tensor and expert parallelism over processes: the collectives GSPMD
inserts, written out.

In the JAX package the ``model`` and ``expert`` axes are sharding
annotations (``parallel/sharding.py``'s rules, ``ops/moe.py``'s
``_constrain``) and XLA inserts the all-reduces and all-to-alls. Here each
process holds its slice of every leaf those axes split
(``sharding.leaf_split``), and the ops run on their slices inside the
``model_parallel`` context, calling these functions where GSPMD would put
a collective (a Megatron-style split):

- ``copy_to_model``: identity forward, all-reduce over ``model`` backward,
  on the replicated input of a column-split product (the q/k/v
  projections, the FFN's ``in``/``gate``, an expert's ``in``, the vocab
  projection): each model rank's gradient of it is partial;
- ``reduce_from_model``: all-reduce over ``model`` forward, identity
  backward, on the partial output of a row-split product (attention's
  ``out``, the FFN's ``out``, an expert's ``out``), before its replicated
  bias;
- ``scatter_to_model``: this rank's slice forward, all-gather backward
  (grouped-query K/V that the model axis does not divide stay whole on
  every rank, are repeated to the query heads, and each rank takes its
  heads, as JAX's fallback repeats them);
- ``expert_all_to_all``: token slots to the ranks that hold their experts
  over ``expert``; its backward is the same exchange of the gradients;
- ``vocab_parallel_cross_entropy``: the masked CE of vocabulary-split
  logits, its max, sum of exponentials, target logit and (label
  smoothing) sum of logits all-reduced over ``model``, never the (B, S,
  V) logits themselves.

Everything that reads a replicated activation computes the same bytes on
every model rank (dropout draws the same masks, from the same keys), so
the gradients of replicated leaves are equal over ``model`` and never
summed over it, with one exception (``summed_over_model``): the rules
leave the FFN's ``out`` kernel whole (its name matches the 3-dim
``out/kernel`` rule first, in JAX too), and each model rank reads its
rows of it, so its gradient is summed over ``model``. Sums run in fp32; under gloo, CUDA tensors go through
host memory, and ``mesh.staged_bytes`` counts those bytes under "tp" and
"ep".
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
class ModelParallel:
    """Where this process sits on the ``model`` and ``expert`` axes, and
    which of the model's products those axes split (the partition rules'
    decisions: a dim its axis does not divide stays whole)."""

    mesh: Any
    tp: int  # ranks on the model axis
    ep: int  # ranks on the expert axis
    heads: bool  # query heads (and attention's out rows) split over model
    kv: bool  # key/value heads split over model (else whole and repeated)
    ffn: bool  # the dense FFN's dff split over model
    ffn_out_whole: bool  # ... while its ``out`` kernel is whole (read in row slices)
    moe_ffn: bool  # each expert's dff split over model
    experts: bool  # the experts split over expert
    vocab: bool  # the output layer's vocabulary split over model

    @property
    def model_rank(self) -> int:
        return self.mesh.index("model")


def for_model(mesh, cfg) -> ModelParallel | None:
    """The context of ``cfg`` on ``mesh``, or None when the mesh's model
    and expert axes hold one rank each. Each flag is the partition rule's
    own decision for a leaf of that product."""
    from transformer_tpu_torch.parallel.sharding import leaf_split

    tp, ep = mesh.shape["model"], mesh.shape["expert"]
    if tp == 1 and ep == 1:
        return None
    shape = mesh.shape
    d, f, v, e = cfg.d_model, cfg.dff, cfg.target_vocab_size, max(1, cfg.moe_experts)

    def split(name, dims, axis):
        return axis in leaf_split(name, dims, shape).values()

    return ModelParallel(
        mesh, tp, ep,
        heads=split("mha/query/kernel", (d, cfg.num_heads, cfg.head_dim), "model"),
        kv=split("mha/key/kernel", (d, cfg.kv_heads, cfg.head_dim), "model"),
        ffn=split("ffn/in/kernel", (d, f), "model"),
        # JAX's rules match ``ffn/out/kernel`` with the 3-dim ``out/kernel``
        # rule first, which leaves the 2-dim leaf whole
        ffn_out_whole=not split("ffn/out/kernel", (f, d), "model"),
        moe_ffn=split("moe/in/kernel", (e, d, f), "model"),
        experts=split("moe/in/kernel", (e, d, f), "expert"),
        vocab=not cfg.tie_output and split("final/kernel", (d, v), "model"),
    )


_CTX: contextvars.ContextVar[ModelParallel | None] = contextvars.ContextVar(
    "model_parallel", default=None
)


@contextlib.contextmanager
def model_parallel(ctx: ModelParallel | None):
    """Run the ops inside on this process's slices of the model and expert
    axes (a no-op for None)."""
    token = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(token)


def current() -> ModelParallel | None:
    return _CTX.get()


def summed_over_model(name: str, ctx: ModelParallel | None) -> bool:
    """Whether the gradient of the whole leaf ``name`` is summed over
    ``model``: the FFN's ``out`` kernel, which the rules leave whole while
    each model rank reads its rows of it (its gradient is zero outside
    them)."""
    return (ctx is not None and ctx.tp > 1 and ctx.ffn and ctx.ffn_out_whole
            and name.endswith("ffn/out/kernel"))


def _reduce(t: torch.Tensor, mesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` (a contiguous tensor the call may overwrite) reduced by ``op``
    over the model group, staged through the host under gloo."""
    pg = mesh.pg("model")
    stage = _mesh.staged(t.device, pg)
    host = t.cpu() if stage else t
    dist.all_reduce(host, op=op, group=pg)
    if stage:
        _mesh.staged_bytes["tp"] += 2 * host.numel() * host.element_size()
        host = host.to(t.device)
    return host


def _sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed over the model group in fp32, back in its dtype (a new
    tensor)."""
    return _reduce(t.detach().float().contiguous().clone(), mesh).to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return None, _sum(grad, ctx.mesh)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x):
        return _sum(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return None, grad


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x, dim):
        ctx.mesh, ctx.dim = mesh, dim
        width = x.shape[dim] // mesh.shape["model"]
        return x.narrow(dim, mesh.index("model") * width, width).contiguous()

    @staticmethod
    def backward(ctx, grad):
        mesh, pg = ctx.mesh, ctx.mesh.pg("model")
        buf = grad.contiguous()
        stage = _mesh.staged(buf.device, pg)
        send = buf.cpu() if stage else buf
        parts = [torch.empty_like(send) for _ in range(mesh.shape["model"])]
        dist.all_gather(parts, send, group=pg)
        full = torch.cat(parts, dim=ctx.dim)
        if stage:
            _mesh.staged_bytes["tp"] += (send.numel() + full.numel()) * send.element_size()
            full = full.to(grad.device)
        return None, full, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` (replicated over ``model``); its gradient is summed over
    ``model``. The identity outside a model-parallel context."""
    ctx = current()
    if ctx is None or ctx.tp == 1:
        return x
    return _CopyToModel.apply(ctx.mesh, x)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """This rank's partial sum ``x`` summed over ``model``."""
    ctx = current()
    if ctx is None or ctx.tp == 1:
        return x
    return _ReduceFromModel.apply(ctx.mesh, x)


def scatter_to_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's slice along ``dim`` of ``x`` (replicated over
    ``model``); its gradient is gathered back to the whole ``x``."""
    ctx = current()
    if ctx is None or ctx.tp == 1:
        return x
    return _ScatterToModel.apply(ctx.mesh, x, dim)


def _exchange(x: torch.Tensor, mesh) -> torch.Tensor:
    """The all-to-all over ``expert`` of ``x`` (ep, ...): block j goes to
    expert rank j, block i of the result came from expert rank i."""
    pg = mesh.pg("expert")
    send = x.contiguous().view(torch.uint8) if x.dtype != torch.uint8 else x.contiguous()
    stage = _mesh.staged(send.device, pg)
    host = send.cpu() if stage else send
    recv = torch.empty_like(host)
    dist.all_to_all_single(recv, host, group=pg)
    if stage:
        _mesh.staged_bytes["ep"] += 2 * recv.numel()
        recv = recv.to(x.device)
    return recv.view(x.dtype)


class _ExpertAllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x):
        ctx.mesh = mesh
        return _exchange(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return None, _exchange(grad, ctx.mesh)


def expert_all_to_all(x: torch.Tensor) -> torch.Tensor:
    """(ep, ...) blocks, block j for expert rank j -> (ep, ...) blocks,
    block i from expert rank i; differentiable (the backward sends each
    gradient block back where its slots came from)."""
    ctx = current()
    if ctx is None or ctx.ep == 1:
        return x
    return _ExpertAllToAll.apply(ctx.mesh, x)


class _VocabParallelCE(torch.autograd.Function):
    """Per-token CE (label-smoothed) of fp32 logits split over the
    vocabulary: this rank holds columns [lo, lo + V/tp) of V."""

    @staticmethod
    def forward(ctx, mesh, logits, targets, vocab, smoothing):
        n_local = logits.shape[-1]
        lo = mesh.index("model") * n_local
        local_max, local_arg = logits.max(dim=-1)
        m = _reduce(local_max.clone(), mesh, dist.ReduceOp.MAX)
        shifted = logits - m[..., None]
        exp = torch.exp(shifted)
        in_range = (targets >= lo) & (targets < lo + n_local)
        local_t = torch.where(in_range, targets - lo, torch.zeros_like(targets))
        t_logit = shifted.gather(-1, local_t[..., None])[..., 0] * in_range
        sums = torch.stack([exp.sum(-1), t_logit, shifted.sum(-1)])
        sums = _reduce(sums, mesh, dist.ReduceOp.SUM)
        lse = torch.log(sums[0])  # of the shifted logits
        target_logp = sums[1] - lse
        confidence = 1.0 - smoothing
        if smoothing > 0.0:
            uniform = smoothing / (vocab - 1)
            smooth_sum = (sums[2] - vocab * lse) - target_logp
            per_token = -(confidence * target_logp + uniform * smooth_sum)
        else:
            uniform = 0.0
            per_token = -target_logp
        # the first maximal index over the whole vocabulary, as argmax
        cand = torch.where(local_max == m, local_arg + lo, torch.full_like(local_arg, vocab))
        argmax = _reduce(cand.float(), mesh, dist.ReduceOp.MIN).long()  # exact below 2^24
        ctx.save_for_backward(exp / sums[0][..., None], local_t, in_range)
        ctx.confidence, ctx.uniform, ctx.vocab = confidence, uniform, vocab
        ctx.mark_non_differentiable(argmax)
        return per_token, argmax

    @staticmethod
    def backward(ctx, grad, _):
        probs, local_t, in_range = ctx.saved_tensors
        c, u = ctx.confidence, ctx.uniform
        # d per_token / d logit_v = (c - u)(p_v - [v = t]) - u (1 - V p_v)
        d = (c - u) * probs - u * (1.0 - ctx.vocab * probs)
        hit = torch.zeros_like(probs).scatter_(-1, local_t[..., None],
                                               in_range[..., None].to(probs.dtype))
        d = d - (c - u) * hit
        return None, d * grad[..., None], None, None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, targets: torch.Tensor, vocab: int,
                                 label_smoothing: float = 0.0):
    """(per-token fp32 CE, argmax over the whole vocabulary) of this rank's
    vocabulary columns ``logits`` (..., V/tp) against ``targets`` (...)."""
    ctx = current()
    return _VocabParallelCE.apply(ctx.mesh, logits.float(), targets.long(), vocab,
                                  float(label_smoothing))
