"""Mixture-of-Experts feed-forward layer.

Port of ``transformer_tpu/ops/moe.py``: a router, then ``E`` independent
FFNs stacked on a leading axis (``in/kernel`` (E, d, dff), ``out/kernel``
(E, dff, d)), top-k gating renormalised over the chosen experts, a fixed
capacity of ``C`` token slots per (batch row, expert), earlier tokens and
earlier choices first, and the Switch load-balance loss ``E * sum_e f_e *
p_e`` over the real tokens. Every batch row is a routing group.

The routing math is the JAX twin's, value for value: router logits in
fp32 (never TF32), a softmax, the k choices in ``jax.lax.top_k``'s order
(the lower index first on a tie: k ``argmax`` passes, each masking the
one before, since ``torch.topk`` promises no order among equal values),
gates renormalised with the 1e-9 floor, slot positions by a cumsum along
the row per choice with capacity counted across the k passes, tokens that
overflow dropped, PAD tokens (``token_mask``) claiming no slot and left
out of the statistics. A choice that fits but whose gate is 0 uses up its
slot and sends nothing to it, as the twin's ``dispatch = combine > 0``.

The twin's one-hot (B, S, E, C) dispatch and combine tensors are not
built: at a 4k context they hold 168 M entries per layer. Each (token,
choice) gets a slot index instead, and the layer is two gathers around
two batched products, all in fixed shapes (a dropped choice points at a
trash slot), with no host synchronize, so a CUDA graph captures it:

- dispatch: ``xe[e, b*C + c] = x[b, s]`` for the token whose choice sits
  in slot (b, e, c) (a zero row for an empty slot);
- the experts: ``act(xe @ in + b_in) @ out + b_out`` as two ``matmul``
  calls batched over E, in the compute dtype;
- combine: ``y[b, s] = sum_j w_j * ye[slot_j]`` in choice order, in fp32,
  cast once to the compute dtype (the weights ``w_j = gate_j * fits_j``
  cast to it first, as the twin casts ``combine``).

Both gathers have hand-written backwards that are gathers too, summed in
choice order: each slot holds at most one token and each token's k slots
are distinct, so no float atomics run and the step is bit-reproducible
(the backward of ``index_add_``/``scatter_add_`` or of an advanced-index
gather with repeated indices is not, on CUDA).

``expert_mesh`` and ``_constrain`` of the twin are GSPMD sharding hints;
over processes they are collectives (``parallel/collectives.py``): under
``--ep`` each process holds E/ep experts, its rows' token slots go to the
processes holding their experts by one all-to-all and come back by
another; under ``--tp`` each expert's dff is split, its ``in`` by columns
and ``out`` by rows, summed over the model group before ``out/bias``.
Under ``--sp`` a row is gathered over the sequence ring before routing,
so its capacity and slot order are the whole sequence's, as in the twin;
each process keeps its chunk of the output. Over processes the
statistic's ``f_e`` and live-token count must be the global batch's, as
in the JAX package's single SPMD program: ``moe_stats_reducer`` installs
the sum across the batch's processes (``parallel.distributed``); only
``p_e`` carries a gradient, each process's over its own positions, so
each process's aux is its share of ``E * sum_e f_e * p_e`` and the shares
sum to the global value and gradient.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from collections.abc import Callable

import torch

from transformer_tpu_torch.ops.ffn import _ACTIVATIONS
from transformer_tpu_torch.ops.nn import Params
from transformer_tpu_torch.parallel import collectives as _collectives
from transformer_tpu_torch.parallel.seq_context import current_seq_context, gather_sequence

_REDUCER: contextvars.ContextVar[Callable | None] = contextvars.ContextVar(
    "moe_stats_reducer", default=None
)


@contextlib.contextmanager
def moe_stats_reducer(fn: Callable[[torch.Tensor], torch.Tensor]):
    """Inside the block, ``moe_apply`` passes its (E + 1,) fp32 vector of
    first-choice counts and live-token count through ``fn`` (a sum over
    processes) before it forms the load-balance loss."""
    token = _REDUCER.set(fn)
    try:
        yield
    finally:
        _REDUCER.reset(token)


def glorot_experts(generator: torch.Generator, e: int, d_in: int, d_out: int) -> torch.Tensor:
    """(e, d_in, d_out) glorot-uniform draws with each expert's own fans
    (d_in, d_out), as the twin's stacked per-expert init."""
    limit = (6.0 / (d_in + d_out)) ** 0.5
    return (torch.rand((e, d_in, d_out), generator=generator) * 2.0 - 1.0) * limit


def moe_init(
    generator: torch.Generator,
    d_model: int,
    dff: int,
    num_experts: int,
    param_dtype=torch.float32,
    device="cpu",
) -> Params:
    """Router plus ``num_experts`` FFNs stacked on a leading E axis, with
    the twin's layout and distributions (different numbers): a 1-expert
    MoE is parameter for parameter the dense FFN."""
    E = num_experts
    limit = (6.0 / (d_model + E)) ** 0.5
    router = (torch.rand((d_model, E), generator=generator) * 2.0 - 1.0) * limit
    leaves = {
        "router": {"kernel": router},
        "in": {"kernel": glorot_experts(generator, E, d_model, dff),
               "bias": torch.zeros((E, dff))},
        "out": {"kernel": glorot_experts(generator, E, dff, d_model),
                "bias": torch.zeros((E, d_model))},
    }
    return {name: {k: v.to(dtype=param_dtype, device=device) for k, v in leaf.items()}
            for name, leaf in leaves.items()}


def expert_capacity(
    seq_len: int, num_experts: int, top_k: int, capacity_factor: float
) -> int:
    """Token slots per (batch row, expert): the even share ``S * k / E``
    scaled by the capacity factor, at least 1, at most S."""
    even = seq_len * top_k / num_experts
    return max(1, min(seq_len, math.ceil(even * capacity_factor)))


@contextlib.contextmanager
def _no_tf32():
    """fp32 products at full precision inside the block, whatever the
    process-wide TF32 setting is."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _pad_row(t: torch.Tensor) -> torch.Tensor:
    """``t`` with one zero row appended (the target of "no token" and "no
    slot" indices)."""
    return torch.cat([t, t.new_zeros((1,) + tuple(t.shape[1:]))])


def _sum_choices(rows: torch.Tensor, slots: torch.Tensor, weights=None) -> torch.Tensor:
    """fp32 ``sum_j weights[:, j] * rows[slots[:, j]]`` in choice order."""
    acc = None
    for j in range(slots.shape[1]):
        term = rows.index_select(0, slots[:, j]).float()
        if weights is not None:
            term = weights[:, j : j + 1].float() * term
        acc = term if acc is None else acc + term
    return acc


class _Dispatch(torch.autograd.Function):
    """``xe[q] = x[src[q]]`` (src N: a zero row); the backward gathers
    each token's k slots of ``dxe`` (slot Q: nothing) and sums them in
    choice order."""

    @staticmethod
    def forward(ctx, x, src, slots):
        ctx.save_for_backward(slots)
        return _pad_row(x).index_select(0, src)

    @staticmethod
    def backward(ctx, dxe):
        (slots,) = ctx.saved_tensors
        return _sum_choices(_pad_row(dxe), slots).to(dxe.dtype), None, None


class _Combine(torch.autograd.Function):
    """``y[n] = sum_j w[n, j] * ye[slots[n, j]]`` (slot Q: a zero row),
    summed in fp32 and cast once. ``owner[q]`` is the flat (n * k + j)
    index of the choice in slot q (N * k: none), so the backward's
    ``dye`` and ``dw`` are gathers as well."""

    @staticmethod
    def forward(ctx, ye, w, slots, owner):
        ctx.save_for_backward(ye, w, slots, owner)
        return _sum_choices(_pad_row(ye), slots, w).to(ye.dtype)

    @staticmethod
    def backward(ctx, dy):
        ye, w, slots, owner = ctx.saved_tensors
        n, k = w.shape
        token = torch.div(owner, k, rounding_mode="floor")  # owner n*k -> row n: zeros
        w_owner = _pad_row(w.reshape(-1)).index_select(0, owner).float()
        dye = (w_owner[:, None] * _pad_row(dy).index_select(0, token).float()).to(ye.dtype)
        ye_pad, dy32 = _pad_row(ye), dy.float()
        dw = torch.stack(
            [(dy32 * ye_pad.index_select(0, slots[:, j]).float()).sum(-1) for j in range(k)],
            dim=-1,
        )
        return dye, dw.to(w.dtype), None, None


def _one_hot(i: torch.Tensor, n: int) -> torch.Tensor:
    """int64 one-hot of ``i`` over ``n`` classes, by comparison (no check
    that reads the indices back to the host)."""
    return (i[..., None] == torch.arange(n, device=i.device)).long()


def _top_k(probs: torch.Tensor, k: int) -> torch.Tensor:
    """(..., k) expert indices in ``jax.lax.top_k``'s order: descending,
    the lower index first among equal values."""
    picks = []
    masked = probs
    for _ in range(k):
        i = masked.argmax(dim=-1)  # the first maximal index
        picks.append(i)
        masked = masked.masked_fill(_one_hot(i, probs.shape[-1]).bool(), -1.0)
    return torch.stack(picks, dim=-1)


def moe_route(
    probs: torch.Tensor, k: int, capacity: int, live: torch.Tensor | None = None
) -> dict[str, torch.Tensor]:
    """The twin's routing bookkeeping on (B, S, E) router probabilities:
    ``indices`` (B, S, k) experts, ``gates`` (B, S, k) renormalised fp32
    gates, ``position`` (B, S, k) slot within the expert's capacity,
    ``fits`` (B, S, k) bool (a live choice that got a slot), all without
    a host synchronize."""
    B, S, E = probs.shape
    indices = _top_k(probs, k)
    gates = probs.gather(-1, indices)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    counts = torch.zeros((B, E, 1), dtype=torch.long, device=probs.device)
    positions, fits = [], []
    for j in range(k):
        # (B, E, S): the cumsum runs along the innermost axis (a scan along
        # an outer axis is one slow sequential pass per column on CUDA).
        oh = _one_hot(indices[..., j], E).transpose(1, 2).contiguous()
        if live is not None:
            oh = oh * live[:, None, :].long()  # PADs claim no slot
        pos = torch.cumsum(oh, dim=-1) - oh + counts
        pos_j = pos.gather(1, indices[:, None, :, j])[:, 0]
        fit = (pos_j < capacity) & (oh.sum(1) > 0)
        counts = counts + (oh * fit[:, None, :]).sum(dim=-1, keepdim=True)
        positions.append(pos_j)
        fits.append(fit)
    return {"indices": indices, "gates": gates, "position": torch.stack(positions, -1),
            "fits": torch.stack(fits, -1)}


def moe_apply(
    params: Params,
    x: torch.Tensor,
    *,
    num_experts: int,
    top_k: int = 2,
    capacity_factor: float = 1.25,
    activation: str = "relu",
    token_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S, M) -> ((B, S, M), fp32 aux loss). Dropped tokens give zeros
    (the caller's residual carries them through). ``token_mask`` (B, S)
    bool, True = real token: PADs are neither dispatched nor counted in
    the load-balance statistics."""
    seq = current_seq_context()
    chunk = None
    if seq is not None and seq.size > 1:
        # each row routes over its whole sequence, as the JAX twin's global
        # arrays do: gather it, run the layer on it, keep this chunk
        chunk = x.shape[1]
        if token_mask is not None:
            token_mask = gather_sequence(token_mask.bool().expand(x.shape[0], chunk)
                                         .contiguous(), seq)
        x = gather_sequence(x, seq)
    B, S, M = x.shape
    E, k = num_experts, min(top_k, num_experts)
    C = expert_capacity(S, E, k, capacity_factor)
    act = _ACTIVATIONS[activation]
    dtype, dev = x.dtype, x.device
    N, Q = B * S, E * B * C

    # --- routing (fp32) -----------------------------------------------------
    with _no_tf32():
        logits = torch.matmul(x.float(), params["router"]["kernel"].float())
    probs = torch.softmax(logits, dim=-1)  # (B, S, E)
    live = None if token_mask is None else token_mask.bool().expand(B, S)
    r = moe_route(probs, k, C, live)
    indices, gates, fits = r["indices"], r["gates"], r["fits"]

    # Slot (b, e, c) is flat q = (e * B + b) * C + c; Q = no slot.
    rows = torch.arange(B, device=dev)[:, None, None]
    q = (indices * B + rows) * C + torch.clamp(r["position"], max=C - 1)
    slots = torch.where(fits, q, Q).reshape(N, k)
    sent = fits & (gates > 0)  # the twin dispatches where combine > 0
    # owner[q]: the flat choice (n * k + j) in slot q; N * k = none. Each
    # slot holds at most one choice; the others write to their own trash.
    choice = torch.arange(N * k, device=dev)
    owner = torch.full((Q + N * k,), N * k, dtype=torch.long, device=dev)
    owner.scatter_(0, torch.where(slots.reshape(-1) < Q, slots.reshape(-1), Q + choice), choice)
    owner = owner[:Q]
    is_sent = _pad_row(sent.reshape(-1))
    src = torch.where(is_sent.index_select(0, owner),
                      torch.div(owner, k, rounding_mode="floor"), N)
    sent_slots = torch.where(sent.reshape(N, k), slots, Q)

    # --- the experts (compute dtype) ------------------------------------------
    xe = _Dispatch.apply(x.reshape(N, M), src, sent_slots).reshape(E, B * C, M)
    tp = _collectives.current()
    ep = tp.ep if tp is not None and tp.experts else 1
    if ep > 1:  # the slots to the ranks holding their experts: (E/ep, ep * B * C, M)
        xe = _collectives.expert_all_to_all(xe.reshape(ep, E // ep, B * C, M))
        xe = xe.transpose(0, 1).reshape(E // ep, ep * B * C, M)
    tp_ffn = tp is not None and tp.moe_ffn
    if tp_ffn:
        xe = _collectives.copy_to_model(xe)
    h = act(torch.matmul(xe, params["in"]["kernel"].to(dtype))
            + params["in"]["bias"].to(dtype)[:, None, :])
    ye = torch.matmul(h, params["out"]["kernel"].to(dtype))
    if tp_ffn:
        ye = _collectives.reduce_from_model(ye)
    ye = ye + params["out"]["bias"].to(dtype)[:, None, :]
    if ep > 1:  # and back to the ranks holding their tokens
        ye = ye.reshape(E // ep, ep, B * C, M).transpose(0, 1).contiguous()
        ye = _collectives.expert_all_to_all(ye).reshape(E, B * C, M)
    w = (gates * fits).reshape(N, k).to(dtype)
    y = _Combine.apply(ye.reshape(Q, M), w, slots, owner).reshape(B, S, M)

    # --- load-balance loss (Switch: E * sum_e f_e * p_e) ---------------------
    first = _one_hot(indices[..., 0], E).float()
    own = probs  # the positions whose router probabilities are this process's share
    if chunk is not None:
        lo = seq.rank * chunk
        y, own = y[:, lo : lo + chunk], probs[:, lo : lo + chunk]
    if live is None:
        f_sum, p_sum = first.sum(dim=(0, 1)), own.sum(dim=(0, 1))
        n = torch.full((1,), float(N), device=dev)
    else:
        lw = live.float()[..., None]
        f_sum = (first * lw).sum(dim=(0, 1))
        own_lw = lw if chunk is None else lw[:, lo : lo + chunk]
        p_sum = (own * own_lw).sum(dim=(0, 1))
        n = lw.sum().reshape(1)
    reducer = _REDUCER.get()
    if reducer is not None:
        stats = reducer(torch.cat([f_sum, n]))
        f_sum, n = stats[:E], stats[E:]
    n = torch.clamp(n, min=1.0)
    aux = E * torch.sum((f_sum / n) * (p_sum / n))
    return y, aux
