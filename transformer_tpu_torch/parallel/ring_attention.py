"""Sequence parallelism: ring attention over ``torch.distributed``.

Port of ``ring_attention`` from ``transformer_tpu/parallel/ring_attention.py``.
Activations are split along the sequence over the processes of a ``seq``
ring: process i holds query, key and value chunk i, at global positions
[i·C, (i+1)·C). Each process folds every key/value chunk into an
online-softmax carry as the chunks rotate around the ring, one
``flash_ring_step`` per hop, so no process ever holds a (C, C) score
tensor. The backward recomputes probability tiles from the forward's
global logsumexp (``flash_chunk_bwd`` per hop) while dK and dV ride the
ring home with their chunks.

Where the JAX package rotates with ``lax.ppermute`` over ICI inside
``shard_map``, ``ring_shift`` here sends to ring rank + 1 and receives
from ring rank − 1 with ``dist.batch_isend_irecv``, on the card under NCCL
and through host memory under gloo (``parallel/mesh.py``). Every rank
makes the same shifts in the same order, hops it skips included: under
remat the ring forward runs again inside the backward, and a rank that
missed a shift would leave its neighbours waiting for ever.

``ulysses_attention`` is the other sequence-parallel core: one
all-to-all turns the (B, C, H, D) chunks into (B, S, H/P, D) head blocks,
the whole-sequence flash kernels run on them, and one all-to-all turns
the output back; the backward of each all-to-all is the inverse one.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from transformer_tpu_torch.kernels.flash_attention import (
    TMA_ALIGN,
    check_args,
    flash_chunk_bwd,
    flash_ring_step,
)
from transformer_tpu_torch.kernels.paged_flash import MASKED
from transformer_tpu_torch.parallel import mesh as _mesh


def _pack(tensors: list[torch.Tensor]) -> torch.Tensor:
    """The tensors' bytes in one uint8 buffer, each on a TMA_ALIGN-byte
    boundary, so that every piece views back as its dtype and k/v views
    can feed the bf16 kernels' tensor maps."""
    parts = []
    for t in tensors:
        raw = t.contiguous().reshape(-1).view(torch.uint8)
        parts += [raw, raw.new_zeros((-raw.numel()) % TMA_ALIGN)]
    return torch.cat(parts)


def _unpack(buf: torch.Tensor, like: list[torch.Tensor]) -> list[torch.Tensor]:
    """The inverse of ``_pack``: views of ``buf`` in the shapes and dtypes
    of ``like``."""
    out, off = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(buf[off : off + n].view(t.dtype).reshape(t.shape))
        off += n + (-n) % TMA_ALIGN
    return out


def ring_shift(tensors: list, group: Any, offset: int = 1) -> list:
    """Each rank of ``group``'s ring sends ``tensors`` to ring rank +
    ``offset`` and returns what ring rank − ``offset`` sent: one
    ``batch_isend_irecv`` pair over the tensors packed into one byte
    buffer. Under gloo, CUDA tensors are copied to the host and back
    (``mesh.staged_bytes["ring"]`` counts both copies). A ring of one, or
    no group, returns the tensors themselves."""
    if group is None or dist.get_world_size(group) == 1 or offset % dist.get_world_size(group) == 0:
        return list(tensors)
    size, me = dist.get_world_size(group), dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + offset) % size)
    src = dist.get_global_rank(group, (me - offset) % size)
    device = tensors[0].device
    send = _pack(tensors)
    stage = _mesh.staged(device, group)
    if stage:
        send = send.cpu()
    recv = torch.empty_like(send)
    for req in dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, dst, group),
        dist.P2POp(dist.irecv, recv, src, group),
    ]):
        req.wait()
    if stage:
        _mesh.staged_bytes["ring"] += 2 * recv.numel()
        recv = recv.to(device)
    return _unpack(recv, tensors)


@dataclasses.dataclass(frozen=True)
class _RingConfig:
    """The ring's static layout: ``group`` (None for a ring of one), this
    process's ``rank`` in it, its ``size``, causality, and the sliding
    window with the chunk length it is measured against."""

    group: Any
    rank: int
    size: int
    causal: bool
    window: int = 0
    chunk: int = 0

    def kept_hops(self) -> int:
        """How many hops can contribute at all: hop t is dead once even its
        newest key (local col C-1 against local row 0) is out of the window
        (W <= t·C - C + 1), and it stays dead for larger t, so the ring
        stops early. Without a window: every hop."""
        if not self.window:
            return self.size
        t = 0
        while t < self.size and self.window > t * self.chunk - self.chunk + 1:
            t += 1
        return t

    def hop_band(self, t: int) -> int | None:
        """Hop t's band in local coordinates: the visiting chunk sits t
        chunks behind, so col_global > row_global - W becomes col > row -
        (W - t·C), of any sign."""
        return (self.window - t * self.chunk) if self.window else None

    def folds(self, t: int) -> tuple[bool, bool]:
        """(whether hop t folds its chunk, whether the pair is diagonal):
        on a causal ring the chunks from later positions (src > rank) are
        skipped and the diagonal pair is causal in local coordinates."""
        src = (self.rank - t) % self.size
        if not self.causal:
            return True, False
        return src <= self.rank, src == self.rank


def _ring_fwd_impl(cfg: _RingConfig, q, k, v, kv_mask):
    """One ``flash_ring_step`` per kept hop, a shift after every hop but
    the last, then ``out = acc / l`` and ``lse = m + log l``."""
    b, c, h, d = q.shape
    m = torch.full((b, h, c), MASKED, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, c, h, d), dtype=torch.float32, device=q.device)
    travel = [k, v] + ([kv_mask] if kv_mask is not None else [])
    hops = cfg.kept_hops()
    for t in range(hops):
        fold, diagonal = cfg.folds(t)
        if fold:
            mask = travel[2] if kv_mask is not None else None
            flash_ring_step(q, travel[0], travel[1], mask, m, l, acc, causal=diagonal,
                            band=cfg.hop_band(t))
        if t + 1 < hops:
            travel = ring_shift(travel, cfg.group)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / l_safe.permute(0, 2, 1)[..., None]).to(q.dtype)
    return out, m + torch.log(l_safe)


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, q, k, v, kv_mask):
        out, lse = _ring_fwd_impl(cfg, q, k, v, kv_mask)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, d_out):
        """dq sums locally; dk and dv ride the ring with their k and v, in
        fp32, each hop's parts rounded to the inputs' dtypes first (as the
        JAX twin sums them). A full ring shifts after every hop, so after
        P hops every chunk and its gradient are home; a ring that the
        window stops early skips the last shift and re-homes dk/dv with one
        shift over the remaining distance."""
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        cfg = ctx.cfg
        do = d_out.to(q.dtype).contiguous()
        delta = (do.float() * out.float()).sum(dim=-1).permute(0, 2, 1).contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        travel = [k, v, dk, dv] + ([kv_mask] if kv_mask is not None else [])
        hops = cfg.kept_hops()
        for t in range(hops):
            fold, diagonal = cfg.folds(t)
            if fold:
                mask = travel[4] if kv_mask is not None else None
                dq_s, dk_s, dv_s = flash_chunk_bwd(
                    q, travel[0], travel[1], mask, lse, delta, do, causal=diagonal,
                    band=cfg.hop_band(t),
                )
                dq += dq_s.float()
                travel[2] = travel[2] + dk_s.float()
                travel[3] = travel[3] + dv_s.float()
            if t + 1 < hops or hops == cfg.size:
                travel = ring_shift(travel, cfg.group)
        dk, dv = travel[2], travel[3]
        if hops < cfg.size:
            dk, dv = ring_shift([dk, dv], cfg.group, offset=cfg.size - (hops - 1))
        return None, dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def _all_to_all(parts: list[list[torch.Tensor]], group: Any, kind: str) -> list[list[torch.Tensor]]:
    """Each rank of ``group`` sends ``parts[j]`` (a list of tensors, of the
    same shapes and dtypes for every j and on every rank) to ring rank j
    and returns ``recv``, where ``recv[i]`` is what ring rank i sent here:
    one ``all_to_all_single`` over the tensors packed (``_pack``) into one
    byte buffer per destination. Under gloo, CUDA tensors are copied to the
    host and back (``mesh.staged_bytes[kind]`` counts both copies)."""
    size = len(parts)
    if group is None or size == 1:
        return [list(p) for p in parts]
    device = parts[0][0].device
    send = torch.stack([_pack(p) for p in parts])  # (P, bytes per destination)
    stage = _mesh.staged(device, group)
    if stage:
        send = send.cpu()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    if stage:
        _mesh.staged_bytes[kind] += 2 * recv.numel()
        recv = recv.to(device)
    return [_unpack(recv[i], parts[0]) for i in range(size)]


def _seq_to_heads(tensors: list[torch.Tensor], group: Any, size: int,
                  whole: list[torch.Tensor] = ()) -> list[torch.Tensor]:
    """(B, C, heads, D) chunks -> (B, S, heads / P, D) head blocks: ring
    rank j gets head block j of every chunk, in chunk order. Each (B, C,
    ...) tensor of ``whole`` goes to every rank in the same exchange and
    comes back gathered to (B, S, ...)."""
    parts = [[t.unflatten(2, (size, -1))[:, :, j] for t in tensors] + list(whole)
             for j in range(size)]
    recv = _all_to_all(parts, group, "ulysses")
    return [torch.cat([r[n] for r in recv], dim=1) for n in range(len(parts[0]))]


def _heads_to_seq(tensors: list[torch.Tensor], group: Any, size: int) -> list[torch.Tensor]:
    """The inverse of ``_seq_to_heads``: (B, S, heads / P, D) head blocks
    -> (B, C, heads, D) chunks."""
    parts = [[t.unflatten(1, (size, -1))[:, j] for t in tensors] for j in range(size)]
    recv = _all_to_all(parts, group, "ulysses")
    return [torch.cat([r[n] for r in recv], dim=2) for n in range(len(tensors))]


class _SeqToHeads(torch.autograd.Function):
    """q, k, v chunks -> their head blocks over the whole sequence, and the
    key mask chunks gathered to (B, S) in the same exchange."""

    @staticmethod
    def forward(ctx, group, size, q, k, v, kv_mask):
        ctx.group, ctx.size = group, size
        if kv_mask is None:
            return (*_seq_to_heads([q, k, v], group, size), None)
        out = _seq_to_heads([q, k, v], group, size, whole=[kv_mask])
        ctx.mark_non_differentiable(out[3])
        return tuple(out)

    @staticmethod
    def backward(ctx, dq, dk, dv, _):
        dq, dk, dv = _heads_to_seq([dq, dk, dv], ctx.group, ctx.size)
        return None, None, dq, dk, dv, None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, size, out):
        ctx.group, ctx.size = group, size
        return _heads_to_seq([out], group, size)[0]

    @staticmethod
    def backward(ctx, d_out):
        return None, None, _seq_to_heads([d_out], ctx.group, ctx.size)[0]


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group: Any,
    kv_mask: torch.Tensor | None = None,
    causal: bool = False,
    window: int = 0,
) -> torch.Tensor:
    """Ulysses sequence parallelism over the processes of ``group``;
    differentiable. Port of the JAX package's ``ulysses_attention``.

    ``q`` (B, C, H, D) and ``k``/``v`` (B, C, H_kv, D) are this process's
    chunks, chunk i on ring rank i. One all-to-all gives ring rank j head
    block j of every chunk, (B, S, H/P, D) for q and (B, S, H_kv/P, D) for
    k/v (query block j pairs with kv block j: the local groups are the
    global ones), with the (B, C) key masks gathered to (B, S) in the same
    exchange; the whole-sequence ``flash_attention`` runs on them (the
    causal flag and the window apply unchanged), and one all-to-all back
    returns (B, C, H, D) in q's dtype. H and H_kv must be multiples of the
    ring size (``seq_context.seq_parallel_attention`` repeats the kv heads
    first when H_kv is not). ``group`` None is a ring of one."""
    from transformer_tpu_torch.kernels.flash_attention import flash_attention

    check_args(q, k, v, kv_mask, causal, window)
    size = 1 if group is None else dist.get_world_size(group)
    h, h_kv = q.shape[2], k.shape[2]
    if h % size:
        raise ValueError(f"ulysses needs num_heads ({h}) divisible by the seq axis ({size})")
    if h_kv % size:
        raise ValueError(
            f"ulysses with grouped kv needs kv heads ({h_kv}) divisible by "
            f"the seq axis ({size}); repeat kv to full heads first"
        )
    if kv_mask is not None:
        kv_mask = kv_mask.expand(q.shape[0], q.shape[1]).contiguous()
    q_full, k_full, v_full, mask_full = _SeqToHeads.apply(group, size, q, k, v, kv_mask)
    out = flash_attention(q_full, k_full, v_full, kv_mask=mask_full, causal=causal,
                          window=window)
    return _HeadsToSeq.apply(group, size, out)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group: Any,
    kv_mask: torch.Tensor | None = None,
    causal: bool = False,
    window: int = 0,
) -> torch.Tensor:
    """Blockwise ring attention over the sequence chunks of ``group``'s
    processes; differentiable.

    ``q`` (B, C, H, D) and ``k``/``v`` (B, C, H_kv, D) are this process's
    chunks, C = S / ring size, chunk i on ring rank i; grouped kv heads stay
    at H_kv through the ring, so the shifts carry H_kv heads. ``kv_mask``
    (B, C) is True for a real key. ``causal`` is structural across global
    positions; ``window`` (needs ``causal``) bounds each row to its last
    ``window`` keys, and the ring stops after the hops that can still
    reach them. ``group`` None is a ring of one. Returns (B, C, H, D) in
    q's dtype.
    """
    check_args(q, k, v, kv_mask, causal, window)
    c = q.shape[1]
    if k.shape[1] != c:
        raise ValueError(f"ring chunks must match: q {c} keys, k/v {k.shape[1]}")
    size = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    cfg = _RingConfig(group, rank, size, bool(causal), int(window), c)
    if kv_mask is not None:
        kv_mask = kv_mask.expand(q.shape[0], c).contiguous()
    return _Ring.apply(cfg, q, k, v, kv_mask)
