"""Blockwise (flash) attention, forward and backward, and the ring step.

Port of ``flash_attention``, ``flash_ring_step`` and ``flash_chunk_bwd``
from ``transformer_tpu/kernels/flash_attention.py`` (the cache-free
attention of ``mha_apply(impl="flash")`` and the per-hop work of ring
attention). Four kernels, one per TPU kernel, each behind a wrapper that
launches the hand-written CUDA kernel of ``csrc/flash_attention.cu`` on
CUDA tensors and runs the plain PyTorch version beside it on CPU tensors:

- ``flash_fwd`` / ``flash_fwd_plain`` (``_fwd_kernel``): ``out`` and the
  per-row fp32 logsumexp ``lse``;
- ``flash_ring_step`` / ``flash_ring_step_plain`` (``_ring_step_kernel``):
  one KV chunk folded into an online-softmax carry ``(m, l, acc)``;
- ``flash_dq`` / ``flash_dq_plain`` (``_dq_kernel``): dQ, with P recomputed
  from ``lse`` and ``delta = rowsum(dO·O)``;
- ``flash_dkdv`` / ``flash_dkdv_plain`` (``_dkdv_kernel``): dK and dV,
  summed over each kv head's group of query heads.

``flash_attention`` ties the first and the last two together as a
``torch.autograd.Function``; ``flash_chunk_bwd`` is the last two for one
(q, KV chunk) pair of a ring.

Masking: ``kv_mask`` drops padding keys; ``causal`` allows ``col <= row``;
``band`` (an int of any sign, or None) allows ``col > row - band``, apart
from causality, as ``_FlashConfig.band``: a ring hop ``t`` of a sliding
window ``W`` over chunks of ``C`` passes ``band = W - t·C``. The public
``flash_attention`` keeps the JAX function's ``window`` (> 0 needs
``causal``; it is the band ``window``).

Numerics, the TPU kernels' casts in the same places (T = q's dtype):
scores are ``q·k`` over T values with fp32 accumulation, times the scale
in fp32 (no rounding to T); masked scores are ``MASKED`` and exp-guarded
to exactly 0, so fully-masked rows give ``out = 0``, ``lse = MASKED`` and
zero gradients; the normaliser sums unrounded fp32 ``p``, and every
product with a second operand (P·V, dS·K, Pᵀ·dO, dSᵀ·Q) takes its fp32
left operand rounded to T. The plain versions do one softmax over the
whole row where the kernels walk tiles with an online softmax, so in bf16
they differ by where ``p`` is rounded (the row maximum against running
maxima); the bf16 kernels also sum their products on the tensor cores, in
another order.

Layouts are the JAX function's: (B, S, H, D) activations, k/v with H_kv
heads (grouped-query attention, query head ``h`` reads kv head
``h // (H / H_kv)``), ``kv_mask`` (B, S_k) bool with True for a real key;
``lse`` and ``delta`` are (B, H, S_q) fp32; the ring carry is ``m`` and
``l`` (B, H, S_q) fp32 and ``acc`` (B, S_q, H, D) fp32.
"""

from __future__ import annotations

import ctypes

import torch

from transformer_tpu_torch.kernels.paged_flash import MASK_GUARD, MASKED
from transformer_tpu_torch.kernels.work import flash_work, priced_call, ring_step_work

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "flash_fwd": [_I] + [_P] * 6 + [_I] * 9 + [_F, _P],
    "flash_ring_step": [_I] + [_P] * 7 + [_I] * 9 + [_F, _P],
    "flash_dq": [_I] + [_P] * 8 + [_I] * 9 + [_F, _P],
    "flash_dkdv": [_I] + [_P] * 9 + [_I] * 9 + [_F, _P],
}
_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64)  # the head widths csrc/flash_attention.cu is built for
TMA_ALIGN = 16  # bytes: a TMA tensor map's base address must be a multiple


def check_args(q, k, v, kv_mask=None, causal=False, window=0) -> None:
    """The JAX function's argument contract."""
    if q.dim() != 4:
        raise ValueError(f"expected (B, S, H, D) inputs, got shape {tuple(q.shape)}")
    b, s_q, h, d = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(
            f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not fit q {tuple(q.shape)}"
        )
    if h % k.shape[2]:
        raise ValueError(f"query heads {h} must be a multiple of kv heads {k.shape[2]}")
    if causal and s_q != k.shape[1]:
        raise ValueError("causal flash attention requires S_q == S_k")
    if window and not causal:
        raise ValueError("window requires causal=True (causal sliding window)")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if kv_mask is not None and tuple(kv_mask.shape) != (b, k.shape[1]):
        raise ValueError(
            f"kv_mask must be (B, S_k) = {(b, k.shape[1])}, got {tuple(kv_mask.shape)}"
        )


# --------------------------------------------------------------------------
# Plain versions


def _grouped(q, k):
    """q (B, S_q, H, D) -> (B, H_kv, G, S_q, D); k (B, S_k, H_kv, D) ->
    (B, H_kv, S_k, D); both fp32 (exact for bf16 values)."""
    b, s_q, h, d = q.shape
    h_kv = k.shape[2]
    qg = q.float().reshape(b, s_q, h_kv, h // h_kv, d).permute(0, 2, 3, 1, 4)
    return qg, k.float().permute(0, 2, 1, 3)


def _scores(q, k, kv_mask, causal, band):
    """Masked fp32 scores (B, H_kv, G, S_q, S_k): ``q·k`` in fp32 times the
    scale, ``MASKED`` where a key is padding, above the diagonal (causal) or
    outside the band."""
    s_q, s_k, d = q.shape[1], k.shape[1], q.shape[3]
    qg, kg = _grouped(q, k)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kg) * d**-0.5
    rows = torch.arange(s_q, device=q.device)[:, None]
    cols = torch.arange(s_k, device=q.device)[None, :]
    allowed = torch.ones((s_q, s_k), dtype=torch.bool, device=q.device)
    if causal:
        allowed = cols <= rows
    if band is not None:
        allowed = allowed & (cols > rows - band)
    allowed = allowed[None, None, None]
    if kv_mask is not None:
        allowed = allowed & kv_mask.bool()[:, None, None, None, :]
    return torch.where(allowed, s, torch.full_like(s, MASKED))


def _exp_guarded(s, shift):
    return torch.where(s > MASK_GUARD, torch.exp(s - shift), torch.zeros_like(s))


def _lse_grouped(lse, h_kv):
    """(B, H, S_q) -> (B, H_kv, G, S_q, 1)."""
    b, h, s_q = lse.shape
    return lse.reshape(b, h_kv, h // h_kv, s_q)[..., None]


def _to_bshd(x, dtype):
    """(B, H_kv, G, S, D) fp32 -> (B, S, H, D) in ``dtype``."""
    b, h_kv, g, s, d = x.shape
    return x.to(dtype).permute(0, 3, 1, 2, 4).reshape(b, s, h_kv * g, d)


def flash_fwd_plain(q, k, v, *, kv_mask=None, causal=False, band=None):
    """Reference for ``flash_fwd``: one fp32 softmax over each whole row
    with the TPU kernel's casts. Returns (out (B, S_q, H, D) in q's dtype,
    lse (B, H, S_q) fp32)."""
    check_args(q, k, v, kv_mask, causal)
    dtype = q.dtype
    s = _scores(q, k, kv_mask, causal, band)
    m = s.amax(dim=-1, keepdim=True)
    p = _exp_guarded(s, m)
    l = p.sum(dim=-1, keepdim=True)
    vg = v.float().permute(0, 2, 1, 3)  # (B, H_kv, S_k, D)
    acc = torch.einsum("bhgqk,bhkd->bhgqd", p.to(dtype).float(), vg)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = _to_bshd(acc / l_safe, dtype)
    lse = (m + torch.log(l_safe))[..., 0]  # (B, H_kv, G, S_q)
    b, s_q = q.shape[:2]
    return out, lse.reshape(b, -1, s_q)


def flash_ring_step_plain(q, k, v, kv_mask, m, l, acc, *, causal=False, band=None):
    """Reference for ``flash_ring_step``: the carry after folding the chunk
    in with one fp32 softmax over the chunk's row, with the TPU kernel's
    casts (``p`` relative to the new running maximum, rounded to q's dtype
    before P·V). Returns new (m, l, acc); the inputs are not modified."""
    check_args(q, k, v, kv_mask, causal)
    _check_carry(q, m, l, acc)
    dtype = q.dtype
    b, s_q, h, d = q.shape
    h_kv = k.shape[2]
    s = _scores(q, k, kv_mask, causal, band)  # (B, H_kv, G, S_q, S_k)
    m_prev = _lse_grouped(m, h_kv)
    m_new = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
    p = _exp_guarded(s, m_new)
    corr = torch.exp(m_prev - m_new)
    l_new = corr * _lse_grouped(l, h_kv) + p.sum(dim=-1, keepdim=True)
    vg = v.float().permute(0, 2, 1, 3)
    acc_g = acc.reshape(b, s_q, h_kv, h // h_kv, d).permute(0, 2, 3, 1, 4)
    acc_new = acc_g * corr + torch.einsum("bhgqk,bhkd->bhgqd", p.to(dtype).float(), vg)
    return (
        m_new[..., 0].reshape(b, h, s_q),
        l_new[..., 0].reshape(b, h, s_q),
        acc_new.permute(0, 3, 1, 2, 4).reshape(b, s_q, h, d),
    )


def _check_carry(q, m, l, acc):
    b, s_q, h, d = q.shape
    shapes = {"m": (b, h, s_q), "l": (b, h, s_q), "acc": (b, s_q, h, d)}
    for (name, shape), t in zip(shapes.items(), (m, l, acc)):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(
                f"carry {name} must be {shape} float32, got {tuple(t.shape)} {t.dtype}"
            )


def _recompute(q, k, v, do, lse, delta, kv_mask, causal, band):
    """P and dS (B, H_kv, G, S_q, S_k) fp32, as both backward kernels
    recompute them: ``p = exp(s - lse)`` guarded, ``dp = dO·Vᵀ`` in fp32,
    ``ds = p·(dp - delta)``."""
    h_kv = k.shape[2]
    s = _scores(q, k, kv_mask, causal, band)
    p = _exp_guarded(s, _lse_grouped(lse, h_kv))
    dog, vg = _grouped(do, v)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, vg)
    ds = p * (dp - _lse_grouped(delta, h_kv))
    return p, ds


def flash_dq_plain(q, k, v, do, lse, delta, *, kv_mask=None, causal=False, band=None):
    """Reference for ``flash_dq``: ``dq = (ds→T)·K · scale``, in q's dtype."""
    check_args(q, k, v, kv_mask, causal)
    dtype = q.dtype
    _, ds = _recompute(q, k, v, do, lse, delta, kv_mask, causal, band)
    kg = k.float().permute(0, 2, 1, 3)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds.to(dtype).float(), kg)
    return _to_bshd(dq * q.shape[3] ** -0.5, dtype)


def flash_dkdv_plain(q, k, v, do, lse, delta, *, kv_mask=None, causal=False, band=None):
    """Reference for ``flash_dkdv``: ``dv = (p→T)ᵀ·dO`` and ``dk =
    ((ds·scale)→T)ᵀ·Q``, summed in fp32 over each kv head's query heads,
    then cast to k's dtype. Returns (dk, dv) shaped like k."""
    check_args(q, k, v, kv_mask, causal)
    dtype = k.dtype
    p, ds = _recompute(q, k, v, do, lse, delta, kv_mask, causal, band)
    qg, _ = _grouped(q, k)
    dog, _ = _grouped(do, k)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p.to(dtype).float(), dog)
    dk = torch.einsum(
        "bhgqk,bhgqd->bhkd", (ds * q.shape[3] ** -0.5).to(dtype).float(), qg
    )
    return dk.to(dtype).permute(0, 2, 1, 3), dv.to(dtype).permute(0, 2, 1, 3)


# --------------------------------------------------------------------------
# Kernel wrappers


def _device_kind(q) -> str:
    """cpu (the plain versions), cuda (the kernels) or meta (a cost trace:
    ``kernels.work.priced_call``)."""
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash attention runs on cpu or cuda, not {q.device}")
    return q.device.type


def _kernel_args(q, k, v, kv_mask, causal, band, extra=()):
    """Validate CUDA inputs for csrc/flash_attention.cu; returns the
    contiguous tensors and the shape ints (the band as a has-band flag and
    its value, so that a band of 0 or less stays a band)."""
    check_args(q, k, v, kv_mask, causal)
    if q.dtype not in _CODES:
        raise ValueError(f"flash attention kernels take float32 or bfloat16, not {q.dtype}")
    b, s_q, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash attention kernels take head_dim in {HEAD_DIMS}, got {d}")
    tensors = [q, k, v, *extra] + ([kv_mask] if kv_mask is not None else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash attention: every tensor must be on q's device")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v dtypes differ: {q.dtype}/{k.dtype}/{v.dtype}")
    mask = None if kv_mask is None else kv_mask.to(torch.uint8).contiguous()
    dims = (b, s_q, k.shape[1], h, k.shape[2], d, int(causal), int(band is not None),
            int(band or 0))
    return q.contiguous(), k.contiguous(), v.contiguous(), mask, dims


def _check_tma_aligned(*tensors) -> None:
    """The bf16 forward, ring step, dQ and dK/dV kernels read q/k/v/dO
    through TMA tensor maps, whose base addresses must be TMA_ALIGN-byte
    aligned."""
    for t in tensors:
        if t.data_ptr() % TMA_ALIGN:
            raise ValueError(
                f"flash attention: bf16 inputs must start on a {TMA_ALIGN}-byte boundary "
                f"(TMA), got address {t.data_ptr():#x}"
            )


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(q):
    return torch.cuda.current_stream(q.device).cuda_stream


def flash_fwd(q, k, v, *, kv_mask=None, causal=False, band=None):
    """(out, lse) of blockwise attention.

    Replaces the TPU kernel ``_fwd_kernel`` (``transformer_tpu/kernels/
    flash_attention.py``). CPU tensors run ``flash_fwd_plain``; CUDA
    tensors launch ``csrc/flash_attention.cu`` ``flash_fwd`` or raise. At
    long4k the work is 2·B·H·S²·D·(1/2 causal) flops against a few tens of
    MB of q/k/v/out, so it is bound by operations: the kernel keeps the
    (64, 64) score tile and the (64, D) accumulator on chip and reads each
    K/V tile once per q tile, skipping tiles above the diagonal or below
    the window.
    """
    kind = _device_kind(q)
    if kind == "cpu":
        return flash_fwd_plain(q, k, v, kv_mask=kv_mask, causal=causal, band=band)
    if kind == "meta":
        b, s_q, h, _ = q.shape
        return priced_call("flash_fwd", flash_work("flash_fwd", q, k, kv_mask, causal, band),
                           lambda: (torch.empty_like(q), torch.empty(
                               (b, h, s_q), dtype=torch.float32, device=q.device)))
    from transformer_tpu_torch.kernels import build

    q, k, v, mask, dims = _kernel_args(q, k, v, kv_mask, causal, band)
    if q.dtype == torch.bfloat16:
        _check_tma_aligned(q, k, v)
    b, s_q, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    lib = build.load("flash_attention", _SIGNATURES)
    status = lib.flash_fwd(
        _CODES[q.dtype], _ptr(q), _ptr(k), _ptr(v), _ptr(mask), _ptr(out), _ptr(lse),
        *dims, d**-0.5, _stream(q),
    )
    build.check(status, "flash_fwd")
    flash_fwd.launches += 1
    flash_fwd.heads += q.shape[2]
    return out, lse


def flash_ring_step(q, k, v, kv_mask, m, l, acc, *, causal=False, band=None):
    """Fold the KV chunk ``k``/``v`` into the carry ``(m, l, acc)`` in place
    and return it: one hop of ring attention.

    Replaces the TPU kernel ``_ring_step_kernel``. ``causal`` means "this is
    the diagonal chunk pair" and ``band`` is the hop's band, both in the
    chunks' local coordinates. CPU tensors run ``flash_ring_step_plain`` and
    copy its result into the carry; CUDA tensors launch
    ``csrc/flash_attention.cu`` ``flash_ring_step`` or raise. The kernel is
    ``flash_fwd``'s kernel with its carry flag set: the carry's 64 rows are
    read from device memory before the k-tile loop and written back after
    it by the CTA that owns them, so the in-place update needs no atomics.
    bf16 runs on the tensor cores (``wgmma``, K/V tiles fed by TMA, so q, k
    and v must start on 16-byte boundaries), with ``m`` taken to log2 units
    and back and the sentinel ``MASKED`` kept exactly; fp32 on the CUDA
    cores. At C 1024 a hop moves the fp32 carry (read and written) beside
    q/k/v, so it sits near the bytes/operations ridge.
    """
    kind = _device_kind(q)
    if kind == "cpu":
        new = flash_ring_step_plain(q, k, v, kv_mask, m, l, acc, causal=causal, band=band)
        for dst, src in zip((m, l, acc), new):
            dst.copy_(src)
        return m, l, acc
    if kind == "meta":
        work = ring_step_work(q, k, kv_mask, (m, l, acc), causal, band)
        return priced_call("flash_ring_step", work, lambda: (m, l, acc))
    from transformer_tpu_torch.kernels import build

    _check_carry(q, m, l, acc)
    if not all(t.is_contiguous() and t.device == q.device for t in (m, l, acc)):
        raise ValueError(
            "the ring carry is updated in place: m, l, acc must be contiguous on q's device"
        )
    q, k, v, mask, dims = _kernel_args(q, k, v, kv_mask, causal, band)
    if q.dtype == torch.bfloat16:
        _check_tma_aligned(q, k, v)
        if acc.data_ptr() % 8:
            raise ValueError("the bf16 ring step stores acc in 8-byte pairs: acc must be "
                             f"8-byte aligned, got address {acc.data_ptr():#x}")
    lib = build.load("flash_attention", _SIGNATURES)
    status = lib.flash_ring_step(
        _CODES[q.dtype], _ptr(q), _ptr(k), _ptr(v), _ptr(mask), _ptr(m), _ptr(l), _ptr(acc),
        *dims, q.shape[3] ** -0.5, _stream(q),
    )
    build.check(status, "flash_ring_step")
    flash_ring_step.launches += 1
    flash_ring_step.heads += q.shape[2]
    return m, l, acc


def _bwd_extra(q, do, lse, delta):
    b, s_q, h, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"dO must match q: {tuple(do.shape)} {do.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (b, h, s_q) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be (B, H, S_q) float32, got {tuple(t.shape)} {t.dtype}")
    return do.contiguous(), lse.contiguous(), delta.contiguous()


def flash_dq(q, k, v, do, lse, delta, *, kv_mask=None, causal=False, band=None):
    """dQ of blockwise attention, in q's dtype.

    Replaces the TPU kernel ``_dq_kernel``. CPU tensors run
    ``flash_dq_plain``; CUDA tensors launch ``flash_dq`` or raise. Bound by
    operations (three half-matmuls at causal): one CTA per (batch·head,
    q tile) walks the visible K/V tiles, recomputes P from ``lse`` and
    accumulates dQ in registers, so dQ is written once, with no atomics.
    bf16 runs the three products on the tensor cores (``wgmma``, K/V tiles
    fed by TMA), fp32 on the CUDA cores.
    """
    kind = _device_kind(q)
    if kind == "cpu":
        return flash_dq_plain(q, k, v, do, lse, delta, kv_mask=kv_mask, causal=causal, band=band)
    if kind == "meta":
        return priced_call("flash_dq", flash_work("flash_dq", q, k, kv_mask, causal, band),
                           lambda: torch.empty_like(q))
    from transformer_tpu_torch.kernels import build

    do, lse, delta = _bwd_extra(q, do, lse, delta)
    q, k, v, mask, dims = _kernel_args(q, k, v, kv_mask, causal, band, (do, lse, delta))
    if q.dtype == torch.bfloat16:
        _check_tma_aligned(q, k, v, do)
    dq = torch.empty_like(q)
    lib = build.load("flash_attention", _SIGNATURES)
    status = lib.flash_dq(
        _CODES[q.dtype], _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta),
        _ptr(mask), _ptr(dq), *dims, q.shape[3] ** -0.5, _stream(q),
    )
    build.check(status, "flash_dq")
    flash_dq.launches += 1
    flash_dq.heads += q.shape[2]
    return dq


def flash_dkdv(q, k, v, do, lse, delta, *, kv_mask=None, causal=False, band=None):
    """(dK, dV) of blockwise attention, shaped and typed like k.

    Replaces the TPU kernel ``_dkdv_kernel``. CPU tensors run
    ``flash_dkdv_plain``; CUDA tensors launch ``flash_dkdv`` or raise.
    Bound by operations (four half-matmuls at causal): one CTA per
    (batch·kv head, k tile) walks (group member, visible q tile) pairs and
    accumulates dK and dV in registers, so the GQA group sums with no write
    race and no atomics. bf16 runs the four products on the tensor cores
    (``wgmma``, Q/dO tiles fed by TMA), fp32 on the CUDA cores.
    """
    kind = _device_kind(q)
    if kind == "cpu":
        return flash_dkdv_plain(
            q, k, v, do, lse, delta, kv_mask=kv_mask, causal=causal, band=band
        )
    if kind == "meta":
        return priced_call("flash_dkdv", flash_work("flash_dkdv", q, k, kv_mask, causal, band),
                           lambda: (torch.empty_like(k), torch.empty_like(v)))
    from transformer_tpu_torch.kernels import build

    do, lse, delta = _bwd_extra(q, do, lse, delta)
    q, k, v, mask, dims = _kernel_args(q, k, v, kv_mask, causal, band, (do, lse, delta))
    if q.dtype == torch.bfloat16:
        _check_tma_aligned(q, k, v, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = build.load("flash_attention", _SIGNATURES)
    status = lib.flash_dkdv(
        _CODES[q.dtype], _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta),
        _ptr(mask), _ptr(dk), _ptr(dv), *dims, q.shape[3] ** -0.5, _stream(q),
    )
    build.check(status, "flash_dkdv")
    flash_dkdv.launches += 1
    flash_dkdv.heads += q.shape[2]
    return dk, dv


def flash_chunk_bwd(q, k, v, kv_mask, lse, delta, do, *, causal=False, band=None,
                    reference=False):
    """(dq, dk, dv) for one (q, KV chunk) pair from the GLOBAL per-row
    ``lse`` and ``delta``, in the inputs' dtypes: ``flash_dq`` then
    ``flash_dkdv`` (their plain versions with ``reference``). Ring
    attention calls it once per hop and sums; the sum is exact because P
    recomputed from the global lse is the true probability tile."""
    kw = dict(kv_mask=kv_mask, causal=causal, band=band)
    dq = (flash_dq_plain if reference else flash_dq)(q, k, v, do, lse, delta, **kw)
    dk, dv = (flash_dkdv_plain if reference else flash_dkdv)(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


# Kernel launches since the last reset (the plain versions do not count),
# and the query heads those launches ran over, summed.
flash_fwd.launches = 0
flash_ring_step.launches = 0
flash_dq.launches = 0
flash_dkdv.launches = 0
flash_fwd.heads = 0
flash_ring_step.heads = 0
flash_dq.heads = 0
flash_dkdv.heads = 0


# --------------------------------------------------------------------------
# Autograd


class _FlashAttention(torch.autograd.Function):
    """forward: (out, lse); backward: delta = rowsum(dO·O) in fp32, then dQ,
    then dK/dV. ``reference`` runs the plain versions on any device."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, band, reference):
        fwd = flash_fwd_plain if reference else flash_fwd
        out, lse = fwd(q, k, v, kv_mask=kv_mask, causal=causal, band=band)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.causal, ctx.band, ctx.reference = causal, band, reference
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, d_out, _d_lse):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        delta = (d_out.float() * out.float()).sum(dim=-1).permute(0, 2, 1).contiguous()
        kw = dict(kv_mask=kv_mask, causal=ctx.causal, band=ctx.band)
        d_out = d_out.to(q.dtype)
        if ctx.reference:
            dq = flash_dq_plain(q, k, v, d_out, lse, delta, **kw)
            dk, dv = flash_dkdv_plain(q, k, v, d_out, lse, delta, **kw)
        else:
            dq = flash_dq(q, k, v, d_out, lse, delta, **kw)
            dk, dv = flash_dkdv(q, k, v, d_out, lse, delta, **kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kv_mask: torch.Tensor | None = None,
    causal: bool = False,
    window: int = 0,
    reference: bool = False,
) -> torch.Tensor:
    """Blockwise attention over (B, S, H, D) activations; differentiable.

    k/v may carry fewer heads (B, S_k, H_kv, D); ``kv_mask`` (B, S_k) is
    True for a real key; ``causal`` is structural (S_q == S_k); ``window``
    bounds each row to its last ``window`` keys and needs ``causal``; S_q
    may differ from S_k when not causal. Returns (B, S_q, H, D) in q's
    dtype. On CUDA tensors the three kernels run (or the call raises); on
    CPU tensors, their plain versions. ``reference=True`` runs the plain
    versions on any device (the kernels' yardstick on the card).
    """
    check_args(q, k, v, kv_mask, causal, window)
    _device_kind(q)
    band = int(window) if window else None
    out, _ = _FlashAttention.apply(q, k, v, kv_mask, causal, band, reference)
    return out
