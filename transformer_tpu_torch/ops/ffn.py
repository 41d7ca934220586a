"""Position-wise feed-forward network, and the fused FFN-sublayer kernel.

``ffn_apply`` is the plain two- (or three-, gated) matmul FFN of the JAX
twin (``transformer_tpu/ops/ffn.py``). ``fused_ln_ffn`` is the decode
path's whole FFN sublayer (residual, LayerNorm, both matmuls) as one
hand-written CUDA kernel (``csrc/fused_ln_ffn.cu``), with
``fused_ln_ffn_plain`` beside it: the same computation in torch ops with
the same dtype casts in the same places, used for CPU tensors and as the
kernel's reference on the card.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from transformer_tpu_torch.config import is_gated
from transformer_tpu_torch.kernels.work import fused_ln_ffn_work, priced_call
from transformer_tpu_torch.ops.nn import Params, dense_apply, layernorm_apply
from transformer_tpu_torch.parallel import collectives as _collectives


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation.
    return F.gelu(x, approximate="tanh")


_ACTIVATIONS = {"relu": torch.relu, "gelu": _gelu, "silu": F.silu}
# Gated variants: activation applied to the GATE branch.
_GATED_ACTIVATIONS = {"swiglu": F.silu, "geglu": _gelu, "reglu": torch.relu}
# The CUDA kernel's activation codes (csrc/fused_ln_ffn.cu ``Act``).
_ACT_CODE = {
    "relu": 0, "reglu": 0, "gelu": 1, "geglu": 1, "silu": 2, "swiglu": 2,
}


def ffn_apply(params: Params, x: torch.Tensor, activation: str = "relu") -> torch.Tensor:
    """The FFN. Inside ``parallel.collectives.model_parallel`` with dff
    split over ``model``, ``in``/``gate`` are this rank's columns and it
    reads its rows of ``out`` (whole, by the partition rules): the partial
    products are summed over the model group before ``out/bias``."""
    tp = _collectives.current()
    split = tp is not None and tp.ffn
    if split:
        x = _collectives.copy_to_model(x)
    if is_gated(activation):
        act = _GATED_ACTIVATIONS[activation]
        h = act(dense_apply(params["gate"], x)) * dense_apply(params["in"], x)
    else:
        h = _ACTIVATIONS[activation](dense_apply(params["in"], x))
    return _out_apply(params["out"], h, tp if split else None)


def _out_apply(p: Params, h: torch.Tensor, tp=None) -> torch.Tensor:
    """``out`` over ``h``; with ``tp`` (dff split over ``model``) this
    rank's rows of the kernel, the partial products summed over the model
    group before the replicated bias."""
    kernel = p["kernel"]
    if tp is not None and kernel.shape[0] != h.shape[-1]:  # a whole kernel: its rows
        kernel = kernel.narrow(0, tp.model_rank * h.shape[-1], h.shape[-1])
    y = torch.matmul(h, kernel.to(h.dtype))
    if tp is not None:
        y = _collectives.reduce_from_model(y)
    return y + p["bias"].to(h.dtype)


def _check_args(norm_scheme: str, activation: str) -> None:
    if norm_scheme not in ("pre", "post"):
        raise ValueError(f"unknown norm_scheme {norm_scheme!r}")
    if activation not in _ACT_CODE:
        raise ValueError(f"unknown activation {activation!r}")


def fused_ln_ffn_plain(
    ln_params: Params,
    ffn_params: Params,
    x: torch.Tensor,
    *,
    activation: str = "relu",
    norm_scheme: str = "pre",
    epsilon: float = 1e-6,
) -> torch.Tensor:
    """The reference for ``fused_ln_ffn``: ``x + ffn(LN(x))`` (pre-LN) or
    ``LN(x + ffn(x))`` (post-LN), with the TPU kernel's casts — LN
    parameters cast to the compute dtype, both matmuls accumulated in fp32
    over compute-dtype operands and rounded to the compute dtype before
    their bias."""
    _check_args(norm_scheme, activation)
    dtype = x.dtype
    ln = {k: ln_params[k].to(dtype) for k in ("scale", "bias")}

    def dense(p, h):
        z = torch.matmul(h.float(), p["kernel"].to(dtype).float())
        return z.to(dtype) + p["bias"].to(dtype)

    h = layernorm_apply(ln, x, epsilon) if norm_scheme == "pre" else x
    if is_gated(activation):
        t = _GATED_ACTIVATIONS[activation](dense(ffn_params["gate"], h)) * dense(
            ffn_params["in"], h
        )
    else:
        t = _ACTIVATIONS[activation](dense(ffn_params["in"], h))
    y = dense(ffn_params["out"], t)
    res = x + y
    return res if norm_scheme == "pre" else layernorm_apply(ln, res, epsilon)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"fused_ln_ffn": [_I] + [_P] * 12 + [_I] * 5 + [_F, _P]}
_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The kernel's tiling (csrc/fused_ln_ffn.cu): each CTA owns a 32-byte slab
# of dff (16 bf16 or 8 fp32 columns) and 8 rows, CTAs come in clusters of
# 8, the first product splits d into 64 k-segments.
SLAB_BYTES = 32
CLUSTER = 8
ROW_CHUNK = 8
MAX_ROWS = 256
MAX_D = 1024
D_MULTIPLE = 64
CP_ASYNC_ALIGN = 16  # bytes: x and the weights are copied to shared memory 16 at a time


def slab_cols(dtype: torch.dtype) -> int:
    """dff columns one CTA owns."""
    return SLAB_BYTES // torch.empty((), dtype=dtype).element_size()


def check_kernel_args(
    ln_params: Params, ffn_params: Params, x: torch.Tensor, activation: str
) -> None:
    """Refuse what the CUDA kernel cannot take, before anything is built or
    launched: the dtype, the row count M (x's leading axes folded), d and
    dff against the tiling, the weight shapes, the gate weights (present
    exactly for a gated activation), devices, and the 16-byte alignment of
    x's and each weight's start (their copies into shared memory are 16
    bytes)."""
    if x.dtype not in _CODES:
        raise ValueError(f"fused_ln_ffn kernel takes float32 or bfloat16, not {x.dtype}")
    d = x.shape[-1]
    m = x.numel() // max(d, 1)
    if not 1 <= m <= MAX_ROWS:
        raise ValueError(f"fused_ln_ffn kernel takes 1 to {MAX_ROWS} rows, got {m}")
    if d % D_MULTIPLE or not D_MULTIPLE <= d <= MAX_D:
        raise ValueError(
            f"fused_ln_ffn kernel needs d_model a multiple of {D_MULTIPLE} in "
            f"[{D_MULTIPLE}, {MAX_D}], got {d}"
        )
    dff = ffn_params["in"]["kernel"].shape[-1]
    cols = slab_cols(x.dtype)
    if dff % (cols * CLUSTER):
        raise ValueError(
            f"fused_ln_ffn kernel needs dff % {cols * CLUSTER} == 0 in {x.dtype} "
            f"({cols}-column slabs in clusters of {CLUSTER}), got {dff}"
        )
    gated = is_gated(activation)
    if gated != ("gate" in ffn_params):
        raise ValueError(
            f"fused_ln_ffn: activation {activation!r} "
            + ("needs gate weights" if gated else "takes no gate weights")
        )
    want = {"in": ((d, dff), (dff,)), "out": ((dff, d), (d,))}
    if gated:
        want["gate"] = want["in"]
    if x.data_ptr() % CP_ASYNC_ALIGN:
        raise ValueError(
            f"fused_ln_ffn: x must start on a {CP_ASYNC_ALIGN}-byte boundary, "
            f"got address {x.data_ptr():#x}"
        )
    tensors = [x, ln_params["scale"], ln_params["bias"]]
    for name, (w_shape, b_shape) in want.items():
        w, b = ffn_params[name]["kernel"], ffn_params[name]["bias"]
        if tuple(w.shape) != w_shape or tuple(b.shape) != b_shape:
            raise ValueError(
                f"fused_ln_ffn {name} weights {tuple(w.shape)}/{tuple(b.shape)} do not "
                f"fit d={d}, dff={dff}"
            )
        if w.data_ptr() % CP_ASYNC_ALIGN:
            raise ValueError(
                f"fused_ln_ffn: the {name} kernel must start on a {CP_ASYNC_ALIGN}-byte "
                f"boundary, got address {w.data_ptr():#x}"
            )
        tensors += [w, b]
    if any(t.device != x.device for t in tensors):
        raise ValueError("fused_ln_ffn: every tensor must be on x's device")


# Scratch of the kernel, kept per device across calls: the cluster partials
# and one last-cluster ticket per row chunk, zeroed once here and left at
# zero by every launch. The partials are sized for MAX_ROWS rows at first
# use (grown only for a wider d or dff), so calls of every row count share
# one buffer and a CUDA graph that captured it never sees it freed. Calls
# on one device share it, so they must run in order on one stream, as the
# decode step's do.
_WORKSPACE: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device: torch.device, floats: int) -> tuple[torch.Tensor, torch.Tensor]:
    partial, tickets = _WORKSPACE.get(device, (None, None))
    if tickets is None:
        tickets = torch.zeros((MAX_ROWS // ROW_CHUNK,), dtype=torch.int32, device=device)
    if partial is None or partial.numel() < floats:
        partial = torch.empty((floats,), dtype=torch.float32, device=device)
    _WORKSPACE[device] = (partial, tickets)
    return partial, tickets


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def fused_ln_ffn(
    ln_params: Params,
    ffn_params: Params,
    x: torch.Tensor,
    *,
    activation: str = "relu",
    norm_scheme: str = "pre",
    epsilon: float = 1e-6,
) -> torch.Tensor:
    """The whole FFN sublayer as one kernel; ``x`` is (..., d_model).

    Replaces the TPU kernel ``_fused_kernel`` (``transformer_tpu/ops/
    ffn.py``). On a CPU tensor this runs ``fused_ln_ffn_plain``; on a CUDA
    tensor it launches ``csrc/fused_ln_ffn.cu`` or raises; on a ``meta``
    tensor (a cost trace) it is priced by ``kernels.work``. At decode M is
    ``slots * S_q`` rows, so the kernel is bound by reading the weights once
    (2 * 512 * 2048 * 2 B = 4.2 MB a layer at long4k in bf16): one CTA per
    32-byte slab of dff and 8 rows streams its W_in columns and W_out rows
    with 16-byte copies, the slabs' contributions are summed in thread
    block clusters of 8 through distributed shared memory, and the last
    cluster of a row chunk adds the clusters' partials and applies the
    residual and LayerNorm, one row per CTA.
    """
    if x.device.type == "cpu":
        return fused_ln_ffn_plain(
            ln_params, ffn_params, x, activation=activation,
            norm_scheme=norm_scheme, epsilon=epsilon,
        )
    if x.device.type == "meta":
        _check_args(norm_scheme, activation)
        work = fused_ln_ffn_work(x, ffn_params["in"]["kernel"].shape[1], is_gated(activation))
        return priced_call("fused_ln_ffn", work, lambda: torch.empty_like(x))
    if x.device.type != "cuda":
        raise ValueError(f"fused_ln_ffn runs on cpu or cuda, not {x.device}")
    _check_args(norm_scheme, activation)
    dtype = x.dtype

    def cast(t):
        return t.to(dtype).contiguous()

    gated = is_gated(activation)
    ffn = {name: {k: cast(v) for k, v in ffn_params[name].items()}
           for name in ("in", "out", "gate") if name in ffn_params}
    ln = {k: cast(ln_params[k]) for k in ("scale", "bias")}
    lead, d = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, d).contiguous()
    if xf.data_ptr() % CP_ASYNC_ALIGN:
        xf = xf.clone()  # a view into a buffer: a fresh allocation is aligned
    check_kernel_args(ln, ffn, xf, activation)
    from transformer_tpu_torch.kernels import build

    m, dff = xf.shape[0], ffn["in"]["kernel"].shape[1]
    lib = build.load("fused_ln_ffn", _SIGNATURES)
    out = torch.empty_like(xf)
    partial, tickets = _workspace(x.device, dff // (slab_cols(dtype) * CLUSTER) * MAX_ROWS * d)
    gate = ffn["gate"] if gated else {"kernel": None, "bias": None}
    status = lib.fused_ln_ffn(
        _CODES[dtype], _ptr(xf), _ptr(ffn["in"]["kernel"]), _ptr(ffn["in"]["bias"]),
        _ptr(gate["kernel"]), _ptr(gate["bias"]), _ptr(ffn["out"]["kernel"]),
        _ptr(ffn["out"]["bias"]), _ptr(ln["scale"]), _ptr(ln["bias"]), _ptr(out),
        _ptr(partial), _ptr(tickets), m, d, dff, _ACT_CODE[activation],
        int(norm_scheme == "pre"), epsilon, torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(status, "fused_ln_ffn")
    fused_ln_ffn.launches += 1
    return out.reshape(*lead, d)


# Kernel launches since the last reset (the plain path does not count).
fused_ln_ffn.launches = 0
