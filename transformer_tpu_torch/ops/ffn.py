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
from transformer_tpu_torch.ops.nn import Params, dense_apply, layernorm_apply


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
    if is_gated(activation):
        act = _GATED_ACTIVATIONS[activation]
        h = act(dense_apply(params["gate"], x)) * dense_apply(params["in"], x)
        return dense_apply(params["out"], h)
    h = _ACTIVATIONS[activation](dense_apply(params["in"], x))
    return dense_apply(params["out"], h)


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
_SIGNATURES = {
    "fused_ln_ffn_tile_cols": [],
    "fused_ln_ffn_tile_rows": [],
    "fused_ln_ffn": [_I] + [_P] * 12 + [_I] * 5 + [_F, _P],
}


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
    tensor it launches ``csrc/fused_ln_ffn.cu`` or raises. At decode M is
    ``slots * S_q`` rows, so the kernel is bound by reading the weights once
    (2 * 512 * 2048 * 2 B = 4.2 MB a layer at long4k in bf16): its grid
    splits dff into 32-column tiles so every weight byte is read by one CTA,
    and the (M, dff) intermediate stays in shared memory.
    """
    if x.device.type == "cpu":
        return fused_ln_ffn_plain(
            ln_params, ffn_params, x, activation=activation,
            norm_scheme=norm_scheme, epsilon=epsilon,
        )
    if x.device.type != "cuda":
        raise ValueError(f"fused_ln_ffn runs on cpu or cuda, not {x.device}")
    _check_args(norm_scheme, activation)
    from transformer_tpu_torch.kernels import build

    dtype = x.dtype
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise ValueError(f"fused_ln_ffn kernel takes float32 or bfloat16, not {dtype}")
    lead, d = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, d).contiguous()
    m = xf.shape[0]
    dff = ffn_params["in"]["kernel"].shape[1]
    lib = build.load("fused_ln_ffn", _SIGNATURES)
    cols, rows = lib.fused_ln_ffn_tile_cols(), lib.fused_ln_ffn_tile_rows()
    if dff % cols:
        raise ValueError(f"fused_ln_ffn kernel needs dff % {cols} == 0, got {dff}")

    def cast(t):
        return t.to(dtype).contiguous()

    gated = is_gated(activation)
    w_in, b_in = cast(ffn_params["in"]["kernel"]), cast(ffn_params["in"]["bias"])
    w_out, b_out = cast(ffn_params["out"]["kernel"]), cast(ffn_params["out"]["bias"])
    w_gate = cast(ffn_params["gate"]["kernel"]) if gated else None
    b_gate = cast(ffn_params["gate"]["bias"]) if gated else None
    ln_scale, ln_bias = cast(ln_params["scale"]), cast(ln_params["bias"])
    if w_in.shape != (d, dff) or w_out.shape != (dff, d):
        raise ValueError(
            f"fused_ln_ffn weight shapes {tuple(w_in.shape)}/{tuple(w_out.shape)} "
            f"do not fit d={d}, dff={dff}"
        )
    tensors = [xf, w_in, b_in, w_out, b_out, ln_scale, ln_bias]
    if any(t.device != x.device for t in tensors):
        raise ValueError("fused_ln_ffn: every tensor must be on x's device")
    out = torch.empty_like(xf)
    partial = torch.empty((dff // cols, m, d), dtype=torch.float32, device=x.device)
    tickets = torch.zeros((-(-m // rows),), dtype=torch.int32, device=x.device)
    status = lib.fused_ln_ffn(
        codes[dtype], _ptr(xf), _ptr(w_in), _ptr(b_in),
        _ptr(w_gate), _ptr(b_gate), _ptr(w_out), _ptr(b_out),
        _ptr(ln_scale), _ptr(ln_bias), _ptr(out), _ptr(partial), _ptr(tickets),
        m, d, dff, _ACT_CODE[activation], int(norm_scheme == "pre"), epsilon,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(status, "fused_ln_ffn")
    fused_ln_ffn.launches += 1
    return out.reshape(*lead, d)


# Kernel launches since the last reset (the plain path does not count).
fused_ln_ffn.launches = 0
