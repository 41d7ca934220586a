"""Primitive building blocks: dense, embedding, layernorm, dropout, remat.

Functions over plain parameter dicts in the JAX package's layouts
(``kernel`` is ``(d_in, d_out)``). Parameters stay in their stored dtype;
compute casts to the caller's dtype exactly where the JAX twin does.
"""

from __future__ import annotations

import contextvars
import dataclasses

import numpy as np
import torch
import torch.utils.checkpoint

Params = dict


def dense_apply(params: Params, x: torch.Tensor, dtype=None) -> torch.Tensor:
    dtype = dtype or x.dtype
    kernel = params["kernel"].to(dtype)
    bias = params["bias"].to(dtype)
    return torch.matmul(x.to(dtype), kernel) + bias


def embedding_lookup(
    params: Params, ids: torch.Tensor, dtype=torch.bfloat16
) -> torch.Tensor:
    return params["table"].to(dtype)[ids]


def embedding_attend(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied output projection: logits = x @ table.T."""
    return torch.matmul(x, params["table"].to(x.dtype).T)


def layernorm_apply(
    params: Params, x: torch.Tensor, epsilon: float = 1e-6
) -> torch.Tensor:
    """LayerNorm with fp32 statistics whatever the compute dtype, then the
    affine in fp32, then a cast back."""
    orig_dtype = x.dtype
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.square(x32 - mean).mean(dim=-1, keepdim=True)
    normed = (x32 - mean) * torch.rsqrt(var + epsilon)
    out = normed * params["scale"].float() + params["bias"].float()
    return out.to(orig_dtype)


def dropout_generator(key: tuple[int, ...], device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from an integer key, e.g.
    (seed, step, layer, site). A layer that seeds its dropout this way
    draws the same masks each time it runs, so the recompute of a
    checkpointed layer sees the forward's masks."""
    seed = int(np.random.SeedSequence(list(key)).generate_state(1, np.uint64)[0]) >> 1
    return torch.Generator(device=device).manual_seed(seed)


@dataclasses.dataclass(frozen=True)
class GlobalSlice:
    """Where this process's (b, s, ...) activation sits in the global one
    of a data × sequence split: the global, unpadded batch and length, and
    the global index of its first row and first position. Positions past
    ``length`` are the sequence split's padding."""

    batch: int
    length: int
    row: int
    col: int


def dropout(
    generator: torch.Generator | None,
    x: torch.Tensor,
    rate: float,
    deterministic: bool,
    region: GlobalSlice | None = None,
) -> torch.Tensor:
    """Inverted dropout with masks drawn from ``generator``;
    ``deterministic`` (eval) or ``rate == 0`` is the identity. With a
    ``region``, the mask is drawn for the whole global (batch, length, ...)
    tensor and this process keeps its own rows and positions, so a split
    run draws exactly the masks of the unsplit one (``torch.rand`` fills in
    row-major order, so a draw over another shape would put other values
    at the same indices); padding positions past ``length`` keep their
    values, which nothing reads."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training mode requires a generator")
    keep = 1.0 - rate
    if region is None:
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    else:
        full = torch.rand(
            (region.batch, region.length) + tuple(x.shape[2:]), generator=generator,
            device=x.device,
        )
        part = full[region.row : region.row + x.shape[0], region.col : region.col + x.shape[1]]
        mask = torch.ones(x.shape, dtype=torch.bool, device=x.device)
        mask[:, : part.shape[1]] = part < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def remat_layer(fn, cfg):
    """``fn`` under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are recomputed in the backward instead of kept. Policy
    "full" only; "dots" (keep matmul outputs) is not ported. Dropout inside
    ``fn`` must come from generators seeded per call (``dropout_generator``),
    since the global RNG state is not replayed. The recompute runs in a
    copy of the context variables of the forward call (the
    sequence-parallel context among them), since the backward runs outside
    the ``with`` blocks that set them."""
    if cfg.remat_policy != "full":
        raise NotImplementedError(
            f"remat_policy={cfg.remat_policy!r} is not ported; the port rematerializes "
            "with policy 'full'"
        )

    def checkpointed(*args, **kwargs):
        ctx = contextvars.copy_context()
        return torch.utils.checkpoint.checkpoint(
            lambda *a, **k: ctx.run(fn, *a, **k), *args, use_reentrant=False,
            preserve_rng_state=False, **kwargs,
        )

    return checkpointed
