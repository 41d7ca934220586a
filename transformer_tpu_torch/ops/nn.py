"""Primitive building blocks: dense, embedding, layernorm, dropout, remat.

Functions over plain parameter dicts in the JAX package's layouts
(``kernel`` is ``(d_in, d_out)``). Parameters stay in their stored dtype;
compute casts to the caller's dtype exactly where the JAX twin does.
"""

from __future__ import annotations

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


def dropout(
    generator: torch.Generator | None, x: torch.Tensor, rate: float, deterministic: bool
) -> torch.Tensor:
    """Inverted dropout with masks drawn from ``generator``;
    ``deterministic`` (eval) or ``rate == 0`` is the identity."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training mode requires a generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def remat_layer(fn, cfg):
    """``fn`` under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are recomputed in the backward instead of kept. Policy
    "full" only; "dots" (keep matmul outputs) is not ported. Dropout inside
    ``fn`` must come from generators seeded per call (``dropout_generator``),
    since the global RNG state is not replayed."""
    if cfg.remat_policy != "full":
        raise NotImplementedError(
            f"remat_policy={cfg.remat_policy!r} is not ported; the port rematerializes "
            "with policy 'full'"
        )

    def checkpointed(*args, **kwargs):
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False, **kwargs
        )

    return checkpointed
