"""Primitive building blocks: dense, embedding, layernorm.

Functions over plain parameter dicts in the JAX package's layouts
(``kernel`` is ``(d_in, d_out)``). Parameters stay in their stored dtype;
compute casts to the caller's dtype exactly where the JAX twin does.
"""

from __future__ import annotations

import torch

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
