"""Sinusoidal positional encoding and rotary embeddings.

Layout matches the JAX twin (``transformer_tpu/ops/positional.py``): the
first d_model/2 channels carry sin of the even-channel angles and the last
d_model/2 carry cos of the odd-channel angles, concatenated block-wise,
not interleaved. Constants are filled on the device, never copied from a
host scalar, so a CUDA graph can capture the functions.
"""

from __future__ import annotations

import torch


def _angle_rates(d_model: int, device) -> torch.Tensor:
    channels = torch.arange(d_model, dtype=torch.float32, device=device)[None, :]
    return torch.pow(
        torch.full((), 10000.0, dtype=torch.float32, device=device),
        -(2.0 * torch.floor(channels / 2.0)) / d_model,
    )


def sinusoidal_rows(
    positions: torch.Tensor, d_model: int, dtype=torch.float32
) -> torch.Tensor:
    """Rows of the sinusoidal table at ``positions`` (any shape) ->
    ``(*positions.shape, d_model)``: the same elementwise formula as the
    full table, evaluated only where needed."""
    angles = positions.to(torch.float32)[..., None] * _angle_rates(
        d_model, positions.device
    ).reshape(-1)
    table = torch.cat(
        [torch.sin(angles[..., 0::2]), torch.cos(angles[..., 1::2])], dim=-1
    )
    return table.to(dtype)


def sinusoidal_positional_encoding(
    max_position: int, d_model: int, dtype=torch.float32, device="cpu"
) -> torch.Tensor:
    """(max_position, d_model) table: [sin(even angles)] ++ [cos(odd angles)]."""
    positions = torch.arange(max_position, dtype=torch.float32, device=device)
    return sinusoidal_rows(positions, d_model, dtype)


def apply_rope(
    x: torch.Tensor, positions: torch.Tensor, base: float = 10000.0
) -> torch.Tensor:
    """Rotary embedding of ``x`` (B, S, H, D) at absolute ``positions``:
    (S,) shared by the batch, or (B, S) per row. Half-split layout (channel
    i pairs with channel i + D/2); angles in fp32; output in x.dtype."""
    head_dim = x.shape[-1]
    half = head_dim // 2
    inv_freq = torch.pow(
        torch.full((), base, dtype=torch.float32, device=x.device),
        -torch.arange(0, half, dtype=torch.float32, device=x.device) / half,
    )
    angles = positions.to(torch.float32)[..., None] * inv_freq  # (.., S, D/2)
    if angles.dim() == 2:
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]  # (1|B, S, 1, D/2)
    sin = torch.sin(angles)[:, :, None, :]
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)
