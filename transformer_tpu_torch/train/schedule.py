"""Learning-rate schedules, twins of ``transformer_tpu/train/schedule.py``.

Each returns ``f(step) -> lr`` (a Python float holding the fp32 value the
JAX schedule computes). ``step`` counts optimizer updates from 0, as optax
passes it; ``noam_schedule`` adds 1 inside.
"""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.tensor(float(step), dtype=torch.float32)


def noam_schedule(d_model: int, warmup_steps: int = 60000):
    """``d_model^-0.5 · min(s^-0.5, s · warmup^-1.5)`` at ``s = step + 1``."""
    scale = float(d_model) ** -0.5
    warmup = float(warmup_steps) ** -1.5

    def schedule(step) -> float:
        s = _f32(step) + 1.0
        return float(scale * torch.minimum(s**-0.5, s * warmup))

    return schedule


def cosine_schedule(peak_lr: float, warmup_steps: int, decay_steps: int, floor_ratio: float = 0.1):
    """Linear warmup to ``peak_lr``, then a half cosine down to
    ``peak_lr · floor_ratio`` at ``decay_steps`` (flat after)."""
    if decay_steps <= warmup_steps:
        raise ValueError(
            f"decay_steps ({decay_steps}) must exceed warmup_steps ({warmup_steps})"
        )
    floor = peak_lr * floor_ratio

    def schedule(step) -> float:
        s = _f32(step)
        warm = peak_lr * (s + 1.0) / max(warmup_steps, 1)
        frac = torch.clamp((s - warmup_steps) / (decay_steps - warmup_steps), 0.0, 1.0)
        cos = floor + (peak_lr - floor) * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return float(torch.where(s < warmup_steps, warm, cos))

    return schedule


def constant_schedule(peak_lr: float, warmup_steps: int):
    """Linear warmup to ``peak_lr``, then flat."""

    def schedule(step) -> float:
        s = _f32(step)
        warm = peak_lr * (s + 1.0) / max(warmup_steps, 1)
        return float(torch.where(s < warmup_steps, warm, torch.tensor(peak_lr)))

    return schedule
