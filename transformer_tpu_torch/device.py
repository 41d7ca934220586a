"""Where the port's entry points run.

Every entry point takes a ``device`` argument that defaults to ``"cuda"``.
With no card present, asking for CUDA raises: nothing falls back to the
CPU behind the caller's back. Tests pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for queued device work (host-clock timing needs it)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
