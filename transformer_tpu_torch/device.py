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


def device_memory_stats(device: torch.device) -> dict | None:
    """The caching allocator's statistics of a CUDA ``device`` under the
    JAX package's key names (``obs.device_memory_stats``): ``bytes_in_use``
    (``allocated_bytes.all.current``), ``peak_bytes_in_use``
    (``allocated_bytes.all.peak``, what ``torch.cuda.max_memory_allocated``
    reads) and ``bytes_limit`` (the card's total memory). None on the CPU,
    where there is nothing to read, as the JAX package's CPU devices give
    none."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    if not stats:
        return None
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(device).total_memory),
    }
