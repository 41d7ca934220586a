"""Kernels of the port and what addresses them: the paged-attention CUDA
kernel, the KV block pool, and the build/load of csrc/."""


def counted_wrappers() -> tuple:
    """Every kernel wrapper of the port; each counts its launches in
    ``.launches``."""
    from transformer_tpu_torch.kernels.flash_attention import (
        flash_dkdv,
        flash_dq,
        flash_fwd,
        flash_ring_step,
    )
    from transformer_tpu_torch.kernels.paged_flash import paged_flash_attention
    from transformer_tpu_torch.ops.ffn import fused_ln_ffn

    return (flash_fwd, flash_ring_step, flash_dq, flash_dkdv, paged_flash_attention, fused_ln_ffn)


def launch_counts() -> dict[str, int]:
    """Each wrapper's launch count, by its name."""
    return {fn.__name__: fn.launches for fn in counted_wrappers()}


def add_launches(counts: dict[str, int]) -> None:
    """Add ``counts`` (by wrapper name) to the wrappers' counts: a CUDA
    graph's replay launches what its capture counted once."""
    for fn in counted_wrappers():
        fn.launches += counts.get(fn.__name__, 0)
