"""Cross-process and determinism checks.

Port of ``transformer_tpu/utils/consistency.py``. Under data × sequence
parallelism every process holds the whole train state and must take the
same update; a rank whose data order or dropout stream drifts trains a
different model, and nothing else notices. These helpers make that
assertable:

- :func:`tree_fingerprint`: a crc32 per leaf, keyed as checkpoints key
  their leaves (``train.checkpoint``), equal to the JAX package's for the
  same bytes;
- :func:`assert_cross_process_consistent`: every process must hold the
  same bytes for every leaf;
- :func:`assert_step_deterministic`: the same step on the same inputs
  must give the same bytes twice.

Every comparison is over raw bytes, never floats: state that holds the
same NaNs compares equal (a loss blow-up reads as a numerics problem, not
as a replication bug), and no two different byte patterns compare equal
through a lossy summary. The port holds no sharded leaves (fsdp and tp
are not ported), so every leaf is compared.
"""

from __future__ import annotations

import zlib
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from transformer_tpu_torch.train.checkpoint import _flatten, dtype_name, to_numpy


def _host_leaves(tree: Any) -> dict[str, np.ndarray]:
    """Every leaf of ``tree`` as a host array under its checkpoint key.
    CUDA leaves come to the host in one copy: their bytes packed into one
    buffer on the device, copied once, then cut back into leaves."""
    flat = _flatten(tree)
    out: dict[str, np.ndarray] = {}
    cuda = [k for k, v in flat.items() if isinstance(v, torch.Tensor) and v.is_cuda]
    if cuda:
        raw = [flat[k].detach().contiguous().reshape(-1).view(torch.uint8) for k in cuda]
        host = torch.cat(raw).cpu()
        at = 0
        for key, r in zip(cuda, raw):
            part = host[at : at + r.numel()].view(flat[key].dtype).reshape(flat[key].shape)
            out[key] = to_numpy(part)
            at += r.numel()
    for key, leaf in flat.items():
        if key not in out:
            out[key] = to_numpy(leaf)
    return {k: out[k] for k in flat}


def _leaf_crc(a: np.ndarray) -> int:
    """crc32 over dtype, shape and raw bytes (the JAX twin's digest)."""
    a = np.ascontiguousarray(a)
    h = zlib.crc32(f"{dtype_name(a)}:{tuple(int(n) for n in a.shape)}:".encode())
    return zlib.crc32(a.tobytes(), h) & 0xFFFFFFFF


def tree_fingerprint(tree: Any) -> dict[str, int]:
    """One crc32 per leaf of ``tree`` (nested dicts and lists of tensors or
    arrays, or a ``TrainState``), keyed by the checkpoint format's flat
    names, so that a mismatch names the parameter."""
    return {key: _leaf_crc(a) for key, a in _host_leaves(tree).items()}


def fingerprints_equal(a: dict[str, int], b: dict[str, int]) -> list[str]:
    """Names of the leaves whose digests differ (or that only one holds)."""
    bad = [k for k in a if a[k] != b.get(k)]
    bad += [k for k in b if k not in a]
    return sorted(set(bad))


def assert_cross_process_consistent(tree: Any, label: str = "params", group=None) -> None:
    """Every process of ``group`` (default: the world) must hold the same
    bytes for every leaf of ``tree``. Each process digests its leaves, the
    digests are gathered over the group, and a difference raises
    ``RuntimeError`` naming the first leaves that differ and the ranks
    that disagree with rank 0. Without an initialised process group, or
    in a world of one, it passes without reading anything."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return
    prints = tree_fingerprint(tree)
    keys = list(prints)
    gathered: list = [None] * dist.get_world_size(group)
    dist.all_gather_object(gathered, [prints[k] for k in keys], group=group)
    table = np.asarray(gathered, dtype=np.uint64)  # (processes, leaves)
    mismatch = (table != table[0:1]).any(axis=0)
    if mismatch.any():
        bad = [keys[i] for i in np.flatnonzero(mismatch)]
        first = keys.index(bad[0])
        ranks = [int(r) for r in np.flatnonzero(table[:, first] != table[0, first])]
        raise RuntimeError(
            f"cross-process divergence in {label}: {len(bad)} leaves differ across the "
            f"{table.shape[0]} processes, starting with {bad[:5]}; on {bad[0]!r} "
            f"ranks {ranks} disagree with rank 0 — replicated state is no longer "
            "replicated (a per-process data-order or dropout-stream bug)"
        )


def _outputs(out: Any) -> list[np.ndarray]:
    """Host arrays of a step's outputs: tuples and lists in order, a
    tensor or number as itself, anything else (a ``TrainState``, a dict of
    metrics or params) leaf by leaf."""
    if isinstance(out, (list, tuple)):
        return [a for o in out for a in _outputs(o)]
    if isinstance(out, (torch.Tensor, np.ndarray, float, int)):
        return [to_numpy(out)]
    return list(_host_leaves(out).values())


def assert_step_deterministic(step_fn, *args, label: str = "train step") -> None:
    """Run ``step_fn(*args)`` twice and require the same output bytes,
    leaf for leaf. ``step_fn`` must leave its inputs as they were (the
    train step updates its state in place: wrap it to step a copy)."""
    first, second = _outputs(step_fn(*args)), _outputs(step_fn(*args))
    if len(first) != len(second):
        raise RuntimeError(f"{label} is nondeterministic: {len(first)} outputs, then "
                           f"{len(second)}")
    for i, (a, b) in enumerate(zip(first, second)):
        if dtype_name(a) != dtype_name(b) or a.shape != b.shape or a.tobytes() != b.tobytes():
            raise RuntimeError(
                f"{label} is nondeterministic: output leaf {i} differs between two "
                "identical invocations"
            )
