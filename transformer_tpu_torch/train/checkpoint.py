"""Checkpoints of the train state with rotation, and the serving export.

Port of ``transformer_tpu/train/checkpoint.py``, in its on-disk format, so
a checkpoint written by either package restores in the other:

    <dir>/ckpt_<step:08d>/
        arrays.npz      the state under its flat names (``state_to_flat``)
        meta.json       step + key list
        manifest.json   per-array crc32 + shape + dtype, and a sha256 digest
                        over that table; written atomically (tmp + fsync +
                        rename) and verified by ``restore_latest`` before
                        the arrays are used

Saves write a ``.tmp`` directory and rename it into place, so a crash
mid-save never leaves a torn newest checkpoint. The port holds its state
replicated and writes only this layout; ``restore`` also reads the JAX
package's *sharded* layout (``shards_p*.npz``, each entry named
``key@start:stop,...`` by its slice of the global array), reassembling
every array on the host.

numpy has no bfloat16: a bf16 leaf is stored as its raw 2-byte words
(a ``V2`` array, as JAX's ``ml_dtypes`` arrays read back without that
package), named ``bfloat16`` in the manifest, and viewed back as
``torch.bfloat16`` on restore.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import sys
import zipfile
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

from transformer_tpu_torch.config import ModelConfig, config_to_json
from transformer_tpu_torch.models.transformer import flatten, unflatten
from transformer_tpu_torch.train.state import TrainState, state_from_flat, state_to_flat

# Failures that mean "this checkpoint is torn or corrupt, try an older one"
# in ``restore_latest``: truncated npz members, a garbled meta.json, missing
# arrays, shape or manifest mismatches.
_CORRUPT_CHECKPOINT_ERRORS = (OSError, EOFError, KeyError, ValueError, zipfile.BadZipFile)

MANIFEST_NAME = "manifest.json"

# int8-quantized export leaves: codes under key + Q8_SUFFIX, fp32 scales
# under key + Q8_SCALE_SUFFIX. Leaves below _Q8_MIN_SIZE elements stay fp.
Q8_SUFFIX = "::q8"
Q8_SCALE_SUFFIX = "::q8scale"
_Q8_MIN_SIZE = 1024

_BF16_WORDS = np.dtype("V2")


class CheckpointIntegrityError(ValueError):
    """The checkpoint's bytes disagree with its manifest, or the manifest
    is torn. A ValueError, so ``restore_latest`` falls back past it."""


# --------------------------------------------------------------------------
# host arrays


def _is_bf16_words(a: np.ndarray) -> bool:
    return a.dtype.kind == "V" and a.dtype.itemsize == 2


def dtype_name(a: np.ndarray) -> str:
    return "bfloat16" if _is_bf16_words(a) else str(a.dtype)


def to_numpy(value) -> np.ndarray:
    """A host copy of a tensor or array (never a view of it); bf16 as raw
    2-byte words."""
    if isinstance(value, torch.Tensor):
        t = value.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_WORDS)
        return t.numpy()
    return np.array(value)


def _like(saved: np.ndarray, leaf):
    """``saved`` as ``leaf`` holds it: a tensor of its dtype on its device,
    or a numpy array of its dtype. bf16 words are viewed, not converted."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(saved).astype(np.asarray(leaf).dtype)
    arr = np.asarray(saved, order="C")
    if _is_bf16_words(arr):
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=leaf.device, dtype=leaf.dtype)


def _load_npz(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _flatten(state) -> dict[str, Any]:
    """A ``TrainState`` under the JAX names, or nested dicts of tensors or
    arrays under ``/``-joined paths."""
    return state_to_flat(state) if isinstance(state, TrainState) else flatten(state)


def snapshot(state) -> dict[str, np.ndarray]:
    """Host copies of every leaf of ``state``: what a save writes, taken
    before it returns so that later in-place updates cannot reach it."""
    return {k: to_numpy(v) for k, v in _flatten(state).items()}


# --------------------------------------------------------------------------
# the manifest


def manifest_entries(flat: dict[str, np.ndarray]) -> dict:
    """crc32 over each array's raw bytes, its shape and dtype, by name."""
    out = {}
    for key in sorted(flat):
        a = np.ascontiguousarray(flat[key])
        out[key] = {
            "crc32": zlib.crc32(a.tobytes()) & 0xFFFFFFFF,
            "shape": list(a.shape),
            "dtype": dtype_name(a),
        }
    return out


def manifest_digest(entries: dict) -> str:
    """sha256 over the canonical entry table (its first 16 hex digits): the
    checkpoint's weight version. Byte-identical saves give the same."""
    blob = json.dumps(entries, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def build_manifest(flat: dict[str, np.ndarray], step: int | None) -> dict:
    entries = manifest_entries(flat)
    return {"format": "manifest-v1", "step": step, "arrays": entries,
            "digest": manifest_digest(entries)}


def write_manifest(dirpath: str, flat: dict[str, np.ndarray], step: int | None = None) -> dict:
    """Commit ``dirpath``'s manifest atomically: tmp file, fsync, rename."""
    manifest = build_manifest(flat, step)
    final = os.path.join(dirpath, MANIFEST_NAME)
    tmp = final + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    return manifest


def load_manifest(ckpt_dir: str) -> dict | None:
    """The checkpoint's manifest, None when it has none; a torn one raises
    ``CheckpointIntegrityError``."""
    path = os.path.join(ckpt_dir, MANIFEST_NAME)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            manifest = json.load(f)
    except ValueError as e:
        raise CheckpointIntegrityError(f"manifest at {ckpt_dir} is unparseable: {e}") from e
    if not isinstance(manifest, dict) or not isinstance(manifest.get("arrays"), dict) \
            or "digest" not in manifest:
        raise CheckpointIntegrityError(f"manifest at {ckpt_dir} is missing its arrays/digest fields")
    return manifest


def verify_manifest(ckpt_dir: str, flat: dict[str, np.ndarray] | None = None) -> str:
    """Check ``ckpt_dir``'s arrays (``flat`` if already loaded) against its
    manifest: its own digest, the key set, then each array's shape, dtype
    and crc32. Returns the digest; raises ``CheckpointIntegrityError`` on
    any disagreement."""
    manifest = load_manifest(ckpt_dir)
    if manifest is None:
        raise CheckpointIntegrityError(f"no manifest at {ckpt_dir}")
    entries = manifest["arrays"]
    if manifest_digest(entries) != manifest["digest"]:
        raise CheckpointIntegrityError(f"manifest at {ckpt_dir} fails its own digest (torn manifest)")
    if flat is None:
        flat = _load_npz(os.path.join(ckpt_dir, "arrays.npz"))
    if sorted(flat) != sorted(entries):
        missing = sorted(set(entries) - set(flat))
        extra = sorted(set(flat) - set(entries))
        raise CheckpointIntegrityError(
            f"checkpoint at {ckpt_dir} disagrees with its manifest key set "
            f"(missing {missing[:3]}, extra {extra[:3]})"
        )
    for key, e in entries.items():
        a = np.ascontiguousarray(flat[key])
        if list(a.shape) != e["shape"] or dtype_name(a) != e["dtype"]:
            raise CheckpointIntegrityError(
                f"{key}: stored {a.shape}/{dtype_name(a)} but the manifest records "
                f"{tuple(e['shape'])}/{e['dtype']}"
            )
        if (zlib.crc32(a.tobytes()) & 0xFFFFFFFF) != e["crc32"]:
            raise CheckpointIntegrityError(
                f"{key}: stored bytes fail the manifest crc32; the checkpoint is torn or corrupt"
            )
    return manifest["digest"]


# --------------------------------------------------------------------------
# the JAX package's sharded layout (read only)


def _parse_entry(entry: str) -> tuple[str, tuple[tuple[int, int], ...]]:
    key, sep, spec = entry.rpartition("@")
    if not sep:
        return entry, ()
    if not spec:  # a scalar leaf: "key@"
        return key, ()
    return key, tuple((int(a), int(b)) for a, b in (p.split(":") for p in spec.split(",")))


def _read_sharded(ckpt_dir: str, meta: dict, keys) -> dict[str, np.ndarray]:
    """Each of ``keys`` reassembled on the host from every shard file's
    slices of it; raises KeyError when the slices do not cover it."""
    names = sorted(n for n in os.listdir(ckpt_dir) if n.startswith("shards_p") and n.endswith(".npz"))
    handles = [np.load(os.path.join(ckpt_dir, n)) for n in names]
    try:
        slices: dict[str, list] = {}
        for h in handles:
            for entry in h.files:
                key, bounds = _parse_entry(entry)
                slices.setdefault(key, []).append((bounds, h, entry))
        flat = {}
        for key in keys:
            if key not in meta["arrays"]:
                raise KeyError(f"checkpoint missing array {key!r}")
            shape = tuple(meta["arrays"][key]["shape"])
            out = filled = None
            for bounds, h, entry in slices.get(key, []):
                part = h[entry]
                if out is None:
                    out, filled = np.empty(shape, part.dtype), np.zeros(shape, bool)
                region = tuple(slice(a, b) for a, b in bounds)
                out[region] = part
                filled[region] = True
            if out is None or not filled.all():
                raise KeyError(f"checkpoint shard files do not cover {key!r}")
            flat[key] = out
        return flat
    finally:
        for h in handles:
            h.close()


# --------------------------------------------------------------------------
# managers


def _primary() -> bool:
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


class CheckpointManager:
    """Rotated checkpoints of a ``TrainState`` (or nested dicts of tensors
    or arrays) keyed by step. Only the primary process (rank 0 when
    ``torch.distributed`` is initialised) writes; every process reads."""

    def __init__(self, directory: str, max_to_keep: int = 5, is_primary: bool | None = None):
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.is_primary = _primary() if is_primary is None else is_primary
        if self.is_primary:
            os.makedirs(directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}")

    # ------------------------------------------------------------------ save
    def save(self, state, step: int | None = None) -> str | None:
        """Write ``state`` at ``step`` (default ``state.step``); returns the
        checkpoint's directory, None on a process that does not write."""
        step = int(state.step) if step is None else int(step)
        if not self.is_primary:
            return None
        self._write(snapshot(state), step)
        return self.path(step)

    def _write(self, flat: dict[str, np.ndarray], step: int) -> None:
        """tmp dir, arrays.npz + meta.json + manifest, atomic rename, then
        rotation: the one writer of both managers."""
        tmp = self.path(step) + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "keys": sorted(flat)}, f)
        write_manifest(tmp, flat, step)
        final = self.path(step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self.all_steps()[: -self.max_to_keep]:
            shutil.rmtree(self.path(old))

    def all_steps(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        found = (re.fullmatch(r"ckpt_(\d{8})", n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    @property
    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # --------------------------------------------------------------- restore
    def restore(self, template, step: int):
        """``template`` with the arrays of checkpoint ``step`` (either
        layout): names and shapes checked, each leaf on the template's
        device in its dtype. The template is left as it was."""
        ckpt_dir = self.path(step)
        meta_path = os.path.join(ckpt_dir, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            if meta.get("format") == "sharded-v1":
                keys = list(_flatten(template))
                return self._fill(template, _read_sharded(ckpt_dir, meta, keys))
        return self._fill(template, _load_npz(os.path.join(ckpt_dir, "arrays.npz")))

    @staticmethod
    def _fill(template, flat: dict[str, np.ndarray]):
        want = _flatten(template)
        for key, leaf in want.items():
            if key not in flat:
                raise KeyError(f"checkpoint missing array {key!r}")
            if tuple(flat[key].shape) != tuple(leaf.shape):
                raise ValueError(
                    f"{key}: checkpoint shape {flat[key].shape} != target {tuple(leaf.shape)}"
                )
        out = {key: _like(flat[key], leaf) for key, leaf in want.items()}
        return state_from_flat(out, template) if isinstance(template, TrainState) else unflatten(out)

    def restore_latest(self, template, on_fallback=None):
        """Restore the newest intact checkpoint. A torn or corrupt newest
        one (bytes checked against its manifest before anything else) is
        skipped with a warning and ``on_fallback(step, exc)``, and the next
        newest tried. When every checkpoint fails the last failure
        re-raises: that is a changed model or config, not bit rot, and
        starting over would rotate the good checkpoints away. An empty
        directory returns None."""
        last_exc: Exception | None = None
        for step in reversed(self.all_steps()):
            ckpt_dir = self.path(step)
            try:
                if os.path.exists(os.path.join(ckpt_dir, MANIFEST_NAME)):
                    flat = _load_npz(os.path.join(ckpt_dir, "arrays.npz"))
                    verify_manifest(ckpt_dir, flat)
                    return self._fill(template, flat)
                return self.restore(template, step)
            except _CORRUPT_CHECKPOINT_ERRORS as e:
                last_exc = e
                print(
                    f"checkpoint: ckpt_{step:08d} in {self.directory} is unreadable "
                    f"({type(e).__name__}: {e}); falling back to the previous checkpoint",
                    file=sys.stderr,
                )
                if on_fallback is not None:
                    on_fallback(step, e)
        if last_exc is not None:
            raise last_exc
        return None

    def wait(self) -> None:
        """Nothing is pending in the synchronous manager."""


class AsyncCheckpointManager(CheckpointManager):
    """Checkpoints written by a worker thread. ``save`` takes the host
    snapshot before it returns (the train step updates the parameters in
    place, so a later copy would hold the next step's values), then hands
    the write, rename and rotation to the worker. One write is in flight
    at a time; ``wait`` blocks until it has committed and re-raises a
    failure of the worker."""

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-writer")
        self._pending: Future | None = None

    def save(self, state, step: int | None = None) -> str | None:
        step = int(state.step) if step is None else int(step)
        self.wait()
        if not self.is_primary:
            return None
        self._pending = self._executor.submit(self._write, snapshot(state), step)
        return self.path(step)

    def wait(self) -> None:
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def restore(self, template, step: int):
        self.wait()  # never read a checkpoint mid-write
        return super().restore(template, step)

    def restore_latest(self, template, on_fallback=None):
        self.wait()
        return super().restore_latest(template, on_fallback=on_fallback)


def average_checkpoints(mgr: CheckpointManager, template: TrainState, steps: list[int]):
    """The uniform average of the parameters of checkpoints ``steps``
    (nested params like ``template.params``): fp64 sums in step order, cast
    back to each leaf's dtype. The optimizer state is restored and
    dropped."""
    if not steps:
        raise ValueError("average_checkpoints needs at least one step")
    acc: dict[str, np.ndarray] | None = None
    for step in steps:
        params = flatten(mgr.restore(template, step).params)
        arrs = {k: v.detach().to("cpu", torch.float64).numpy() for k, v in params.items()}
        acc = arrs if acc is None else {k: acc[k] + arrs[k] for k in acc}
    n = float(len(steps))
    like = flatten(template.params)
    return unflatten({
        k: torch.from_numpy(a / n).to(device=like[k].device, dtype=like[k].dtype)
        for k, a in acc.items()
    })


# --------------------------------------------------------------------------
# the serving export


def _q8_group_axes(key: str, w: np.ndarray):
    """Reduction axes of one leaf's quantization groups: a scale per row of
    an embedding table; per (head, slot) for 3-D+ kernels whose leading
    axes hold >= 16 values; else per slot of the last axis."""
    if key.endswith("embedding/table"):
        return -1
    if w.ndim >= 3 and int(np.prod(w.shape[:-2])) >= 16:
        return tuple(range(w.ndim - 2))
    return tuple(range(w.ndim - 1))


def _quantize_leaf(key: str, w: np.ndarray) -> dict[str, np.ndarray] | None:
    """Symmetric int8 codes and fp32 scales for one float leaf of rank >= 2
    and >= 1024 elements that is not a bias, else None (kept fp)."""
    if w.ndim < 2 or w.size < _Q8_MIN_SIZE or w.dtype.kind != "f" or key.endswith("/bias"):
        return None
    axis = _q8_group_axes(key, w)
    amax = np.max(np.abs(w.astype(np.float32)), axis=axis, keepdims=True)
    scale = (amax / 127.0).astype(np.float32)
    scale = np.where(scale == 0.0, 1.0, scale)  # all-zero groups stay zero
    q = np.clip(np.rint(w.astype(np.float32) / scale), -127, 127).astype(np.int8)
    return {key + Q8_SUFFIX: q, key + Q8_SCALE_SUFFIX: scale}


def export_params(params, model_cfg: ModelConfig, path: str, quantize: str = "") -> None:
    """``params.npz`` + ``config.json`` in the JAX export layout.
    ``quantize="int8"`` stores each large weight as symmetric int8 codes
    plus fp32 scales (about 4x smaller than fp32); loaders dequantize."""
    if quantize not in ("", "int8"):
        raise ValueError(f"quantize must be '' or 'int8', got {quantize!r}")
    os.makedirs(path, exist_ok=True)
    flat = {}
    for key, value in flatten(params).items():
        arr = to_numpy(value)
        if quantize:
            if _is_bf16_words(arr):  # bf16 -> fp32 exactly: the word is the top half
                q = _quantize_leaf(key, (arr.view(np.uint16).astype(np.uint32) << 16).view(np.float32))
            else:
                q = _quantize_leaf(key, arr)
            if q is not None:
                flat.update(q)
                continue
        flat[key] = arr
    np.savez(os.path.join(path, "params.npz"), **flat)
    with open(os.path.join(path, "config.json"), "w") as f:
        f.write(config_to_json(model_cfg))


def exported_leaf(flat: dict[str, np.ndarray], key: str) -> np.ndarray:
    """Parameter ``key`` of an export's arrays, int8 leaves dequantized as
    ``codes * scale`` in fp32."""
    if key in flat:
        return flat[key]
    if key + Q8_SUFFIX in flat:
        return flat[key + Q8_SUFFIX].astype(np.float32) * flat[key + Q8_SCALE_SUFFIX]
    raise KeyError(f"no array for parameter {key!r}")


def load_exported_params(path: str, template):
    """Nested params like ``template`` (its dtypes and devices) from the
    export at ``path``, either package's, int8 leaves dequantized."""
    flat = _load_npz(os.path.join(path, "params.npz"))
    out = {}
    for key, leaf in flatten(template).items():
        arr = exported_leaf(flat, key)
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(
                f"export at {path}: leaf {key!r} has shape {arr.shape} but the template "
                f"expects {tuple(leaf.shape)}; was the template built from another config?"
            )
        out[key] = _like(arr, leaf)
    return unflatten(out)
