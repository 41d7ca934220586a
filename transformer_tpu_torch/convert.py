"""Weights across the two packages.

The JAX package flattens its parameter tree with ``/``-joined path names
(``transformer_tpu/train/checkpoint.py`` ``_flatten``:
``decoder/layers/0/self_mha/query/kernel``) and an export is that flat
dict saved as ``params.npz`` beside a ``config.json``. The port keeps the
same tree, in the same layouts, as nested dicts/lists of torch tensors, so
the map is one-to-one and exact: numpy -> port -> numpy is byte-identical.
The export files are read and written by ``train/checkpoint.py``
(``exported_leaf``, ``export_params``); nothing here imports the JAX
package.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from transformer_tpu_torch.config import ModelConfig, config_from_json
from transformer_tpu_torch.device import resolve_device
from transformer_tpu_torch.models.transformer import flatten, param_spec, unflatten
from transformer_tpu_torch.train import checkpoint


def params_from_numpy(flat: dict[str, np.ndarray], cfg: ModelConfig, device="cuda"):
    """Flat JAX-named numpy arrays -> the port's nested params on
    ``device``, checked leaf by leaf against ``cfg``'s parameter layout.
    int8-quantized leaves (``::q8`` codes + ``::q8scale`` scales) are
    dequantized as ``codes * scale`` in fp32; every leaf then takes the
    model's ``param_dtype``."""
    dev = resolve_device(device)
    out = {}
    for key, (shape, _) in param_spec(cfg).items():
        arr = np.asarray(checkpoint.exported_leaf(flat, key))
        if arr.shape != tuple(shape):
            raise ValueError(
                f"parameter {key!r} has shape {arr.shape}, the config "
                f"expects {tuple(shape)}"
            )
        out[key] = torch.from_numpy(np.array(arr, order="C")).to(
            device=dev, dtype=cfg.params_dtype
        )
    return unflatten(out)


def params_to_numpy(params) -> dict[str, np.ndarray]:
    """The port's params -> flat JAX-named numpy arrays (CPU copies; bf16
    as raw 2-byte words)."""
    return {k: checkpoint.to_numpy(v) for k, v in flatten(params).items()}


def params_digest(params) -> str:
    """sha256 over every parameter's name and bytes, in flat-name order:
    equal digests mean bit-identical parameters."""
    h = hashlib.sha256()
    for key, arr in sorted(params_to_numpy(params).items()):
        h.update(key.encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def export_params(params, cfg: ModelConfig, path: str, quantize: str = "") -> None:
    """Write ``params.npz`` + ``config.json`` in the JAX export layout
    (``quantize="int8"``: large weights as int8 codes + fp32 scales)."""
    checkpoint.export_params(params, cfg, path, quantize=quantize)


def load_export_config(path: str) -> ModelConfig:
    """The model config of an export directory, without its weights."""
    with open(os.path.join(path, "config.json")) as f:
        return config_from_json(ModelConfig, f.read())


def load_export(path: str, kv_cache_int8: bool = False, device="cuda"):
    """(params, cfg) from an export directory (either package's).
    ``kv_cache_int8`` opts the served model into the int8 KV pool."""
    import dataclasses

    cfg = load_export_config(path)
    if kv_cache_int8:
        cfg = dataclasses.replace(cfg, kv_cache_int8=True)
    with np.load(os.path.join(path, "params.npz")) as data:
        flat = {k: data[k] for k in data.files}
    return params_from_numpy(flat, cfg, device=device), cfg
