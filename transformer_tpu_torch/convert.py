"""Weights across the two packages.

The JAX package flattens its parameter tree with ``/``-joined path names
(``transformer_tpu/train/checkpoint.py`` ``_flatten``:
``decoder/layers/0/self_mha/query/kernel``) and an export is that flat
dict saved as ``params.npz`` beside a ``config.json``. The port keeps the
same tree, in the same layouts, as nested dicts/lists of torch tensors, so
the map is one-to-one and exact: numpy -> port -> numpy is byte-identical.
This module reads and writes those files itself; it never imports the JAX
package.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from transformer_tpu_torch.config import ModelConfig, config_from_json, config_to_json
from transformer_tpu_torch.device import resolve_device
from transformer_tpu_torch.models.transformer import flatten, param_spec, unflatten

# int8-quantized export leaves: codes under key + Q8, scales under key + Q8S.
Q8_SUFFIX = "::q8"
Q8_SCALE_SUFFIX = "::q8scale"


def params_from_numpy(flat: dict[str, np.ndarray], cfg: ModelConfig, device="cuda"):
    """Flat JAX-named numpy arrays -> the port's nested params on
    ``device``, checked leaf by leaf against ``cfg``'s parameter layout.
    int8-quantized leaves (``::q8`` codes + ``::q8scale`` scales) are
    dequantized as ``codes * scale`` in fp32; every leaf then takes the
    model's ``param_dtype``."""
    dev = resolve_device(device)
    out = {}
    for key, (shape, _) in param_spec(cfg).items():
        if key in flat:
            arr = np.asarray(flat[key])
        elif key + Q8_SUFFIX in flat:
            codes = np.asarray(flat[key + Q8_SUFFIX]).astype(np.float32)
            arr = codes * flat[key + Q8_SCALE_SUFFIX]
        else:
            raise KeyError(f"no array for parameter {key!r}")
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
    """The port's params -> flat JAX-named numpy arrays (CPU copies)."""
    return {k: v.detach().cpu().numpy() for k, v in flatten(params).items()}


def export_params(params, cfg: ModelConfig, path: str) -> None:
    """Write ``params.npz`` + ``config.json`` in the JAX export layout."""
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "params.npz"), **params_to_numpy(params))
    with open(os.path.join(path, "config.json"), "w") as f:
        f.write(config_to_json(cfg))


def load_export(path: str, kv_cache_int8: bool = False, device="cuda"):
    """(params, cfg) from an export directory (either package's).
    ``kv_cache_int8`` opts the served model into the int8 KV pool."""
    import dataclasses

    with open(os.path.join(path, "config.json")) as f:
        cfg = config_from_json(ModelConfig, f.read())
    if kv_cache_int8:
        cfg = dataclasses.replace(cfg, kv_cache_int8=True)
    with np.load(os.path.join(path, "params.npz")) as data:
        flat = {k: data[k] for k in data.files}
    return params_from_numpy(flat, cfg, device=device), cfg
