"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled at
first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so <name>.cu

into ``build/kernels/<name>-<hash>/`` at the root of the checkout (listed
in ``.gitignore``), keyed by a hash of the source and the flags, and
loaded with ``ctypes``. No PyTorch headers are involved, so a build takes
seconds. A failed build raises with the compiler's output. Nothing here
runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
            "CUDA kernels are built from source at first use"
        )
    return found


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out_dir = BUILD_DIR / f"{name}-{digest}"
    return src, out_dir / f"lib{name}.so"


def _start(name: str):
    """Start one nvcc (or return None when the library is already built)."""
    src, lib = _target(name)
    if lib.exists():
        return None
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, lib, cmd


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, lib, cmd = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"building CUDA kernel {name!r} failed (exit {proc.returncode}):\n"
            f"$ {' '.join(cmd)}\n{out}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    (lib.parent / "ptxas.txt").write_text(out)


def build(names: list[str]) -> dict[str, str]:
    """Build every named kernel source in parallel (one nvcc each, all
    started together); returns each one's ptxas report ('' when the
    library was already built by an earlier process)."""
    with _lock:
        started = {name: _start(name) for name in names}
        for name, s in started.items():
            _finish(name, s)
        reports = {}
        for name in names:
            report = _target(name)[1].parent / "ptxas.txt"
            reports[name] = report.read_text() if report.exists() else ""
        return reports


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use, with
    ``argtypes`` set from ``signatures`` (function name -> ctypes argument
    types; every function returns a C int)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
    build([name])
    with _lock:
        if name not in _loaded:
            lib = ctypes.CDLL(str(_target(name)[1]))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _loaded[name] = lib
        return _loaded[name]


def check(status: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if status != 0:
        raise RuntimeError(
            f"CUDA kernel {name!r} failed to launch: cudaError_t {status}"
        )
