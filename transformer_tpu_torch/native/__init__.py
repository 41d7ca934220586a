"""The port's native (C++) data path, loaded with ctypes.

A copy of ``transformer_tpu/native``: ``tokenizer.cc`` (the BPE trainer
and greedy longest-match encoder, bit-identical to the Python ones in
``data/tokenizer.py``) and ``dataloader.cc`` (the prefetching batch
loader: a worker thread fills a ring of padded int32 batches in a
splitmix64 Fisher-Yates order per (seed, epoch), the order of the JAX
package's default ``--native_loader``). It is compiled at first use with

    g++ -O2 -std=c++17 -fPIC -shared -o libtpu_native.so tokenizer.cc \
        dataloader.cc -lpthread

into ``build/native/<hash>/`` at the root of the checkout (listed in
``.gitignore``), keyed by a hash of the sources and the flags, written to
a temporary file and renamed into place, so processes that build at once
never load a half-written library. ``$CXX`` names another compiler.
``TRANSFORMER_TPU_NO_NATIVE=1`` turns the library off (the Python paths
run instead); so does a failed build. Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
SOURCES = ("tokenizer.cc", "dataloader.cc")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

_lib: ctypes.CDLL | bool | None = None  # None = not tried, False = unavailable


def library_path() -> Path:
    """Where the library of these sources and flags lives once built."""
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode() + b"\0" + (SOURCE_DIR / name).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / h.hexdigest()[:16] / "libtpu_native.so"


def _build() -> Path | None:
    """Compile the library unless it is built; its path, or None."""
    try:
        lib = library_path()
    except OSError:  # a source is missing: no library
        return None
    if lib.exists():
        return lib
    tmp = None
    try:
        lib.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
        os.close(fd)
        cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp,
               *(str(SOURCE_DIR / s) for s in SOURCES), "-lpthread"]
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, lib)
        return lib
    except (OSError, subprocess.SubprocessError):
        if tmp is not None:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        return None


def get_lib() -> ctypes.CDLL | None:
    """The loaded library, or None when it is turned off or cannot be built."""
    global _lib
    if _lib is False:
        return None
    if _lib is not None:
        return _lib
    if os.environ.get("TRANSFORMER_TPU_NO_NATIVE"):
        _lib = False
        return None
    path = _build()
    if path is None:
        _lib = False
        return None
    try:
        lib = ctypes.CDLL(str(path))
        _bind(lib)
    except (OSError, AttributeError):  # dlopen failure or a missing symbol
        _lib = False
        return None
    _lib = lib
    return lib


def _bind(lib: ctypes.CDLL) -> None:
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.tpu_tok_create.restype = ctypes.c_void_p
    lib.tpu_tok_create.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.tpu_tok_train.restype = ctypes.c_void_p
    lib.tpu_tok_train.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, i64p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32,
    ]
    lib.tpu_tok_free.restype = None
    lib.tpu_tok_free.argtypes = [ctypes.c_void_p]
    lib.tpu_tok_num_pieces.restype = ctypes.c_int32
    lib.tpu_tok_num_pieces.argtypes = [ctypes.c_void_p]
    lib.tpu_tok_pieces_blob.restype = ctypes.c_int64
    lib.tpu_tok_pieces_blob.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
    lib.tpu_tok_encode.restype = ctypes.c_int64
    lib.tpu_tok_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, i32p, ctypes.c_int64,
    ]
    lib.tpu_dl_create.restype = ctypes.c_void_p
    lib.tpu_dl_create.argtypes = [
        i32p, i64p, i32p, i64p,
        ctypes.c_int64,  # n_examples
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # global/local/lo
        ctypes.c_int32, ctypes.c_int32,  # src_len/tgt_len
        ctypes.c_int32,  # pad_id
        ctypes.c_int32,  # queue_depth
        i32p, ctypes.c_int32,  # bucket widths, n_buckets (0 = unbucketed)
    ]
    lib.tpu_dl_free.restype = None
    lib.tpu_dl_free.argtypes = [ctypes.c_void_p]
    lib.tpu_dl_start_epoch.restype = None
    lib.tpu_dl_start_epoch.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.tpu_dl_next.restype = ctypes.c_int32
    lib.tpu_dl_next.argtypes = [ctypes.c_void_p, i32p, i32p, i32p]


class NativeBatchLoader:
    """ctypes handle to the C++ prefetching loader; owns the native object.
    ``epochs`` and ``batches`` count the epochs started and the batches
    handed out over its life."""

    def __init__(self, handle: int, lib: ctypes.CDLL, local_batch: int,
                 src_len: int, tgt_len: int, bucketed: bool = False):
        self._handle = ctypes.c_void_p(handle)
        self._lib = lib
        self.local_batch = local_batch
        # Bucket widths apply to both sides and are bounded by max(src_len,
        # tgt_len), so bucketed receive buffers take that max on each side
        # (as the C++ slots do).
        if bucketed:
            self.src_len = self.tgt_len = max(src_len, tgt_len)
        else:
            self.src_len, self.tgt_len = src_len, tgt_len
        self._generation = 0  # starting an epoch ends the iterators before it
        self.epochs = 0
        self.batches = 0

    def __del__(self):  # noqa: D105
        h, self._handle = self._handle, None
        if h:
            self._lib.tpu_dl_free(h)

    @classmethod
    def create(
        cls,
        src: list,
        tgt: list,
        global_batch: int,
        local_batch: int,
        lo: int,
        src_len: int,
        tgt_len: int,
        pad_id: int = 0,
        queue_depth: int = 3,
        length_buckets: tuple = (),
    ) -> "NativeBatchLoader | None":
        """A loader over the examples, each process taking rows ``lo ..
        lo + local_batch`` of every ``global_batch``; None without the
        library."""
        lib = get_lib()
        if lib is None:
            return None
        src_off = np.zeros(len(src) + 1, dtype=np.int64)
        np.cumsum([len(a) for a in src], out=src_off[1:])
        tgt_off = np.zeros(len(tgt) + 1, dtype=np.int64)
        np.cumsum([len(a) for a in tgt], out=tgt_off[1:])
        src_flat = np.concatenate(src).astype(np.int32) if len(src) else np.zeros(0, np.int32)
        tgt_flat = np.concatenate(tgt).astype(np.int32) if len(tgt) else np.zeros(0, np.int32)
        buckets = np.asarray(sorted(length_buckets), dtype=np.int32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        handle = lib.tpu_dl_create(
            src_flat.ctypes.data_as(i32p), src_off.ctypes.data_as(i64p),
            tgt_flat.ctypes.data_as(i32p), tgt_off.ctypes.data_as(i64p),
            len(src), global_batch, local_batch, lo, src_len, tgt_len,
            pad_id, queue_depth, buckets.ctypes.data_as(i32p), len(buckets),
        )
        if not handle:
            return None
        return cls(handle, lib, local_batch, src_len, tgt_len, bucketed=len(buckets) > 0)

    def epoch(self, seed: int, shuffle: bool, drop_remainder: bool):
        """Start the producer and yield (src, tgt) int32 batches (a bucketed
        loader's at their bucket's width). One live iterator per loader:
        starting an epoch ends the one before it at its next pull."""
        self._generation += 1
        my_generation = self._generation
        self.epochs += 1
        self._lib.tpu_dl_start_epoch(
            self._handle, ctypes.c_uint64(seed & 0xFFFFFFFFFFFFFFFF), int(shuffle),
            int(drop_remainder),
        )
        i32p = ctypes.POINTER(ctypes.c_int32)
        while self._generation == my_generation:
            src = np.empty((self.local_batch, self.src_len), dtype=np.int32)
            tgt = np.empty((self.local_batch, self.tgt_len), dtype=np.int32)
            widths = np.empty(2, dtype=np.int32)
            ok = self._lib.tpu_dl_next(
                self._handle, src.ctypes.data_as(i32p), tgt.ctypes.data_as(i32p),
                widths.ctypes.data_as(i32p),
            )
            if not ok:
                return
            self.batches += 1
            sw, tw = int(widths[0]), int(widths[1])
            # The C++ side packs rows at the batch's own stride: reshape the
            # filled prefix rather than slicing the widest view.
            yield (
                src.reshape(-1)[: self.local_batch * sw].reshape(self.local_batch, sw),
                tgt.reshape(-1)[: self.local_batch * tw].reshape(self.local_batch, tw),
            )


class NativeTokenizer:
    """ctypes handle to a C++ tokenizer; owns the native object."""

    def __init__(self, handle: int, lib: ctypes.CDLL):
        self._handle = ctypes.c_void_p(handle)
        self._lib = lib

    def __del__(self):  # noqa: D105
        h, self._handle = self._handle, None
        if h:
            self._lib.tpu_tok_free(h)

    @classmethod
    def from_pieces(cls, pieces: list[str]) -> "NativeTokenizer | None":
        lib = get_lib()
        if lib is None:
            return None
        blob = "\n".join(pieces).encode("utf-8")
        handle = lib.tpu_tok_create(blob, len(blob))
        return cls(handle, lib) if handle else None

    @classmethod
    def train(
        cls, word_freq: "dict[str, int]", target_vocab_size: int, min_pair_count: int
    ) -> "NativeTokenizer | None":
        """Train BPE over a {unique word: count} mapping in first-occurrence
        order (splitting and counting stay in Python, so ``str.split()`` and
        ``Counter`` decide the words exactly)."""
        lib = get_lib()
        if lib is None:
            return None
        blob = "\n".join(word_freq).encode("utf-8")
        counts = np.fromiter(word_freq.values(), dtype=np.int64, count=len(word_freq))
        handle = lib.tpu_tok_train(
            blob, len(blob), counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(word_freq), target_vocab_size, min_pair_count,
        )
        return cls(handle, lib) if handle else None

    def pieces(self) -> list[str]:
        need = self._lib.tpu_tok_pieces_blob(self._handle, None, 0)
        buf = ctypes.create_string_buffer(int(need))
        self._lib.tpu_tok_pieces_blob(self._handle, buf, need)
        return [p for p in buf.raw[:need].decode("utf-8").split("\n") if p]

    def encode_words(self, words: list[str]) -> list[int]:
        if not words:
            return []
        blob = "\n".join(words).encode("utf-8")
        # Escaping can expand the input ('_' -> '\\u' can emit two
        # byte-fallback ids per input byte): two ids per byte and one
        # word-end marker per word always suffice.
        cap = 2 * len(blob) + len(words) + 8
        out = np.empty(cap, dtype=np.int32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        n = self._lib.tpu_tok_encode(self._handle, blob, len(blob), out.ctypes.data_as(i32p), cap)
        if n > cap:  # defensive: the bound above holds
            out = np.empty(int(n), dtype=np.int32)
            n = self._lib.tpu_tok_encode(self._handle, blob, len(blob),
                                         out.ctypes.data_as(i32p), int(n))
        return out[:n].tolist()
