"""The port's kernel build and binding, on the CPU: nothing is compiled.

``kernels/build.py`` keys each library by its source, every ``csrc/*.cuh``
header and the nvcc flags, so an edit to a header that a source includes
builds a new library instead of loading a stale one. The bf16 flash
kernels (forward, ring step, dQ, dK/dV) read their tiles through TMA
tensor maps, which need 16-byte aligned base addresses: the wrappers'
check raises on anything else, before anything is built or launched.
"""

import shutil

import pytest
import torch

from transformer_tpu_torch.kernels import build
from transformer_tpu_torch.kernels import flash_attention as fa
from transformer_tpu_torch.kernels.flash_attention import _check_tma_aligned


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    dst = tmp_path / "csrc"
    shutil.copytree(build.CSRC, dst)
    monkeypatch.setattr(build, "CSRC", dst)
    return dst


def _edit_header(csrc):
    path = csrc / "hopper.cuh"
    path.write_bytes(path.read_bytes() + b"\n// edited\n")


def _edit_source(csrc):
    path = csrc / "flash_attention.cu"
    path.write_bytes(path.read_bytes() + b"\n// edited\n")


def _add_header(csrc):
    (csrc / "extra.cuh").write_text("#pragma once\n")


@pytest.mark.parametrize("change", [_edit_header, _edit_source, _add_header],
                         ids=["edit_header", "edit_source", "add_header"])
def test_library_key_follows_sources_and_headers(csrc_copy, change):
    src, before = build._target("flash_attention")
    assert src == csrc_copy / "flash_attention.cu"
    assert build._target("flash_attention")[1] == before  # stable while nothing changes
    change(csrc_copy)
    after = build._target("flash_attention")[1]
    assert after != before and after.name == before.name == "libflash_attention.so"


def test_library_key_is_restored_with_the_bytes(csrc_copy):
    header = csrc_copy / "hopper.cuh"
    original = header.read_bytes()
    before = build._target("flash_attention")[1]
    header.write_bytes(original.replace(b"namespace hopper", b"namespace hopper2", 1))
    assert build._target("flash_attention")[1] != before
    header.write_bytes(original)
    assert build._target("flash_attention")[1] == before


def test_tma_inputs_must_be_16_byte_aligned():
    buf = torch.zeros(4 * 64 + 8, dtype=torch.bfloat16)
    _check_tma_aligned(buf[:256], torch.zeros(3, 5, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="16-byte"):
        _check_tma_aligned(buf[:256], buf[1:257])


@pytest.mark.parametrize("operand", ["q", "k", "v", "do"])
@pytest.mark.parametrize("wrapper", ["flash_dq", "flash_dkdv"])
def test_bf16_backward_wrappers_refuse_a_misaligned_view(monkeypatch, wrapper, operand):
    """The bf16 dQ and dK/dV wrappers, routed as for a CUDA tensor, raise
    the TMA alignment error on a view 2 bytes into its buffer before they
    build or launch anything."""
    monkeypatch.setattr(fa, "_device_kind", lambda q: "cuda")

    def no_build(*args, **kwargs):
        raise AssertionError("the wrapper reached the build")

    monkeypatch.setattr(build, "load", no_build)
    b, s, h, d = 1, 8, 2, 32
    shape = (b, s, h, d)
    t = {name: torch.zeros(shape, dtype=torch.bfloat16) for name in ("q", "k", "v", "do")}
    buf = torch.zeros(b * s * h * d + 1, dtype=torch.bfloat16)
    t[operand] = buf[1:].view(shape)
    assert t[operand].is_contiguous() and t[operand].data_ptr() % 16
    lse = torch.zeros((b, h, s), dtype=torch.float32)
    with pytest.raises(ValueError, match="16-byte"):
        getattr(fa, wrapper)(t["q"], t["k"], t["v"], t["do"], lse, lse.clone(), causal=True)


@pytest.mark.parametrize("operand", ["q", "k", "v"])
def test_bf16_ring_step_refuses_a_misaligned_view(monkeypatch, operand):
    """The bf16 ring step runs on the tensor cores with TMA-fed tiles: its
    wrapper, routed as for a CUDA tensor, raises the alignment error on a
    view 2 bytes into its buffer before it builds or launches anything."""
    monkeypatch.setattr(fa, "_device_kind", lambda q: "cuda")

    def no_build(*args, **kwargs):
        raise AssertionError("the wrapper reached the build")

    monkeypatch.setattr(build, "load", no_build)
    b, c, h, d = 1, 8, 2, 32
    shape = (b, c, h, d)
    t = {name: torch.zeros(shape, dtype=torch.bfloat16) for name in ("q", "k", "v")}
    buf = torch.zeros(b * c * h * d + 1, dtype=torch.bfloat16)
    t[operand] = buf[1:].view(shape)
    assert t[operand].is_contiguous() and t[operand].data_ptr() % 16
    m = torch.full((b, h, c), -1e30)
    l, acc = torch.zeros((b, h, c)), torch.zeros(shape)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_ring_step(t["q"], t["k"], t["v"], None, m, l, acc, causal=True)
