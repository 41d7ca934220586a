"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here carries the ``cuda`` marker and skips without a CUDA
device. This file imports neither jax nor the JAX package, so it runs on
the card's machine, which has no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

(``--noconftest``: the suite's conftest pins JAX to the CPU.)

Tolerances: kernel B fp32 5e-6; bf16/int8/GQA 2e-2 on the largest, over
(sequence, query row, head), of ||got - want|| / ||want|| across head_dim
(the online softmax rounds p to bf16 at running maxima, the plain version
at the row maximum; attention outputs shrink with length, so the limit is
relative to the row);
kernel A fp32 1e-5 and bf16 3e-2 (the dff contraction is summed in
another order); decode-forward logits 1e-4 at fp32.
"""

import numpy as np
import pytest
import torch

from transformer_tpu_torch.config import ModelConfig
from transformer_tpu_torch.kernels.paged_flash import (
    paged_flash_attention,
    paged_flash_attention_plain,
)
from transformer_tpu_torch.models.paged_decode import paged_decode_forward
from transformer_tpu_torch.models.transformer import init_params
from transformer_tpu_torch.ops.attention import _quantize_kv, init_block_pool
from transformer_tpu_torch.ops.ffn import fused_ln_ffn, fused_ln_ffn_plain

pytestmark = pytest.mark.cuda

ACTIVATIONS = ["geglu", "gelu", "reglu", "relu", "silu", "swiglu"]
B_VARIANTS = {
    "fp32": (torch.float32, 4, 4, False, 5e-6),
    "bf16": (torch.bfloat16, 4, 4, False, 2e-2),
    "int8": (torch.bfloat16, 4, 4, True, 2e-2),
    "gqa": (torch.bfloat16, 8, 2, False, 2e-2),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pool_case(dtype, h, h_kv, quant, s_q, block=16, d=64, seed=0):
    """Fragmented, aliased table over a random pool; lengths end mid-block
    and span several 64-token tiles."""
    rng = np.random.default_rng(seed)
    table = np.asarray(
        [[3, 5, 1, 9, 0, 0], [6, 2, 4, 8, 7, 10], [3, 5, 11, 0, 0, 0]], np.int32
    )
    lengths = np.asarray([3 * block + 5, 6 * block, 2 * block + 1], np.int32)
    kf = torch.from_numpy(rng.standard_normal((12, block, h_kv, d), np.float32))
    vf = torch.from_numpy(rng.standard_normal((12, block, h_kv, d), np.float32))
    q = torch.from_numpy(rng.standard_normal((3, s_q, h, d), np.float32)).to(dtype)
    if quant:
        k, ks = _quantize_kv(kf)
        v, vs = _quantize_kv(vf)
        extra = {"k_scale": ks.cuda(), "v_scale": vs.cuda()}
    else:
        k, v, extra = kf.to(dtype), vf.to(dtype), {}
    args = (q, k, v, torch.from_numpy(table), torch.from_numpy(lengths))
    return tuple(t.cuda() for t in args), extra


@pytest.mark.parametrize("s_q", [1, 4])
@pytest.mark.parametrize("variant", sorted(B_VARIANTS))
def test_paged_attention_kernel_matches_plain(cuda, variant, s_q):
    dtype, h, h_kv, quant, tol = B_VARIANTS[variant]
    args, extra = _pool_case(dtype, h, h_kv, quant, s_q)
    before = paged_flash_attention.launches
    got = paged_flash_attention(*args, **extra)
    torch.cuda.synchronize()
    assert paged_flash_attention.launches == before + 1
    want = paged_flash_attention_plain(*args, **extra)
    assert got.dtype == want.dtype and got.shape == want.shape
    if dtype == torch.float32:
        np.testing.assert_allclose(
            got.cpu().numpy(), want.cpu().numpy(), rtol=tol, atol=tol
        )
    else:
        diff = (got.float() - want.float()).norm(dim=-1)
        rel = (diff / want.float().norm(dim=-1)).max().item()
        assert rel <= tol, rel


def test_paged_attention_kernel_skips_stale_entries(cuda):
    args, extra = _pool_case(torch.bfloat16, 4, 4, False, 1)
    base = paged_flash_attention(*args, **extra)
    hostile = args[3].clone()
    hostile[0, 4:] = 7  # entries past slot 0's length
    got = paged_flash_attention(*args[:3], hostile, args[4], **extra)
    assert torch.equal(got, base)


def test_paged_attention_kernel_rejects_wrong_pool_dtype(cuda):
    args, _ = _pool_case(torch.bfloat16, 4, 4, False, 1)
    with pytest.raises(ValueError, match="pool dtype"):
        paged_flash_attention(args[0], args[1].float(), args[2].float(), *args[3:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("norm_scheme", ["pre", "post"])
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_fused_ln_ffn_kernel_matches_plain(cuda, activation, norm_scheme, dtype):
    """11 rows (a ragged second row tile), d=64, dff=256 (8 column tiles)."""
    rng = np.random.default_rng(1)
    d, dff = 64, 256

    def t(shape, scale=1.0, offset=0.0):
        a = rng.standard_normal(shape).astype(np.float32) * scale + offset
        return torch.from_numpy(a).to(cuda, dtype)

    lim = (6.0 / (d + dff)) ** 0.5
    ffn = {"in": {"kernel": t((d, dff), lim), "bias": t((dff,), 0.1)},
           "out": {"kernel": t((dff, d), lim), "bias": t((d,), 0.1)}}
    if activation in ("geglu", "reglu", "swiglu"):
        ffn["gate"] = {"kernel": t((d, dff), lim), "bias": t((dff,), 0.1)}
    ln = {"scale": t((d,), 0.1, 1.0), "bias": t((d,), 0.1)}
    x = t((11, d))
    kw = dict(activation=activation, norm_scheme=norm_scheme)
    before = fused_ln_ffn.launches
    got = fused_ln_ffn(ln, ffn, x, **kw)
    torch.cuda.synchronize()
    assert fused_ln_ffn.launches == before + 1
    want = fused_ln_ffn_plain(ln, ffn, x, **kw)
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    np.testing.assert_allclose(
        got.float().cpu().numpy(), want.float().cpu().numpy(), rtol=0, atol=tol
    )


@pytest.mark.parametrize("kv_cache_int8", [False, True], ids=["fp32", "int8"])
def test_decode_forward_kernels_match_reference(cuda, kv_cache_int8):
    """One verify-shaped forward (S_q = 2) of a small fp32 model on both
    kernels against ``reference=True`` on the same pool state."""
    cfg = ModelConfig(
        num_layers=2, d_model=64, num_heads=4, dff=128, input_vocab_size=60,
        target_vocab_size=60, max_position=128, decoder_only=True,
        dtype="float32", dropout_rate=0.0, kv_cache_int8=kv_cache_int8,
    )
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    pools = []
    for _ in range(cfg.num_layers):
        pool = init_block_pool(8, 16, cfg.kv_heads, cfg.head_dim, torch.float32,
                               quantize=kv_cache_int8, device="cuda")
        for key, buf in pool.items():
            if buf.dtype == torch.int8:
                buf.copy_(torch.randint(-127, 128, buf.shape, generator=gen, device="cuda"))
            else:
                buf.copy_(torch.rand(buf.shape, generator=gen, device="cuda") * 0.05)
        pools.append(pool)
    table = torch.tensor([[2, 5, 1], [3, 0, 0], [0, 0, 0]], dtype=torch.int32, device="cuda")
    index = torch.tensor([35, 7, 0], dtype=torch.int32, device="cuda")
    toks = torch.tensor([[5, 9], [1, 2], [0, 0]], device="cuda")
    before = (paged_flash_attention.launches, fused_ln_ffn.launches)
    outs = []
    for reference in (False, True):
        state = [{k: v.clone() for k, v in p.items()} for p in pools]
        logits, _ = paged_decode_forward(params, toks, state, table, index, cfg,
                                         block_tokens=16, reference=reference)
        outs.append(logits)
    assert paged_flash_attention.launches == before[0] + cfg.num_layers
    assert fused_ln_ffn.launches == before[1] + cfg.num_layers
    np.testing.assert_allclose(outs[0].cpu().numpy(), outs[1].cpu().numpy(), rtol=0, atol=1e-4)
