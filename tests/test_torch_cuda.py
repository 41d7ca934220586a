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
relative to the row), on a fragmented table and on one whose lengths sit
on the kernel's 128-position split edges;
kernel A fp32 1e-5 and bf16 3e-2 (the dff contraction is summed in
another order); decode-forward logits 1e-4 at fp32.
Flash forward/dQ/dK/dV: fp32 ``out`` and ``lse`` 1e-5 absolute; bf16
``out`` 2e-2 on the largest row's ||got - want|| / ||want|| (the kernel
rounds p to bf16 at running maxima, the plain version at the row maximum;
bf16 forward, dQ and dK/dV sum on the tensor cores, in another order);
gradients 1e-4 (fp32) and 2e-2 (bf16) on the largest, over (batch, row,
head), of ||got - want|| / ||want|| across head_dim, with ||want|| floored
at 1e-2 of its head's RMS row norm.
Ring step: the finalised ``acc / l`` of one hop from a non-trivial carry,
per row as ``out`` (1e-5 relative fp32, 2e-2 bf16), and its lse 1e-4
absolute; the banded backward as the gradients above. A ring of one
against ``flash_attention``: 1e-4 per row, fp32. A chunk whose keys are
all padding leaves the ring carry bit for bit (bf16 and fp32, chunks of
16), and Ulysses over a ring of one is ``flash_attention`` bit for bit.
"""

import numpy as np
import pytest
import torch

from transformer_tpu_torch.config import ModelConfig
from transformer_tpu_torch.kernels.flash_attention import (
    flash_attention,
    flash_chunk_bwd,
    flash_dkdv,
    flash_dkdv_plain,
    flash_dq,
    flash_dq_plain,
    flash_fwd,
    flash_fwd_plain,
    flash_ring_step,
    flash_ring_step_plain,
)
from transformer_tpu_torch.kernels import launch_counts
from transformer_tpu_torch.kernels.paged_flash import (
    paged_flash_attention,
    paged_flash_attention_plain,
)
from transformer_tpu_torch.models.paged_decode import paged_decode_forward
from transformer_tpu_torch.models.transformer import init_params
from transformer_tpu_torch.ops.attention import _quantize_kv, init_block_pool
from transformer_tpu_torch.ops.ffn import fused_ln_ffn, fused_ln_ffn_plain
from transformer_tpu_torch.serve.graph import CapturedForward

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


def _split_edge_case(dtype, h, h_kv, quant, s_q, block=16, d=64, seed=0):
    """Lengths on the kernel's 128-position split edges over a table 257
    entries wide (33 splits, most of them past every length, so most CTAs
    write empty partials): one split exactly, one split + 1, S_q alone,
    and 258, whose last S_q = 4 rows straddle the second split's end (as
    129's do the first's). Blocks scattered over the pool; unused entries
    on sink block 0."""
    rng = np.random.default_rng(seed)
    lengths = [128, 129, s_q, 258]
    need = [-(-L // block) for L in lengths]
    blocks = 1 + sum(need)
    perm = rng.permutation(np.arange(1, blocks)).tolist()
    table = np.zeros((len(lengths), 257), np.int32)
    for i, k in enumerate(need):
        table[i, :k] = [perm.pop() for _ in range(k)]
    kf = torch.from_numpy(rng.standard_normal((blocks, block, h_kv, d), np.float32))
    vf = torch.from_numpy(rng.standard_normal((blocks, block, h_kv, d), np.float32))
    q = torch.from_numpy(rng.standard_normal((len(lengths), s_q, h, d), np.float32)).to(dtype)
    if quant:
        k, ks = _quantize_kv(kf)
        v, vs = _quantize_kv(vf)
        extra = {"k_scale": ks.cuda(), "v_scale": vs.cuda()}
    else:
        k, v, extra = kf.to(dtype), vf.to(dtype), {}
    args = (q, k, v, torch.from_numpy(table), torch.tensor(lengths, dtype=torch.int32))
    return tuple(t.cuda() for t in args), extra


PAGED_TABLES = {"fragmented": _pool_case, "split_edges": _split_edge_case}


@pytest.mark.parametrize("s_q", [1, 4])
@pytest.mark.parametrize("variant", sorted(B_VARIANTS))
@pytest.mark.parametrize("table", sorted(PAGED_TABLES))
def test_paged_attention_kernel_matches_plain(cuda, table, variant, s_q):
    dtype, h, h_kv, quant, tol = B_VARIANTS[variant]
    args, extra = PAGED_TABLES[table](dtype, h, h_kv, quant, s_q)
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


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("s_q", [1, 4], ids=["decode", "verify"])
def test_captured_forward_replays_equal_the_eager_forward(cuda, s_q, dtype):
    """``serve/graph.py``: the first call of a shape (eager on a side
    stream, then the capture) and three replays, each with new tokens,
    table and positions, against the eager forward on copies of the same
    pools: logits and pools bit for bit, the same launch counts."""
    cfg = ModelConfig(
        num_layers=2, d_model=64, num_heads=4, dff=128, input_vocab_size=60,
        target_vocab_size=60, max_position=128, decoder_only=True,
        dtype=dtype, dropout_rate=0.0,
    )
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    pools = []
    for _ in range(cfg.num_layers):
        pool = init_block_pool(12, 16, cfg.kv_heads, cfg.head_dim, cfg.compute_dtype,
                               device="cuda")
        for buf in pool.values():
            buf.copy_(torch.rand(buf.shape, generator=gen, device="cuda") * 0.05)
        pools.append(pool)
    fwd = CapturedForward(params, pools, cfg, 16, cuda)
    rng = np.random.default_rng(2)
    for step in range(4):
        toks = rng.integers(1, 60, (3, s_q))
        table = np.stack([rng.permutation(np.arange(1, 12))[:4] for _ in range(3)])
        table[2] = 0  # a free slot on the sink
        index = np.asarray([rng.integers(0, 60), rng.integers(0, 60), 0])
        ref = [{k: v.clone() for k, v in p.items()} for p in pools]
        before = launch_counts()
        want = CapturedForward(params, ref, cfg, 16, cuda).eager(toks, table, index)
        mid = launch_counts()
        got = fwd(toks, table, index).clone()
        after = launch_counts()
        assert torch.equal(got, want), step
        for p, r in zip(pools, ref):
            for key in p:
                assert torch.equal(p[key], r[key]), (step, key)
        assert {k: after[k] - mid[k] for k in after} == {k: mid[k] - before[k] for k in mid}
        assert mid["paged_flash_attention"] - before["paged_flash_attention"] == cfg.num_layers
    assert [sig for sig, _ in fwd.captures] == [(3, s_q, 4)]


FLASH_CASES = {
    # dtype, B, S_q, S_k, H, H_kv, D, causal, window, padded
    "fp32_causal_pad": (torch.float32, 2, 200, 200, 4, 4, 64, True, 0, True),
    "bf16_causal_pad": (torch.bfloat16, 2, 200, 200, 4, 4, 64, True, 0, True),
    "bf16_gqa_window": (torch.bfloat16, 2, 333, 333, 8, 2, 64, True, 70, False),
    "bf16_cross_pad": (torch.bfloat16, 2, 96, 257, 4, 4, 32, False, 0, True),
    "fp32_d32": (torch.float32, 1, 130, 130, 2, 1, 32, True, 0, False),
    # the bf16 tensor-core kernels' edges: D 32; S shorter than a tile, or
    # straddling a 128-row CTA; GQA with a group of 4
    "bf16_d32_causal": (torch.bfloat16, 2, 200, 200, 4, 4, 32, True, 0, False),
    "bf16_s1_cross_pad": (torch.bfloat16, 2, 1, 100, 4, 4, 64, False, 0, True),
    "bf16_s63_causal_pad": (torch.bfloat16, 2, 63, 63, 4, 4, 64, True, 0, True),
    "bf16_s129_causal": (torch.bfloat16, 2, 129, 129, 4, 4, 64, True, 0, False),
    "bf16_gqa4_causal_pad": (torch.bfloat16, 2, 200, 200, 8, 2, 64, True, 0, True),
    # a band of -100 without causality (as a ring hop passes it): rows past
    # 155 see no key and the last q tile's CTAs have no k tile at all
    "bf16_band_neg100_pad": (torch.bfloat16, 2, 256, 256, 4, 4, 64, False, -100, True),
}


def _flash_case(name, seed=0):
    """Inputs of a FLASH_CASES entry; its window is the band (of any sign
    without causality)."""
    dtype, b, s_q, s_k, h, h_kv, d, causal, window, padded = FLASH_CASES[name]
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to("cuda", dtype)

    mask = None
    if padded:
        m = np.ones((b, s_k), bool)
        m[0, s_k - 37:] = False
        m[-1, :9] = False  # with causal: the first 9 rows see no key
        mask = torch.from_numpy(m).cuda()
    kw = dict(kv_mask=mask, causal=causal, band=window or None)
    return (t(b, s_q, h, d), t(b, s_k, h_kv, d), t(b, s_k, h_kv, d), t(b, s_q, h, d)), kw


def _rel_per_row(got, want):
    """Largest, over (batch, row, head), of ||got - want|| / ||want|| across
    head_dim; ||want|| is floored at 1e-2 of its (batch, head)'s RMS row
    norm, so rows whose exact gradient is about 0 do not read rounding."""
    diff = (got.float() - want.float()).norm(dim=-1)
    ref = want.float().norm(dim=-1)
    floor = 1e-2 * ref.pow(2).mean(dim=1, keepdim=True).sqrt()
    return (diff / torch.maximum(ref, floor).clamp_min(1e-30)).max().item()


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_kernels_match_plain(cuda, name):
    (q, k, v, do), kw = _flash_case(name)
    fp32 = q.dtype == torch.float32
    before = (flash_fwd.launches, flash_dq.launches, flash_dkdv.launches)
    out, lse = flash_fwd(q, k, v, **kw)
    want_out, want_lse = flash_fwd_plain(q, k, v, **kw)
    delta = (do.float() * want_out.float()).sum(-1).permute(0, 2, 1).contiguous()
    dq = flash_dq(q, k, v, do, want_lse, delta, **kw)
    dk, dv = flash_dkdv(q, k, v, do, want_lse, delta, **kw)
    torch.cuda.synchronize()
    assert (flash_fwd.launches, flash_dq.launches, flash_dkdv.launches) == tuple(
        n + 1 for n in before
    )
    if fp32:
        np.testing.assert_allclose(out.cpu().numpy(), want_out.cpu().numpy(), rtol=0, atol=1e-5)
    else:
        diff = (out.float() - want_out.float()).norm(dim=-1)
        rel = (diff / want_out.float().norm(dim=-1).clamp_min(1e-30))
        rel = torch.where(want_out.float().norm(dim=-1) > 0, rel, diff)
        assert rel.max().item() <= 2e-2, rel.max().item()
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(), rtol=0,
                               atol=1e-5 if fp32 else 1e-4)
    tol = 1e-4 if fp32 else 2e-2
    want_dq = flash_dq_plain(q, k, v, do, want_lse, delta, **kw)
    want_dk, want_dv = flash_dkdv_plain(q, k, v, do, want_lse, delta, **kw)
    for got, want, label in ((dq, want_dq, "dq"), (dk, want_dk, "dk"), (dv, want_dv, "dv")):
        assert got.dtype == want.dtype and got.shape == want.shape, label
        assert _rel_per_row(got, want) <= tol, (label, _rel_per_row(got, want))
    if kw["kv_mask"] is not None and kw["causal"]:
        assert torch.all(out[-1, :9] == 0) and torch.all(dq[-1, :9] == 0)
    # Every row that sees no key: lse -1e30, out and dQ exactly 0.
    empty = (want_lse <= -1e29).permute(0, 2, 1)  # (B, S_q, H)
    assert torch.all(lse.permute(0, 2, 1)[empty] == -1e30)
    assert torch.all(out[empty] == 0) and torch.all(dq[empty] == 0)


def test_flash_attention_autograd_runs_the_three_kernels(cuda):
    (q, k, v, do), kw = _flash_case("fp32_causal_pad", seed=3)
    grads = []
    before = (flash_fwd.launches, flash_dq.launches, flash_dkdv.launches)
    for reference in (False, True):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = flash_attention(*leaves, kv_mask=kw["kv_mask"], causal=kw["causal"],
                              reference=reference)
        grads.append(torch.autograd.grad(out, leaves, do))
    assert (flash_fwd.launches, flash_dq.launches, flash_dkdv.launches) == tuple(
        n + 1 for n in before
    )
    for got, want in zip(*grads):
        assert _rel_per_row(got, want) <= 1e-4


RING_CASES = {
    # dtype, B, C, H, H_kv, D, causal, band, padded
    "fp32_diagonal_pad": (torch.float32, 2, 200, 4, 4, 64, True, None, True),
    "bf16_below_diagonal": (torch.bfloat16, 2, 256, 8, 8, 64, False, None, False),
    "bf16_gqa_band_neg40": (torch.bfloat16, 2, 333, 8, 2, 64, False, -40, True),
    "fp32_d32_band0": (torch.float32, 1, 130, 2, 1, 32, False, 0, False),
    "bf16_gqa_causal_band70": (torch.bfloat16, 2, 333, 8, 2, 64, True, 70, False),
}


def _finalised(m, l, acc, dtype):
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    return (acc / l_safe.permute(0, 2, 1)[..., None]).to(dtype), m + torch.log(l_safe)


@pytest.mark.parametrize("name", sorted(RING_CASES))
def test_ring_step_and_banded_backward_match_plain(cuda, name):
    dtype, b, c, h, h_kv, d, causal, band, padded = RING_CASES[name]
    rng = np.random.default_rng(1)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to("cuda", dtype)

    q, k0, v0, k, v, do = (t(b, c, h, d), t(b, c, h_kv, d), t(b, c, h_kv, d), t(b, c, h_kv, d),
                           t(b, c, h_kv, d), t(b, c, h, d))
    mask = torch.ones((b, c), dtype=torch.bool, device="cuda")
    if padded:
        mask[0, c - 37:] = False
        mask[-1, :9] = False
    fresh = (torch.full((b, h, c), -1e30, device="cuda"), torch.zeros((b, h, c), device="cuda"),
             torch.zeros((b, c, h, d), device="cuda"))
    carry = flash_ring_step_plain(q, k0, v0, None, *fresh)
    kw = dict(causal=causal, band=band)
    got = [x.clone() for x in carry]
    before = flash_ring_step.launches
    out = flash_ring_step(q, k, v, mask, *got, **kw)
    assert all(a is b for a, b in zip(out, got)) and flash_ring_step.launches == before + 1
    want = flash_ring_step_plain(q, k, v, mask, *carry, **kw)
    (g_out, g_lse), (w_out, w_lse) = _finalised(*got, dtype), _finalised(*want, dtype)
    rel = ((g_out.float() - w_out.float()).norm(dim=-1)
           / w_out.float().norm(dim=-1).clamp_min(1e-30)).max().item()
    fp32 = dtype == torch.float32
    assert rel <= (1e-5 if fp32 else 2e-2), rel
    assert (g_lse - w_lse).abs().max().item() <= 1e-4
    w_fwd, lse = flash_fwd_plain(q, k, v, kv_mask=mask, **kw)
    delta = (do.float() * w_fwd.float()).sum(-1).permute(0, 2, 1).contiguous()
    got_grads = flash_chunk_bwd(q, k, v, mask, lse, delta, do, **kw)
    want_grads = (flash_dq_plain(q, k, v, do, lse, delta, kv_mask=mask, **kw),
                  *flash_dkdv_plain(q, k, v, do, lse, delta, kv_mask=mask, **kw))
    for g, w, label in zip(got_grads, want_grads, ("dq", "dk", "dv")):
        assert _rel_per_row(g, w) <= (1e-4 if fp32 else 2e-2), (label, _rel_per_row(g, w))


def test_ring_of_one_runs_the_ring_kernels(cuda):
    from transformer_tpu_torch.parallel.ring_attention import ring_attention

    (q, k, v, do), kw = _flash_case("fp32_causal_pad", seed=4)
    grads = []
    before = (flash_ring_step.launches, flash_dq.launches, flash_dkdv.launches)
    for ring in (True, False):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        if ring:
            out = ring_attention(*leaves, group=None, kv_mask=kw["kv_mask"], causal=True)
        else:
            out = flash_attention(*leaves, kv_mask=kw["kv_mask"], causal=True)
        grads.append((out, *torch.autograd.grad(out, leaves, do)))
    assert flash_ring_step.launches == before[0] + 1
    assert (flash_dq.launches, flash_dkdv.launches) == (before[1] + 2, before[2] + 2)
    for got, want in zip(*grads):
        assert _rel_per_row(got, want) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_ring_step_over_a_chunk_of_padding_leaves_the_carry(cuda, dtype):
    rng = np.random.default_rng(2)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to("cuda", dtype)

    b, c, h, d = 8, 16, 8, 64
    q, k0, v0, k, v = (t(b, c, h, d) for _ in range(5))
    fresh = (torch.full((b, h, c), -1e30, device="cuda"), torch.zeros((b, h, c), device="cuda"),
             torch.zeros((b, c, h, d), device="cuda"))
    carry = flash_ring_step_plain(q, k0, v0, None, *fresh)
    mask = torch.ones((b, c), dtype=torch.bool, device="cuda")
    mask[1::2] = False  # every other sequence visits with padding only
    got = [x.clone() for x in carry]
    flash_ring_step(q, k, v, mask, *got)
    for g, c0 in zip(got, carry):
        assert torch.equal(g[1::2], c0[1::2])
        assert not torch.equal(g[0::2], c0[0::2])


def test_ulysses_over_a_ring_of_one_is_flash_attention(cuda):
    from transformer_tpu_torch.parallel.ring_attention import ulysses_attention

    (q, k, v, do), kw = _flash_case("bf16_causal_pad", seed=5)
    outs = []
    for fn in (ulysses_attention, None):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        if fn is None:
            out = flash_attention(*leaves, kv_mask=kw["kv_mask"], causal=True)
        else:
            out = fn(*leaves, group=None, kv_mask=kw["kv_mask"], causal=True)
        outs.append((out, *torch.autograd.grad(out, leaves, do)))
    for got, want in zip(*outs):
        assert torch.equal(got, want)
