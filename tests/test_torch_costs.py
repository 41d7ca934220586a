"""The port's cost model (``transformer_tpu_torch.analysis.costs``) against
the JAX package's.

- KV budgets: ``kv_cache_bytes`` and ``kv_pool_bytes`` exactly equal to
  JAX's for every ``FULL_MATRIX`` variant with a decoder cache.
- Matrix-product FLOPs of every canned program equal to JAX's pricing of
  the same program (its ``dot_general``/conv equations priced with JAX's
  own ``costs._eqn_flops``), kernel bodies excluded on both sides. JAX's
  side is walked over ``jax.make_jaxpr`` here, finding sub-jaxprs
  through ``jax.extend.core`` (``jax.core`` on versions that lack it), so
  the comparison runs on JAX versions whose ``program_costs`` cannot.
- Each kernel's count (``kernels/work.py``) beside JAX's grid-weighted
  count for its ``pallas_call``: the products of the kernel body are equal
  on an unmasked, unpadded shape; the rest of JAX's count is the body's
  reductions (softmax max/sum, LayerNorm mean/variance), which the port's
  count of products leaves out; on a causal shape JAX's grid also counts
  the tiles the kernel skips, and the ratio is asserted.
- JAX's unit cases, ported: dot, batched dot and reduce FLOPs, liveness
  against in-place update, a dead output, the hand-computed KV bytes, the
  baseline round trip and its regressions, the one-extra-buffer canary,
  fused < gather, the CLI's exit codes and JSON, the checked-in baseline
  matching the tree, and the trainer's prediction.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_tpu.analysis import costs as jcosts
from transformer_tpu.analysis.configs import FULL_MATRIX as J_FULL_MATRIX
from transformer_tpu_torch.analysis import costs
from transformer_tpu_torch.analysis.__main__ import main as analysis_main
from transformer_tpu_torch.analysis.configs import FAST_MATRIX, FULL_MATRIX, TINY_TRAIN
from transformer_tpu_torch.kernels import work

try:
    from jax.extend import core as jcore
except ImportError:  # older JAX: the names live in jax.core
    jcore = jax.core

PRODUCTS = {"mm", "addmm", "bmm", "baddbmm", "mv", "addmv", "dot", "vdot", "convolution"}


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _f32(*shape):
    return jax.ShapeDtypeStruct(shape, np.float32)


def _i32(*shape):
    return jax.ShapeDtypeStruct(shape, np.int32)


# --------------------------------------------------------------------------
# JAX's side: a walker over make_jaxpr that does not need jax.core's old names


def _subs(value):
    if isinstance(value, jcore.ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, jcore.Jaxpr):
        yield value
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _subs(v)


def _walk(jaxpr, weight=1, in_kernel=False):
    """(eqn, weight, in_kernel) as JAX's ``costs._walk_eqns_hbm`` yields
    them: scan bodies weighted by their length, kernel bodies by the grid."""
    for eqn in jaxpr.eqns:
        yield eqn, weight, in_kernel
        mult, kernel = weight, in_kernel
        if eqn.primitive.name == "scan":
            mult = weight * int(eqn.params.get("length", 1))
        elif eqn.primitive.name == "pallas_call":
            kernel, mult = True, weight * jcosts._pallas_grid_size(eqn)
        for value in eqn.params.values():
            for sub in _subs(value):
                yield from _walk(sub, mult, kernel)


def _is_product(eqn) -> bool:
    name = eqn.primitive.name
    return name == "dot_general" or name.startswith("conv_general")


def jax_product_flops(closed) -> int:
    """JAX's pricing of the matrix products outside kernel bodies."""
    return sum(w * jcosts._eqn_flops(e) for e, w, k in _walk(closed.jaxpr)
               if not k and _is_product(e))


def jax_kernels(closed) -> list[dict]:
    """Per ``pallas_call``: its grid-weighted count (JAX's
    ``pallas_call_flops``) and the products' part of it."""
    out = []
    for eqn, w, k in _walk(closed.jaxpr):
        if eqn.primitive.name != "pallas_call" or k:
            continue
        total = products = 0
        for value in eqn.params.values():
            for sub in _subs(value):
                for e, ww, _ in _walk(sub, w * jcosts._pallas_grid_size(eqn), True):
                    f = ww * jcosts._eqn_flops(e)
                    total += f
                    products += f if _is_product(e) else 0
        out.append({"total": total, "products": products})
    return out


def port_product_flops(report) -> int:
    return sum(v for k, v in report.flops_by_op.items() if k in PRODUCTS)


# --------------------------------------------------------------------------
# KV budgets: exactly JAX's


KV_VARIANTS = [name for name, cfg in FULL_MATRIX.items() if not cfg.encoder_only]


@pytest.mark.parametrize("variant", KV_VARIANTS)
def test_kv_bytes_equal_jax(variant):
    cfg, jcfg = FULL_MATRIX[variant], J_FULL_MATRIX[variant]
    assert costs.kv_cache_bytes(cfg, 32) == jcosts.kv_cache_bytes(jcfg, 32)
    assert costs.kv_pool_bytes(cfg, 32, 2, 5, 8) == jcosts.kv_pool_bytes(jcfg, 32, 2, 5, 8)


def test_configs_are_jaxs():
    assert set(FULL_MATRIX) == set(J_FULL_MATRIX)
    for name, cfg in FULL_MATRIX.items():
        jcfg = J_FULL_MATRIX[name]
        for f in dataclasses.fields(cfg):
            if hasattr(jcfg, f.name):
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), (name, f.name)


def test_kv_bytes_mqa_ratio():
    plain = costs.kv_cache_bytes(FAST_MATRIX["lm_bf16"], 32)
    mqa = costs.kv_cache_bytes(FAST_MATRIX["lm_gqa"], 32)
    heads = FAST_MATRIX["lm_bf16"].num_heads
    assert plain["bytes_per_token"] == heads * mqa["bytes_per_token"]
    assert plain["bytes_per_slot"] == heads * mqa["bytes_per_slot"]


def test_kv_bytes_hand_computed():
    """lm_bf16: 2 layers x (k + v) x 32 tokens x 2 kv-heads x 8 head-dim x
    2 bytes = 4096 bytes/slot, 128 bytes/token; int8 codes + fp32 scales
    96 B/token; a rolling window bounds the buffer (8 rows)."""
    kv = costs.kv_cache_bytes(FAST_MATRIX["lm_bf16"], 32)
    assert kv["bytes_per_slot"] == 4096 and kv["bytes_per_token"] == 128
    assert costs.kv_cache_bytes(FAST_MATRIX["lm_int8_cache"], 32)["bytes_per_token"] == 96
    window = costs.kv_cache_bytes(FAST_MATRIX["lm_window"], 32)
    assert window["buffer_tokens"] == 8 and window["bytes_per_slot"] == 4096 // 4


# --------------------------------------------------------------------------
# the canned programs: matrix products equal to JAX's


@pytest.fixture(scope="module")
def canned():
    return costs.canned_cost_reports()


@pytest.fixture(scope="module")
def jax_canned():
    return _jax_canned()


def _jax_canned() -> dict[str, object]:
    """JAX's canned programs as jaxprs, under their names (the calls of
    ``transformer_tpu/analysis/costs.py`` ``canned_cost_reports``)."""
    from transformer_tpu.analysis.configs import FAST_MATRIX as JM
    from transformer_tpu.analysis.configs import TINY_TRAIN as JT
    from transformer_tpu.serve import scheduler as sched
    from transformer_tpu.serve.scheduler import abstract_paged_pool, abstract_pool_caches
    from transformer_tpu.train.state import TrainState, make_optimizer
    from transformer_tpu.train.trainer import make_train_step

    blocks, pool_blocks, total = jcosts._PAGED_BLOCK, jcosts._PAGED_POOL_BLOCKS, 32
    out = {}
    for variant in jcosts.SERVE_VARIANTS:
        cfg = JM[variant]
        raw = sched._pool_step.__wrapped__
        out[f"serve.pool_step[{variant}]"] = jax.make_jaxpr(
            lambda p, c, t, cfg=cfg, raw=raw: raw(p, c, t, cfg)
        )(jcosts._abstract_model(cfg), abstract_pool_caches(cfg, 2, total), _i32(2))
    for variant in jcosts.PAGED_VARIANTS:
        cfg = JM[variant]
        args = (jcosts._abstract_model(cfg),
                *abstract_paged_pool(cfg, 2, total, pool_blocks, blocks), _i32(2))
        raw = sched._pool_step_paged.__wrapped__
        out[f"serve.pool_step_paged[{variant}]"] = jax.make_jaxpr(
            lambda p, c, tb, ix, t, cfg=cfg, raw=raw: raw(p, c, tb, ix, t, cfg, blocks, total)
        )(*args)
        raw = sched._pool_step_paged_flash.__wrapped__
        out[f"serve.pool_step_paged_flash[{variant}]"] = jax.make_jaxpr(
            lambda p, c, tb, ix, t, cfg=cfg, raw=raw: raw(p, c, tb, ix, t, cfg, blocks, False)
        )(*args)
    cfg = JM["lm_bf16"]
    params = jcosts._abstract_model(cfg)
    pool, table, _ = abstract_paged_pool(cfg, 2, total, pool_blocks, blocks)
    raw = sched._slot_prefill_paged.__wrapped__
    out["serve.slot_prefill_paged[lm_bf16,n=8]"] = jax.make_jaxpr(
        lambda p, c, tb, s, pr, st: raw(p, c, tb, s, pr, st, cfg, 0, blocks, total)
    )(params, pool, table, _i32(), _i32(1, 8), _i32())
    pool = abstract_pool_caches(cfg, 2, total)
    raw = sched._slot_prefill.__wrapped__
    out["serve.slot_prefill[lm_bf16,n=8]"] = jax.make_jaxpr(
        lambda p, c, s, pr, st: raw(p, c, s, pr, st, cfg, 0)
    )(params, pool, _i32(), _i32(1, 8), _i32())
    raw = sched._pool_verify.__wrapped__
    out["serve.pool_verify[lm_bf16,W=4]"] = jax.make_jaxpr(
        lambda p, c, t: raw(p, c, t, cfg))(params, pool, _i32(2, 4))
    step_fn, tx = make_train_step(cfg, JT), make_optimizer(cfg, JT)
    state = jax.eval_shape(
        lambda p: TrainState(step=jnp.int32(0), params=p, opt_state=tx.init(p)), params)
    ids = _i32(JT.batch_size, JT.sequence_length)
    out["train.step[lm_bf16]"] = jax.make_jaxpr(step_fn)(
        state, ids, ids, jax.ShapeDtypeStruct((2,), np.uint32))
    return out


def test_canned_matrix_products_equal_jax(canned, jax_canned):
    """Every canned program's matrix-product FLOPs (kernels excluded) equal
    JAX's pricing of the same program; the restore has no product on
    either side. No by-design difference remains on the canned list."""
    reports, _ = canned
    jax_programs = jax_canned
    by_name = {r.name: r for r in reports}
    assert set(jax_programs) | {"serve.slot_restore[lm_bf16,blocks=4]"} == set(by_name)
    for name, closed in jax_programs.items():
        assert port_product_flops(by_name[name]) == jax_product_flops(closed), name
    assert port_product_flops(by_name["serve.slot_restore[lm_bf16,blocks=4]"]) == 0


def test_canned_kernel_launches_equal_jax(canned, jax_canned):
    """In the fused paged step, each launch's products equal JAX's
    grid-weighted products of its pallas_call (the canned table is read
    whole: unmasked); the rest of JAX's count is the bodies' reductions."""
    reports, _ = canned
    by_name = {r.name: r for r in reports}
    jax_programs = jax_canned
    for variant in costs.PAGED_VARIANTS:
        name = f"serve.pool_step_paged_flash[{variant}]"
        kernels = by_name[name].extras["kernels"]
        cfg = FAST_MATRIX[variant]
        assert kernels["paged_flash_attention"]["calls"] == cfg.num_layers
        assert kernels["fused_ln_ffn"]["calls"] == cfg.num_layers
        jk = jax_kernels(jax_programs[name])
        assert len(jk) == 2 * cfg.num_layers
        attn, ffn = jk[0::2], jk[1::2]  # per layer: attention, then the FFN
        assert sum(k["products"] for k in attn) == kernels["paged_flash_attention"]["flops"]
        assert sum(k["products"] for k in ffn) == kernels["fused_ln_ffn"]["flops"]
        # the reductions: softmax max and sum over (N, H, S_q, L) scores;
        # LayerNorm mean and variance over (M, d)
        n, length = 2, 32
        assert sum(k["total"] - k["products"] for k in attn) == (
            cfg.num_layers * 2 * n * cfg.num_heads * length)
        assert sum(k["total"] - k["products"] for k in ffn) == (
            cfg.num_layers * 2 * n * cfg.d_model)


# --------------------------------------------------------------------------
# each kernel's count beside JAX's pallas_call


@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernels_beside_jax(causal):
    """fwd, dQ, dK/dV: (B 2, S 256, H 2, D 32) in blocks of 128. Unmasked
    and non-causal the products are equal; causal, JAX's grid-weighted
    count takes every tile (the skipped one above the diagonal and the
    masked halves of the diagonal ones), the port's the S(S+1)/2 visible
    pairs: a ratio of 2S / (S + 1)."""
    from transformer_tpu.kernels.flash_attention import flash_attention as jflash

    b, s, h, d = 2, 256, 2, 32
    closed = jax.make_jaxpr(jax.grad(
        lambda q, k, v: jflash(q, k, v, causal=causal, interpret=True).sum(),
        argnums=(0, 1, 2)))(_f32(b, s, h, d), _f32(b, s, h, d), _f32(b, s, h, d))
    jk = jax_kernels(closed)
    assert len(jk) == 3  # forward, dQ, dK/dV
    q = _meta(b, s, h, d)
    for (name, products), j in zip(work.FLASH_PRODUCTS.items(), jk):
        port = work.flash_work(name, q, q, None, causal, None).flops
        dense = 2 * products * d * b * h * s * s
        assert j["products"] == dense, name
        if causal:  # JAX / port = 2S / (S + 1)
            assert port == dense * (s + 1) / (2 * s), name
            assert j["products"] / port == pytest.approx(2 * s / (s + 1)), name
        else:
            assert port == j["products"], name


def test_ring_step_beside_jax():
    from transformer_tpu.kernels.flash_attention import _FlashConfig
    from transformer_tpu.kernels.flash_attention import flash_ring_step as jring

    b, c, h, d, blk = 2, 256, 2, 32, 128
    cfg = _FlashConfig(causal=False, has_mask=False, block_q=blk, block_k=blk, num_heads=h,
                       scale=d**-0.5, interpret=True)
    bh = b * h
    closed = jax.make_jaxpr(lambda q, k, v, m, l, acc: jring(cfg, q, k, v, None, m, l, acc))(
        _f32(bh, c, d), _f32(bh, c, d), _f32(bh, c, d), _f32(bh, c // blk, blk, 1),
        _f32(bh, c // blk, blk, 1), _f32(bh, c, d))
    (j,) = jax_kernels(closed)
    q = _meta(b, c, h, d)
    carry = (_meta(b, h, c), _meta(b, h, c), _meta(b, c, h, d))
    assert work.ring_step_work(q, q, None, carry).flops == j["products"]


@pytest.mark.parametrize("s_q,h_kv", [(1, 2), (4, 1)])
def test_paged_attention_beside_jax(s_q, h_kv):
    from transformer_tpu.kernels.paged_flash import paged_flash_attention as jpaged

    n, h, d, block, nmax, blocks = 2, 2, 32, 8, 4, 9
    closed = jax.make_jaxpr(
        lambda q, kp, vp, t, ln: jpaged(q, kp, vp, t, ln, interpret=True))(
        _f32(n, s_q, h, d), _f32(blocks, block, h_kv, d), _f32(blocks, block, h_kv, d),
        _i32(n, nmax), _i32(n))
    (j,) = jax_kernels(closed)
    q, pool = _meta(n, s_q, h, d), _meta(blocks, block, h_kv, d)
    table, lengths = _meta(n, nmax, dtype=torch.int32), _meta(n, dtype=torch.int32)
    port = work.paged_attention_work(q, pool, table, lengths, False).flops
    # JAX's grid walks every table entry and every query row: the port's
    # full-table count with each row's own causal rows (S_q - 1 - i fewer
    # keys for row i) is that less the rows above each row's position.
    full = 4 * d * h * n * nmax * block * s_q
    assert j["products"] == full
    assert port == full - 4 * d * h * n * sum(s_q - 1 - i for i in range(s_q))


def test_fused_ln_ffn_beside_jax():
    from transformer_tpu.ops.ffn import fused_ln_ffn as jfused

    m, d, dff = 8, 64, 512
    ln = {"scale": _f32(d), "bias": _f32(d)}
    ffn = {"in": {"kernel": _f32(d, dff), "bias": _f32(dff)},
           "out": {"kernel": _f32(dff, d), "bias": _f32(d)}}
    closed = jax.make_jaxpr(lambda ln, ffn, x: jfused(ln, ffn, x, interpret=True))(
        ln, ffn, _f32(m, d))
    (j,) = jax_kernels(closed)
    assert work.fused_ln_ffn_work(_meta(m, d), dff, False).flops == j["products"]


# --------------------------------------------------------------------------
# the cost model on hand-computable programs


def test_dot_flops_and_bytes():
    """(8,16) @ (16,4) f32: FLOPs 2*8*16*4 = 1024; bytes moved = operands +
    result = 512 + 256 + 128 = 896; peak = both inputs held + the output."""
    r = costs.program_costs("dot", lambda a, b: a @ b, _meta(8, 16), _meta(16, 4))
    assert r.flops == 1024
    assert r.bytes_moved == 896
    assert r.peak_bytes == 896
    assert r.collectives == {}
    assert r.arg_bytes == 768 and r.out_bytes == 128


def test_batched_dot_flops():
    r = costs.program_costs("bmm", torch.bmm, _meta(4, 8, 16), _meta(4, 16, 4))
    assert r.flops == 4 * 2 * 8 * 16 * 4


def test_reduce_flops_counts_operand():
    r = costs.program_costs("red", lambda a: a.sum(), _meta(32, 4))
    assert r.flops == 128


def test_liveness_chain_vs_in_place_update():
    """((a+1)+1)+1 over 1 KiB buffers: the input is held and each
    temporary is freed once the next add has read it, so the worst
    instant holds a and two temporaries: 3 buffers. Updating the first
    temporary in place allocates nothing more: 2 buffers. The delta is one
    buffer, what the +1-buffer canary looks like."""
    n = 256
    buf = 4 * n
    plain = costs.program_costs("chain", lambda a: ((a + 1.0) + 1.0) + 1.0, _meta(n))
    in_place = costs.program_costs("chain_i", lambda a: (a + 1.0).add_(1.0).add_(1.0),
                                   _meta(n))
    assert plain.peak_bytes == 3 * buf
    assert in_place.peak_bytes == 2 * buf
    assert plain.bytes_moved == in_place.bytes_moved == 3 * 2 * buf
    held = costs.program_costs("held", lambda a: a.mul_(2.0), _meta(n))
    assert held.peak_bytes == buf  # an input updated in place counts once


def test_dead_output_not_held():
    """An intermediate nobody keeps is freed at once: it costs its own
    allocation but does not stack onto later ones."""
    n = 256
    buf = 4 * n

    def f(a):
        a * 2.0  # dead
        return a + 1.0

    assert costs.program_costs("dead", f, _meta(n)).peak_bytes == 2 * buf


def test_views_move_and_allocate_nothing():
    r = costs.program_costs("view", lambda a: a.view(16, 16).t()[2:], _meta(256))
    assert r.bytes_moved == 0 and r.peak_bytes == 1024 and r.flops == 0


def test_kernel_launch_is_one_priced_op():
    """A wrapper on meta operands is its ``kernels.work`` count, once; its
    plain version's ops are not counted, its outputs are allocated."""
    from transformer_tpu_torch.kernels.flash_attention import flash_fwd

    q = _meta(2, 64, 2, 32, dtype=torch.bfloat16)
    r = costs.program_costs("fwd", lambda q, k, v: flash_fwd(q, k, v, causal=True), q, q, q)
    w = work.flash_work("flash_fwd", q, q, None, True, None)
    assert r.flops == w.flops and r.bytes_moved == w.nbytes
    assert r.extras["kernels"] == {"flash_fwd": {"calls": 1, "flops": int(w.flops),
                                                 "bytes_moved": int(w.nbytes)}}
    assert r.out_bytes == q.numel() * 2 + 2 * 2 * 64 * 4  # out + fp32 lse


# --------------------------------------------------------------------------
# the canned sweep and the baseline workflow


def test_canned_programs_cover_jaxs_list(canned):
    reports, skipped = canned
    names = {r.name for r in reports}
    jax_names = set(jcosts.load_costs_baseline(jcosts.default_costs_baseline_path())["programs"])
    assert names | set(skipped) == jax_names
    assert set(skipped) == set(costs.SHARDED_PROGRAMS)
    by_name = {r.name: r for r in reports}
    for name, r in by_name.items():
        assert r.peak_bytes > 0 and r.collectives == {}, name
    assert (by_name["serve.slot_prefill[lm_bf16,n=8]"].intensity
            > by_name["serve.pool_step[lm_bf16]"].intensity)


def test_checked_in_baseline_matches_current_tree(canned):
    reports, skipped = canned
    base = costs.load_costs_baseline(costs.default_costs_baseline_path())
    assert base, "costs_baseline.json is missing"
    regressions, _ = costs.compare_to_baseline(reports, costs.kv_budgets(), base, skipped)
    assert regressions == [], "\n".join(regressions)
    for r in reports:  # the advisory numbers too, on this installation
        assert base["programs"][r.name]["flops"] == r.flops, r.name
        assert base["programs"][r.name]["bytes_moved"] == r.bytes_moved, r.name


def test_pool_step_updates_pool_in_place(canned):
    """The step's peak pays for the pool once: it is the caller's, updated
    in place (the port's donation)."""
    reports, _ = canned
    step = {r.name: r for r in reports}["serve.pool_step[lm_bf16]"]
    kv = costs.kv_cache_bytes(FAST_MATRIX["lm_bf16"], 32)
    assert step.extras["kv_bytes_per_slot"] == kv["bytes_per_slot"]
    assert step.peak_bytes < step.arg_bytes + 2 * kv["bytes_per_slot"]


def test_fused_step_moves_fewer_bytes_than_gather(canned):
    reports, _ = canned
    by_name = {r.name: r for r in reports}
    for variant in costs.PAGED_VARIANTS:
        fused = by_name[f"serve.pool_step_paged_flash[{variant}]"]
        gather = by_name[f"serve.pool_step_paged[{variant}]"]
        assert fused.bytes_moved < gather.bytes_moved, variant


def _tiny_report(name="prog", peak=1000, flops=10, moved=100, coll=None):
    return costs.CostReport(name=name, peak_bytes=peak, flops=flops, bytes_moved=moved,
                            collectives=coll or {}, arg_bytes=0, out_bytes=0)


def test_baseline_roundtrip_and_regressions(tmp_path):
    path = str(tmp_path / "budget.json")
    kv = {"lm_bf16": {"bytes_per_slot": 4096, "bytes_per_token": 128,
                      "buffer_tokens": 32, "max_total": 32, "layers": 2}}
    costs.write_costs_baseline([_tiny_report()], kv, path)
    base = costs.load_costs_baseline(path)
    regs, _ = costs.compare_to_baseline([_tiny_report()], kv, base)
    assert regs == []
    regs, _ = costs.compare_to_baseline([_tiny_report(peak=1000 + 4096)], kv, base)
    assert any("peak_bytes" in r for r in regs)
    regs, _ = costs.compare_to_baseline(
        [_tiny_report(coll={"all_gather_into_tensor": {"count": 1, "bytes": 64}})], kv, base)
    assert any("stray collective" in r for r in regs)
    kv2 = {"lm_bf16": dict(kv["lm_bf16"], bytes_per_slot=8192)}
    regs, _ = costs.compare_to_baseline([_tiny_report()], kv2, base)
    assert any("kv_cache[lm_bf16]" in r for r in regs)
    regs, notes = costs.compare_to_baseline([_tiny_report(peak=500)], kv, base)
    assert regs == [] and any("improved" in n for n in notes)
    regs, _ = costs.compare_to_baseline([], kv, base)
    assert any("no longer produced" in r for r in regs)
    regs, notes = costs.compare_to_baseline([], kv, base, skipped=["prog"])
    assert regs == [] and any("skipped" in n for n in notes)
    regs, _ = costs.compare_to_baseline([_tiny_report(), _tiny_report(name="new")], kv, base)
    assert any("new" in r and "baseline" in r for r in regs)


def test_canary_one_extra_buffer_is_detected(monkeypatch, capsys):
    """A pool step that keeps one extra copy of the pool alive (the
    stashed-for-a-rollback-never-freed bug) fails the checked-in peak
    budget, and the CLI exits 1."""
    from transformer_tpu_torch.serve import scheduler as sched

    real = sched._pool_step

    def leaky(params, pools, toks, index, cfg):
        logits = real(params, pools, toks, index, cfg)
        return logits, [{k: v.clone() for k, v in layer.items()
                         if isinstance(v, torch.Tensor)} for layer in pools]

    monkeypatch.setattr(sched, "_pool_step", leaky)
    assert analysis_main(["costs", "--format", "json"]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert any("serve.pool_step[lm_bf16]" in x and "peak_bytes" in x
               for x in payload["regressions"]), payload["regressions"]


def test_canary_unfused_paged_flash_step_is_detected(monkeypatch, capsys):
    """A paged_flash step whose kernels fell back to their plain versions
    (the gathered rows materialised per layer) no longer moves fewer bytes
    than the gathered-view step: the structural gate fails the CLI."""
    from transformer_tpu_torch.models import paged_decode

    real = paged_decode.paged_decode_forward

    def unfused(*args, **kw):
        return real(*args, **kw, reference=True)

    monkeypatch.setattr(paged_decode, "paged_decode_forward", unfused)
    assert analysis_main(["costs", "--format", "json"]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert any("no longer eliminates" in x for x in payload["regressions"]), (
        payload["regressions"])


def test_cli_costs_exit_codes_and_json(tmp_path, capsys, canned):
    assert analysis_main(["costs", "--format", "json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["ok"] is True and payload["regressions"] == []
    assert {p["name"] for p in payload["programs"]} >= {
        "serve.pool_step[lm_bf16]", "train.step[lm_bf16]",
        "serve.pool_step_paged_flash[lm_bf16]"}
    assert payload["skipped"] == list(costs.SHARDED_PROGRAMS)
    assert payload["kv_cache"]["lm_bf16"]["bytes_per_slot"] == 4096
    reports, _ = canned
    tight = str(tmp_path / "tight.json")
    costs.write_costs_baseline(reports, costs.kv_budgets(), tight)
    data = json.load(open(tight))
    data["programs"]["train.step[lm_bf16]"]["peak_bytes"] -= 1
    json.dump(data, open(tight, "w"))
    assert analysis_main(["costs", "--baseline", tight]) == 1
    assert "REGRESSION: train.step[lm_bf16]: peak_bytes" in capsys.readouterr().out
    fresh = str(tmp_path / "fresh.json")
    assert analysis_main(["costs", "--baseline", fresh, "--update-baseline"]) == 0
    assert "budgeted 15 program(s) + 7 kv variant(s)" in capsys.readouterr().out
    assert costs.load_costs_baseline(fresh) == costs.load_costs_baseline(
        costs.default_costs_baseline_path())


@pytest.mark.parametrize("cmd", ["rules", "concurrency", "sharding", "kernels", "all",
                                 "schedules", "contracts"])
def test_cli_refuses_unported_subcommands(cmd, capsys):
    assert analysis_main([cmd]) == 2
    assert "not ported yet" in capsys.readouterr().err


# --------------------------------------------------------------------------
# the trainer's prediction and summarize's measured/predicted line


def _tiny_trainer_fit(tmp_path, cfg, train_cfg):
    from transformer_tpu_torch.obs import EventLog, Telemetry
    from transformer_tpu_torch.train.state import create_train_state
    from transformer_tpu_torch.train.trainer import Trainer

    state = create_train_state(cfg, train_cfg, generator=torch.Generator().manual_seed(0),
                               device="cpu")
    log = tmp_path / "events.jsonl"
    telemetry = Telemetry(events=EventLog(str(log)), interval=0.0)
    trainer = Trainer(cfg, train_cfg, state, telemetry=telemetry, log_fn=lambda *_: None)
    B, L = train_cfg.batch_size, train_cfg.sequence_length

    class DS:
        def __len__(self):
            return 2

        def batches(self, epoch):
            r = np.random.default_rng(epoch)
            for _ in range(2):
                ids = r.integers(1, cfg.target_vocab_size, size=(B, L)).astype(np.int32)
                yield ids, ids

    trainer.fit(DS())
    trainer.fit(DS())  # a second fit on the same Trainer predicts nothing more
    telemetry.close()
    return telemetry, str(log)


@pytest.mark.parametrize("flash", [False, True])
def test_trainer_emits_prediction(tmp_path, flash):
    """A telemetry-enabled fit leaves one train.predicted whose numbers are
    ``train_step_costs`` run directly on the same config (with flash and
    remat: the three kernels priced, the recompute's forward counted
    again)."""
    from transformer_tpu_torch.obs import read_events

    cfg = FAST_MATRIX["lm_bf16"]
    if flash:
        cfg = dataclasses.replace(cfg, attention_impl="flash", remat=True, dtype="float32")
    telemetry, log = _tiny_trainer_fit(tmp_path, cfg, TINY_TRAIN)
    events = [e for e in read_events(log) if e["kind"] == "train.predicted"]
    assert len(events) == 1
    want = costs.train_step_costs(cfg, TINY_TRAIN)
    assert events[0]["program"] == "train_step"
    assert (events[0]["peak_bytes"], events[0]["flops"], events[0]["bytes_moved"]) == (
        want.peak_bytes, want.flops, want.bytes_moved)
    assert events[0]["tokens_per_step"] == TINY_TRAIN.batch_size * TINY_TRAIN.sequence_length
    assert telemetry.registry.snapshot()["train_predicted_peak_bytes"] == want.peak_bytes
    # the prediction holds at least the state the step updates in place
    state_bytes = 3 * sum(t.numel() * t.element_size()
                          for t in costs._tensors(costs.abstract_params(cfg)))
    assert want.peak_bytes >= state_bytes
    if flash:
        kernels = want.extras["kernels"]
        layers = cfg.num_layers
        assert {k: v["calls"] for k, v in kernels.items()} == {
            "flash_fwd": 2 * layers, "flash_dq": layers, "flash_dkdv": layers}


def test_trainer_prediction_is_advisory(tmp_path, monkeypatch):
    """A config the cost model cannot trace logs the JAX trainer's line and
    training goes on."""
    lines = []
    from transformer_tpu_torch.obs import EventLog, Telemetry, read_events
    from transformer_tpu_torch.train.state import create_train_state
    from transformer_tpu_torch.train.trainer import Trainer

    def broken(*_a, **_k):
        raise RuntimeError("untraceable")

    monkeypatch.setattr(costs, "train_step_costs", broken)
    cfg = FAST_MATRIX["lm_bf16"]
    state = create_train_state(cfg, TINY_TRAIN, generator=torch.Generator().manual_seed(0),
                               device="cpu")
    telemetry = Telemetry(events=EventLog(str(tmp_path / "e.jsonl")), interval=0.0)
    trainer = Trainer(cfg, TINY_TRAIN, state, telemetry=telemetry, log_fn=lines.append)
    trainer._emit_cost_prediction()
    telemetry.close()
    assert any("cost-model prediction unavailable (RuntimeError: untraceable)" in x
               for x in lines)
    assert not [e for e in read_events(str(tmp_path / "e.jsonl"))
                if e["kind"] == "train.predicted"]


def test_summarize_memory_vs_prediction():
    from transformer_tpu_torch.obs.__main__ import render_text, summarize_events

    events = [
        {"kind": "train.predicted", "ts": 1.0, "program": "train_step",
         "peak_bytes": 1000, "flops": 5000, "bytes_moved": 2000, "tokens_per_step": 16},
        {"kind": "train.memory", "ts": 2.0,
         "devices": {"0": {"bytes_in_use": 900, "peak_bytes_in_use": 1500}}},
    ]
    rep = summarize_events(events)
    pred = rep["train"]["predicted"]
    assert pred["measured_peak_bytes"] == 1500
    assert pred["measured_over_predicted"] == 1.5
    assert "measured/predicted 1.5x" in render_text(rep)
    only_pred = summarize_events(events[:1])["train"]["predicted"]
    assert "measured_peak_bytes" not in only_pred
    only_mem = summarize_events(events[1:])["train"]
    assert "predicted" not in only_mem and only_mem["memory"]
