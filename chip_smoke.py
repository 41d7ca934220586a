#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It needs a CUDA device and nvcc, builds
the port's kernels from ``transformer_tpu_torch/csrc``, and exits non-zero
if anything fails (with no CUDA device it exits non-zero at once: nothing
runs on the CPU). It prints one JSON line per check, in four phases:

1. device: the card, its power limit, and the matmul precision settings;
2. build: both CUDA kernels compiled with nvcc (seconds, ptxas report);
3. kernels: each kernel against its plain PyTorch version on the card at
   long4k shapes, with its time, the plain version's time, one library
   call's time, and the least time the card could take (bound);
4. main path: a long4k-width decoder-only LM (random weights from a seed,
   written as an export) serves JSONL requests through
   ``transformer_tpu_torch.cli.serve`` with the paged KV pool; both kernels'
   launch counters must equal layers x decode forwards. Then a few decode
   forwards at fp32 compare the kernels with their plain versions, and a
   profiled window of decode steps shows where a step's time goes.

Before the last line it prints the card's name and power limit (as
nvidia-smi reports them) and a ``{"kernels": [...]}`` summary; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, no sparsity
# Kernel B is held to a relative limit: the largest, over every (sequence,
# query row, head), of ||got - want|| / ||want|| across head_dim. Its
# outputs shrink as 1/sqrt(length), so an absolute limit that fits short
# rows cannot see a fault in long ones. Kernels A and the fp32 logits are
# held to absolute limits (their outputs are O(1) LayerNorm outputs and
# logits).
TOL = {"paged_attention": 2e-2, "fused_ln_ffn": 5e-2, "logits_fp32": 2e-3}
BUILD_DIR = os.path.join(ROOT, "build")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn()`` in ms: CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions


def paged_case(s_q, h, h_kv, lengths, quant, nmax=None, d=64, block=16):
    """A pool with random contents (stale rows hold data the mask must
    hide) and a fragmented table: each sequence's blocks are scattered
    over the pool in random order; unused entries point at sink block 0."""
    import numpy as np
    import torch

    from transformer_tpu_torch.ops.attention import _quantize_kv

    rng = np.random.default_rng(SEED)
    n = len(lengths)
    need = [math.ceil(L / block) for L in lengths]
    nmax = nmax or max(need)
    nb = 1 + sum(need) + 8
    perm = rng.permutation(np.arange(1, nb)).tolist()
    table = np.zeros((n, nmax), np.int32)
    for i, k in enumerate(need):
        table[i, :k] = [perm.pop() for _ in range(k)]
    dev = "cuda"
    kf = torch.from_numpy(rng.standard_normal((nb, block, h_kv, d), np.float32)).to(dev)
    vf = torch.from_numpy(rng.standard_normal((nb, block, h_kv, d), np.float32)).to(dev)
    q = torch.from_numpy(rng.standard_normal((n, s_q, h, d), np.float32)).to(dev, torch.bfloat16)
    extra = {}
    if quant:
        k, ks = _quantize_kv(kf)
        v, vs = _quantize_kv(vf)
        extra = {"k_scale": ks, "v_scale": vs}
    else:
        k, v = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
    return (
        q, k, v, torch.from_numpy(table).to(dev),
        torch.tensor(lengths, dtype=torch.int32, device=dev), extra,
    )


def row_rel_err(got, want):
    """Per sequence: the largest, over its query rows and heads, of
    ||got - want|| / ||want|| taken across head_dim."""
    diff = (got.float() - want.float()).norm(dim=-1)
    ref = want.float().norm(dim=-1).clamp_min(1e-30)
    return (diff / ref).amax(dim=(1, 2))


def drop_first_block(table, lens, s_q, block=16):
    """The input a kernel that skips each sequence's first block would see
    as exact: the table shifted left by one entry and the length cut by one
    block, for every sequence whose query rows all follow that block.
    Returns the new table, lengths and the mask of sequences changed."""
    import torch

    hit = lens > block + s_q
    shifted = torch.cat([table[:, 1:], torch.zeros_like(table[:, :1])], dim=1)
    return (
        torch.where(hit[:, None], shifted, table),
        torch.where(hit, lens - block, lens),
        hit,
    )


def check_paged_attention(label, s_q, h, h_kv, lengths, quant, nmax=None):
    import torch
    import torch.nn.functional as F

    from transformer_tpu_torch.kernels.kv_pool import gather_block_views
    from transformer_tpu_torch.kernels.paged_flash import (
        paged_flash_attention,
        paged_flash_attention_plain,
    )

    lengths = [max(L, s_q) for L in lengths]
    n = len(lengths)
    q, k, v, table, lens, extra = paged_case(s_q, h, h_kv, lengths, quant, nmax)
    got = paged_flash_attention(q, k, v, table, lens, **extra)
    want = paged_flash_attention_plain(q, k, v, table, lens, **extra)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    rel = row_rel_err(got, want).max().item()
    # What the limit is up against: the plain version with one block of
    # every long sequence dropped, read by the same measure. The weakest
    # sequence's reading must clear the limit, or the check could not see
    # such a fault.
    f_table, f_lens, hit = drop_first_block(table, lens, s_q)
    fault = paged_flash_attention_plain(q, k, v, f_table, f_lens, **extra)
    fault_rel = row_rel_err(fault, want)[hit].min().item()
    tol = TOL["paged_attention"]
    ok = bool(torch.isfinite(got).all().item()) and rel <= tol < fault_rel
    ms = cuda_ms(lambda: paged_flash_attention(q, k, v, table, lens, **extra))
    plain_ms = cuda_ms(lambda: paged_flash_attention_plain(q, k, v, table, lens, **extra), iters=10)
    # Library yardstick: one SDPA call over the gathered (dequantised) view,
    # prepared outside the timed region.
    kg = gather_block_views(k, table)
    vg = gather_block_views(v, table)
    if quant:
        kg = kg.to(q.dtype) * gather_block_views(extra["k_scale"], table).to(q.dtype)
        vg = vg.to(q.dtype) * gather_block_views(extra["v_scale"], table).to(q.dtype)
    L = kg.shape[1]
    q_pos = (lens.long()[:, None] - s_q) + torch.arange(s_q, device="cuda")
    mask = (torch.arange(L, device="cuda")[None, None, :] <= q_pos[:, :, None])[:, None]
    qt, kt, vt = q.transpose(1, 2), kg.transpose(1, 2).contiguous(), vg.transpose(1, 2).contiguous()
    gqa = {"enable_gqa": True} if h != h_kv else {}
    library_ms = cuda_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, **gqa)
    )
    d = q.shape[-1]
    kv_elem = 1 if quant else 2
    rows = sum(lengths)
    nbytes = (
        2 * q.numel() * 2  # q read, out written (bf16)
        + 2 * rows * h_kv * d * kv_elem  # visible K and V rows
        + (2 * rows * h_kv * 4 if quant else 0)  # their scales
        + sum(math.ceil(L / 16) for L in lengths) * 4 + 4 * n  # table, lengths
    )
    visible = sum(L - s_q + i + 1 for L in lengths for i in range(s_q))
    flops = 4.0 * d * h * visible
    b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
    rec = {
        "phase": "kernels", "kernel": "paged_attention", "case": label,
        "n": n, "s_q": s_q, "h": h, "h_kv": h_kv, "d": d, "block": 16,
        "nmax": int(table.shape[1]), "pool": "int8" if quant else "bfloat16",
        "lengths": lengths, "max_abs_err": err, "max_rel_err": rel,
        "tolerance_rel": tol, "planted_fault_min_rel_err": fault_rel,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": b_ms, "bound_us": b_ms * 1e3, "bound_by": b_by,
        "share_of_bound": b_ms / ms, "ok": ok,
    }
    emit(rec)
    if not ok:
        raise SystemExit(
            f"paged_attention {label}: max relative err {rel}, planted fault "
            f"{fault_rel} (tolerance {tol})"
        )
    return rec


def check_fused_ln_ffn(label, m, activation, norm_scheme, d=512, dff=2048):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from transformer_tpu_torch.config import is_gated
    from transformer_tpu_torch.ops.ffn import fused_ln_ffn, fused_ln_ffn_plain

    rng = np.random.default_rng(SEED + m)
    dt = torch.bfloat16

    def t(shape, scale=1.0, offset=0.0):
        a = rng.standard_normal(shape, np.float32) * scale + offset
        return torch.from_numpy(a).to("cuda", dt)

    lim = (6.0 / (d + dff)) ** 0.5
    ffn = {
        "in": {"kernel": t((d, dff), lim), "bias": t((dff,), 0.1)},
        "out": {"kernel": t((dff, d), lim), "bias": t((d,), 0.1)},
    }
    gated = is_gated(activation)
    if gated:
        ffn["gate"] = {"kernel": t((d, dff), lim), "bias": t((dff,), 0.1)}
    ln = {"scale": t((d,), 0.1, 1.0), "bias": t((d,), 0.1)}
    x = t((m, d))
    kw = dict(activation=activation, norm_scheme=norm_scheme, epsilon=1e-6)
    got = fused_ln_ffn(ln, ffn, x, **kw)
    want = fused_ln_ffn_plain(ln, ffn, x, **kw)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ok = bool(torch.isfinite(got).all().item()) and err <= TOL["fused_ln_ffn"]
    ms = cuda_ms(lambda: fused_ln_ffn(ln, ffn, x, **kw))
    plain_ms = cuda_ms(lambda: fused_ln_ffn_plain(ln, ffn, x, **kw), iters=20)
    # Library yardstick: the F.layer_norm + F.linear chain.
    w_in_t = ffn["in"]["kernel"].t().contiguous()
    w_out_t = ffn["out"]["kernel"].t().contiguous()
    w_gate_t = ffn["gate"]["kernel"].t().contiguous() if gated else None
    act = {
        "relu": F.relu, "gelu": lambda z: F.gelu(z, approximate="tanh"), "silu": F.silu,
        "reglu": F.relu, "geglu": lambda z: F.gelu(z, approximate="tanh"), "swiglu": F.silu,
    }[activation]

    def library():
        h = F.layer_norm(x, (d,), ln["scale"], ln["bias"], 1e-6) if norm_scheme == "pre" else x
        u = F.linear(h, w_in_t, ffn["in"]["bias"])
        z = act(F.linear(h, w_gate_t, ffn["gate"]["bias"])) * u if gated else act(u)
        y = x + F.linear(z, w_out_t, ffn["out"]["bias"])
        return y if norm_scheme == "pre" else F.layer_norm(y, (d,), ln["scale"], ln["bias"], 1e-6)

    library_ms = cuda_ms(library)
    mats = 3 if gated else 2
    nbytes = 2 * (2 * m * d + mats * d * dff + (mats - 1) * dff + d + 2 * d)
    flops = 2.0 * m * d * dff * mats
    b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
    rec = {
        "phase": "kernels", "kernel": "fused_ln_ffn", "case": label,
        "m": m, "d": d, "dff": dff, "activation": activation,
        "norm_scheme": norm_scheme, "dtype": "bfloat16",
        "max_abs_err": err, "tolerance": TOL["fused_ln_ffn"],
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": b_ms, "bound_us": b_ms * 1e3, "bound_by": b_by,
        "share_of_bound": b_ms / ms, "ok": ok,
    }
    emit(rec)
    if not ok:
        raise SystemExit(f"fused_ln_ffn {label}: max abs err {err} (tolerance {TOL['fused_ln_ffn']})")
    return rec


# --------------------------------------------------------------------------
# phase 4: the main path


def long4k_config(vocab_size: int, **overrides):
    """The repo's long4k preset (transformer_tpu/cli/flags.py) at full
    width: 6 layers, d_model 512, 8 heads, dff 2048, max_position 4096,
    post-LN, sinusoidal, relu, bf16; dropout off for serving."""
    from transformer_tpu_torch.config import ModelConfig

    return ModelConfig(
        num_layers=6, d_model=512, num_heads=8, dff=2048,
        input_vocab_size=vocab_size, target_vocab_size=vocab_size,
        max_position=4096, decoder_only=True, attention_impl="flash",
        remat=True, dropout_rate=0.0, **overrides,
    )


def vocab(target_size: int = 2**15):
    """The port's tokenizer built from data/tgt-train.txt at the CLI's
    default target size, cached under build/vocab/."""
    from transformer_tpu_torch.data.tokenizer import SubwordTokenizer, iter_lines

    path = os.path.join(BUILD_DIR, "vocab", f"tgt-train-{target_size}.subwords")
    t0 = time.perf_counter()
    if os.path.exists(path):
        tok, built = SubwordTokenizer.load(path), False
    else:
        tok = SubwordTokenizer.build_from_corpus(
            iter_lines(os.path.join(ROOT, "data", "tgt-train.txt")),
            target_vocab_size=target_size,
        )
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tok.save(path)
        built = True
    emit({
        "phase": "main", "step": "vocab", "target_size": target_size,
        "subwords": len(tok.subwords), "model_vocab": tok.model_vocab_size,
        "built": built, "seconds": time.perf_counter() - t0, "path": path,
    })
    return tok, path


def make_requests(tok) -> list[dict]:
    """14 requests over real sentences (data/tgt-test.txt): prompt lengths
    from 9 to ~1000 tokens, max_new up to 64, two of them sampled."""
    with open(os.path.join(ROOT, "data", "tgt-test.txt"), encoding="utf-8") as f:
        words = f.read().split()
    lengths = [1000, 24, 310, 700, 9, 130, 520, 64, 880, 200, 40, 450, 75, 960]
    max_new = [64, 16, 48, 32, 8, 64, 24, 40, 64, 12, 56, 20, 64, 30]
    reqs, start = [], 0
    for i, (L, mn) in enumerate(zip(lengths, max_new)):
        prompt = []
        while len(tok.encode(" ".join(prompt))) < L - 1:
            prompt.append(words[start % len(words)])
            start += 1
        req = {"prompt": " ".join(prompt), "max_new": mn}
        if i in (3, 7):
            req.update(temperature=0.8, top_k=40, top_p=0.95, seed=i)
        reqs.append(req)
    return reqs


def main_path(tok, vocab_path):
    import torch

    from transformer_tpu_torch.cli import serve
    from transformer_tpu_torch.convert import export_params
    from transformer_tpu_torch.kernels.paged_flash import paged_flash_attention
    from transformer_tpu_torch.models.transformer import init_params
    from transformer_tpu_torch.ops.ffn import fused_ln_ffn

    cfg = long4k_config(tok.model_vocab_size)
    export = os.path.join(BUILD_DIR, "smoke_export")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator().manual_seed(SEED), device="cuda")
    export_params(params, cfg, export)
    del params
    emit({
        "phase": "main", "step": "export", "path": export,
        "config": dataclasses.asdict(cfg), "seconds": time.perf_counter() - t0,
    })
    reqs = make_requests(tok)
    lines = "".join(json.dumps(r) + "\n" for r in reqs)
    argv = [
        "--export_path", export, "--tgt_vocab_file", vocab_path,
        "--serve_slots", "4", "--prefix_block", "16", "--prefill_chunk", "64",
        "--device", "cuda",
    ]
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    paged_flash_attention.launches = 0
    fused_ln_ffn.launches = 0
    t0 = time.perf_counter()
    sched = serve.main(argv, stdin=io.StringIO(lines), stdout=out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {
        "paged_attention": paged_flash_attention.launches,
        "fused_ln_ffn": fused_ln_ffn.launches,
    }
    answers = [json.loads(line) for line in out.getvalue().splitlines()]
    st = sched.stats
    forwards = st["steps"]
    want = cfg.num_layers * forwards
    rec = {
        "phase": "main", "step": "serve", "argv": argv, "requests": len(reqs),
        "answers": len(answers),
        "errors": [a for a in answers if "error" in a],
        "prompt_tokens": [len(tok.encode(r["prompt"])) + 1 for r in reqs],
        "launches": launches, "decode_forwards": forwards,
        "expected_launches": want, "max_active": st["max_active"],
        "decode_step_ms": st["decode_s"] / max(1, forwards) * 1e3,
        "prefill_ms_per_token": st["prefill_s"] / max(1, st["prefill_tokens"]) * 1e3,
        "prefill_tokens": st["prefill_tokens"],
        "generated_tokens": st["generated_tokens"],
        "tokens_per_s": st["generated_tokens"] / wall,
        "serve_wall_s": wall,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    }
    emit(rec)
    if len(answers) != len(reqs) or rec["errors"]:
        raise SystemExit(f"serving failed: {len(answers)} answers, errors {rec['errors']}")
    if not any(a["continuation"] for a in answers):
        raise SystemExit("serving produced only empty continuations")
    for name, count in launches.items():
        if count <= 0 or count != want:
            raise SystemExit(f"{name} launched {count} times, expected {want}")
    return cfg, export, reqs, launches


def fp32_decode_check(cfg, export, tok, reqs, steps: int = 4):
    """The same model at fp32: admit four prompts, then for a few decode
    forwards compare the kernels' logits with the plain versions' on the
    same pool state."""
    import torch

    from transformer_tpu_torch.convert import load_export
    from transformer_tpu_torch.models.paged_decode import paged_decode_forward
    from transformer_tpu_torch.serve.scheduler import ContinuousScheduler

    params, _ = load_export(export, device="cuda")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    sched = ContinuousScheduler(
        params, cfg32, tok, num_slots=4, prefill_chunk=64, kv_block=16,
        device="cuda",
    )
    for r in reqs[:4]:
        sched.submit({"prompt": r["prompt"], "max_new": 64})
    sched.admit()
    worst, agree, total = 0.0, 0, 0
    for _ in range(steps):
        slots = sorted(sched._active)
        toks = torch.zeros((4, 1), dtype=torch.long, device="cuda")
        index = torch.zeros((4,), dtype=torch.int32, device="cuda")
        for s in slots:
            sched.alloc.ensure(s, sched._active[s].pos + 1)
            toks[s, 0] = sched._active[s].cur
            index[s] = sched._active[s].pos
        table = sched.alloc.table_device("cuda")
        ref_pools = [{k: v.clone() for k, v in p.items()} for p in sched.pools]
        got_pools = [{k: v.clone() for k, v in p.items()} for p in sched.pools]
        got, _ = paged_decode_forward(
            sched.params, toks, got_pools, table, index, cfg32, block_tokens=16
        )
        want, _ = paged_decode_forward(
            sched.params, toks, ref_pools, table, index, cfg32, block_tokens=16,
            reference=True,
        )
        rows = torch.tensor(slots, device="cuda")
        g, w = got[rows, 0].float(), want[rows, 0].float()
        worst = max(worst, (g - w).abs().max().item())
        agree += int((g.argmax(-1) == w.argmax(-1)).sum().item())
        total += len(slots)
        sched.step()
    rec = {
        "phase": "main", "step": "fp32_decode_check", "forwards": steps,
        "logits_max_abs_diff": worst, "tolerance": TOL["logits_fp32"],
        "greedy_agree": agree, "greedy_total": total,
    }
    emit(rec)
    if not worst <= TOL["logits_fp32"] or agree != total:
        raise SystemExit(f"fp32 decode check failed: {rec}")


def decode_profile(export, tok, reqs, steps: int = 20):
    """Where a main-path decode step's time goes: four slots busy with the
    longest prompts, ``steps`` decode steps timed on the host clock, then
    the same number under ``torch.profiler`` for device time by kernel.
    Device busy share = summed kernel time / unprofiled wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from transformer_tpu_torch.convert import load_export
    from transformer_tpu_torch.serve.scheduler import ContinuousScheduler

    params, cfg = load_export(export, device="cuda")
    sched = ContinuousScheduler(
        params, cfg, tok, num_slots=4, prefill_chunk=64, kv_block=16, device="cuda"
    )
    longest = sorted(reqs, key=lambda r: -len(r["prompt"]))[:4]
    for r in longest:
        sched.submit({"prompt": r["prompt"], "max_new": 64})
    sched.admit()
    for _ in range(5):
        sched.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        sched.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            sched.step()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # Kernels only: an aten op's own entry repeats the time of the kernels
    # it launched.
    events = [
        e for e in prof.key_averages()
        if str(getattr(e, "device_type", "")).endswith("CUDA") and dev_us(e) > 0
    ]
    device_ms = sum(dev_us(e) for e in events) / steps / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:8]
    rec = {
        "phase": "main", "step": "decode_profile", "steps": steps, "slots_busy": 4,
        "positions": sorted(st.pos for st in sched._active.values()),
        "wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms if events else "not measured",
        "device_busy_share": device_ms / wall_ms if events else "not measured",
        "top_kernels": [
            {"name": e.key[:80], "ms_per_step": dev_us(e) / steps / 1e3,
             "calls_per_step": e.count / steps}
            for e in top
        ],
    }
    emit(rec)
    return rec


# --------------------------------------------------------------------------


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing runs on the CPU", file=sys.stderr)
        return 1
    try:
        from transformer_tpu_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e}); run from a checkout",
              file=sys.stderr)
        return 1

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = nvidia_smi_line()
    emit({
        "phase": "device", "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "nvidia_smi": smi,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "matmul_allow_bf16_reduced_precision_reduction":
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
    })

    # 2. build
    t0 = time.perf_counter()
    reports = build.build(["paged_attention", "fused_ln_ffn"])
    emit({
        "phase": "build", "seconds": time.perf_counter() - t0,
        "ptxas": {
            name: [ln.strip() for ln in rep.splitlines()
                   if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
            for name, rep in reports.items()
        },
    })

    # 3. kernels against their plain versions, long4k shapes
    spread = [1, 100, 517, 1024, 1700, 2048, 3001, 4096]
    b_recs = []
    for s_q in (1, 4):
        b_recs.append(check_paged_attention(f"bf16 s_q={s_q}", s_q, 8, 8, spread, False))
        b_recs.append(check_paged_attention(f"int8 s_q={s_q}", s_q, 8, 8, spread, True))
        b_recs.append(check_paged_attention(f"gqa h_kv=2 s_q={s_q}", s_q, 8, 2, spread, False))
    # The main path's shape: 4 slots, one decode row, table width 257
    # (serve_max_total 4097 / 16-token blocks), prompt-scale lengths.
    b_main = check_paged_attention("main path", 1, 8, 8, [1001, 311, 701, 131], False, nmax=257)
    a_recs = []
    for m in (1, 8, 64):
        a_recs.append(check_fused_ln_ffn(f"relu post m={m}", m, "relu", "post"))
        a_recs.append(check_fused_ln_ffn(f"swiglu pre m={m}", m, "swiglu", "pre"))
        a_recs.append(check_fused_ln_ffn(f"gelu pre m={m}", m, "gelu", "pre"))
    a_main = check_fused_ln_ffn("main path", 4, "relu", "post")

    # 4. main path
    tok, vocab_path = vocab()
    cfg, export, reqs, launches = main_path(tok, vocab_path)
    fp32_decode_check(cfg, export, tok, reqs)
    decode_profile(export, tok, reqs)

    def summary(name, main_rec, recs, replaces):
        return {
            "name": name, "route": "cuda",
            "source": f"transformer_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in recs + [main_rec]),
            "max_err": max(r["max_abs_err"] for r in recs + [main_rec]),
            "max_rel_err": max(r["max_rel_err"] for r in recs + [main_rec])
            if name == "paged_attention" else None,
            "tolerance": TOL[name],
            "tolerance_on": "max_rel_err" if name == "paged_attention" else "max_abs_err",
            "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"], "bound_us": main_rec["bound_us"],
            "bound_by": main_rec["bound_by"], "library_ms": main_rec["library_ms"],
            "share_of_bound": main_rec["share_of_bound"],
        }

    print(smi, flush=True)
    emit({"kernels": [
        summary("paged_attention", b_main, b_recs,
                "transformer_tpu/kernels/paged_flash.py:62 _paged_kernel"),
        summary("fused_ln_ffn", a_main, a_recs,
                "transformer_tpu/ops/ffn.py:112 _fused_kernel"),
    ]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
