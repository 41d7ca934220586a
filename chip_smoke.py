#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It needs a CUDA device and nvcc, builds
the port's kernels from ``transformer_tpu_torch/csrc``, and exits non-zero
if anything fails (with no CUDA device it exits non-zero at once: nothing
runs on the CPU). It prints one JSON line per check, in nine phases:

1. device: the card, its power limit, and the matmul precision settings;
2. build: the three CUDA sources compiled with nvcc in parallel (seconds,
   ptxas report), and each kernel's count of HGMMA (warpgroup MMA)
   instructions in its SASS (``cuobjdump -sass``): the bf16 flash forward,
   ring step, dQ and dK/dV kernels must have some at head_dim 32 and 64,
   every other kernel none (the two paged attention kernels and kernel A,
   which runs on the CUDA cores, included);
3. kernels: each kernel against its plain PyTorch version on the card at
   long4k shapes, with its time, the plain version's time, one library
   call's time, and the least time the card could take (bound). Two
   timers: ``cuda_ms`` (CUDA events around back-to-back Python calls: for
   a kernel of a few microseconds that is the host's time per call) for
   every kernel, and ``cuda_graph_ms`` (the calls captured in one CUDA
   graph and its replay timed: device time only) for kernels A and B and
   their library calls, whose share of the bound is taken from it. Kernel A
   and its library chain are also timed cold: the graph's calls cycle
   through 16 copies of the weights, more than the 50 MB L2 holds, and A's
   share of the bound is taken from that time; A also reads a planted
   fault (the plain version with one CTA's dff slab of W_out dropped). Kernel
   B also runs at its split edges (lengths of one split, one split + 1, 1;
   S_q rows straddling a split's end; a 257-entry table with every length
   under one split, so most CTAs are empty; int8 and GQA). The flash
   kernels also read two planted faults (the plain versions with a causal
   off-by-one, and the backward ones with the last 10 query rows left
   out) by the same measures, which must clear the limits; the backward
   kernels also run with a band apart from causality (+256, 0, -100); bf16
   cases at the tensor-core kernels' edges (head_dim 32, S 1 / 63 / 129,
   GQA with a group of 4, padding that leaves the first rows no key); the
   ring step reads its own two planted faults (no rescaling of acc when the
   maximum moves, 10 rows of a tile unfolded), and also runs from a fresh
   carry with a band of -100, where the rows that see no key must keep m =
   -1e30, l = 0 and acc = 0 bit for bit; and a ring of 4 is replayed
   in one process at the main shape against the whole-sequence kernels;
4. serving: a long4k-width decoder-only LM (random weights from a seed,
   written as an export) serves JSONL requests through
   ``transformer_tpu_torch.cli.serve`` with the paged KV pool; both decode
   kernels' launch counters must equal layers x decode forwards. Then a
   few decode forwards at fp32 compare the kernels with their plain
   versions, and a profiled window of decode steps shows where a step's
   time goes;
5. training: ``transformer_tpu_torch.cli.train --preset long4k --epochs 1``
   on the bundled corpus at full width; the three flash kernels' launch
   counters must equal the count that steps and eval batches imply, the
   losses must be finite and the export must load back. Then one fp32
   train step at full width (2 layers) compares the kernels with their
   plain versions, and a profiled window of train steps shows where a
   step's time goes;
6. seq2seq: the flash kernels at the seq2seq shapes (B 64, S 64, 8 x 64:
   the encoder's non-causal self-attention over ragged key lengths with a
   row of PAD only, whose rows must come back with out = 0, lse = MASKED
   and zero gradients exactly; the decoder's causal S 63; the big and tiny
   presets' encoders; the length buckets' widths, encoder S 16 / 32 / 48
   and causal decoder S 15 / 31 / 47), bf16 and fp32, each with a planted
   fault (the first real key of every sequence taken for padding, where
   not causal); then
   ``transformer_tpu_torch.cli.train --preset base --attention_impl flash
   --sequence_length 64 --epochs 1`` (Transformer-base at full width on the
   bundled corpus), whose flash counters must equal 12 launches of each
   kernel a train step, 12 forward launches an eval batch and 6 a
   translate call of the epilogue's sample translation and BLEU on 200
   test pairs; a profiled window of its train steps; one fp32 train step
   (2 + 2 layers) kernels against plain versions; ``cli.translate``
   greedy and ``--beam 4`` and ``cli.evaluate --limit 200`` on the export
   (its JSON line printed); greedy and beam-4 tokens with the flash encoder
   and its plain version at fp32 (2 + 2 layers), which must be identical;
   and the tiny, big and tied presets for an epoch of 1280 pairs;
7. sequence-parallel training: ``torch.distributed.run`` starts four
   processes of ``transformer_tpu_torch.cli.distributed_train --preset
   long4k --attention_impl ring --sp 4 --epochs 1`` on this one card (gloo,
   staged through host memory); the counters of the ring step and both
   backward kernels must equal what steps, hops and eval batches imply, the
   losses must be within 0.01 of phase 5's, and every rank's parameters
   and the export must be bit-identical. Then one fp32 step at full width
   (2 layers) over a ring of four processes compares with the
   single-process flash step;
8. checkpoints: ``cli.train --preset base --attention_impl flash
   --sequence_length 64 --grad_accum 2`` on the first 1,300 corpus pairs
   (20 steps an epoch), each run with its own ``--ckpt_path``: U trains 2
   epochs; R trains 1, then is relaunched for 2 on the same path and must
   log the restore and ``resuming at epoch 2/2 (step 20)`` and end with
   U's parameters bit for bit (else U runs again and R is held to the
   U-to-U spread); every run's flash counters must equal 24 launches of
   each kernel a step (12 per micro-step), 12 forward launches an eval
   batch and 6 for the sample translation. P runs U's flags with
   ``--async_checkpoint`` in a subprocess that gets SIGTERM once it logs
   the end of epoch 1: its log must name a step S in epoch 2 whose
   checkpoint verifies against its manifest, a relaunch must resume at
   epoch 2 and end at S + 20, and after one byte of the newest arrays.npz
   is flipped the next relaunch must fall back to S. Then the save stall
   (sync and async), the async write's time to durable, restore + verify
   and the checkpoint's bytes at full width; ``cli.export --average_last 2
   --quantize int8`` from R, every leaf within half a quantization step
   of the fp32 average and the file under 1/2.5 of fp32's;
   ``cli.translate`` (greedy, 8 sentences) and ``cli.evaluate --limit
   200`` on it; and one fp32 step (2 + 2 layers, B 64, kernels on) with
   ``--grad_accum 2`` against the whole batch, held to the fp32 step's
   limits;
9. dispatch: ``cli.train --preset base --attention_impl flash
   --sequence_length 64`` on the same 1,300 pairs: E 2 epochs at
   ``--steps_per_dispatch 1`` (eager steps), D the same at 8 (each step a
   replay of one captured CUDA graph): D must end with E's parameters bit
   for bit (else within 1e-6 of each leaf's largest value, the leaves
   named), with E's flash counters and one capture; RD 1 epoch at 8,
   relaunched to 2, must log the resume and end as D; BK one epoch at
   ``--length_buckets 16,32,48,64 --steps_per_dispatch 8``, one capture
   per width its epoch holds; then ``--preset long4k --remat_policy dots``
   at 1 and 4 steps a dispatch and full remat at 4, each bit for bit
   phase 5's full-remat export (peak memory above each run's start). Every run's counters are held as in phase 8 (long4k's as in
   phase 5). Each of E, D, BK and the dots runs reports step median, mean
   and first step, capture time per shape, real target tokens per
   second, peak allocated memory and a profiled window (one dispatch, or
   3 single steps): wall, device time, busy share and launch calls.

Every training run writes checkpoints to a fresh directory under
``build/ckpt/``, so no run restores another's.

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
import re
import shutil
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
# Flash kernels: ``out``, dq, dk and dv are each held to the largest, over
# (batch, row, head), of ||got - want|| / ||want|| across head_dim, so a
# fault inside one 64-row tile reads at full size (for the gradients the
# row norm is floored at 1e-2 of its head's RMS row norm: see grad_rel).
# bf16 ``out`` differs from the plain version by where p is rounded (running
# maxima against the row maximum); bf16 dQ and dK/dV recompute p from the
# same lse but sum on the tensor cores, in another order than the plain
# versions (fp32 dQ and dK/dV sum in the plain versions' order).
FLASH_TOL = {
    "bfloat16": {"out": 2e-2, "grad": 2e-2},
    "float32": {"out": 1e-4, "grad": 1e-4},
}
# The fp32 train step, kernels against plain versions: loss relative, and
# every gradient leaf's ||got - want|| / ||want|| (weight gradients sum
# many cancelling per-token terms, so the forward's ~1e-6 differences show
# up to ~1e-4 in them). The key biases' gradient
# is zero up to rounding (the softmax cancels a bias shared by a row's
# keys), so instead its norm must stay below 1e-3 of the query bias's in
# the same layer, on both sides.
TRAIN_TOL = {"loss_rel": 1e-5, "grad_rel": 1e-3, "key_bias_ratio": 1e-3}
FLASH_REPLACES = {
    "flash_fwd": "transformer_tpu/kernels/flash_attention.py:183 _fwd_kernel",
    "flash_dq": "transformer_tpu/kernels/flash_attention.py:451 _dq_kernel",
    "flash_dkdv": "transformer_tpu/kernels/flash_attention.py:490 _dkdv_kernel",
    "flash_ring_step": "transformer_tpu/kernels/flash_attention.py:298 _ring_step_kernel",
}
BUILD_DIR = os.path.join(ROOT, "build")
# Which timer each time of kernels A and B comes from.
TIMERS = {
    "ms": "cuda_ms: CUDA events around back-to-back Python calls (host-paced at these sizes)",
    "device_ms": "cuda_graph_ms: the calls captured in one CUDA graph, its replay timed",
    "library_ms": "cuda_ms", "library_device_ms": "cuda_graph_ms",
    "plain_ms": "cuda_ms", "share_of_bound": "bound_ms / device_ms",
}
# Kernel A is also timed cold: the graph's calls cycle through COLD_COPIES
# copies of the weights (16 x 4.2 MB at long4k, more than the 50 MB L2), so
# each call reads its weights from HBM, as a decode step's layers do.
COLD_COPIES = 16
TIMERS_A = {
    **TIMERS,
    "device_ms_cold": f"cuda_graph_ms, the calls cycling through {COLD_COPIES} weight copies",
    "library_device_ms_cold": "as device_ms_cold",
    "share_of_bound": "bound_ms / device_ms_cold", "share_of_bound_warm": "bound_ms / device_ms",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def fresh_dir(*parts) -> str:
    """``BUILD_DIR/<parts>``, emptied: every training run gets a checkpoint
    directory of its own, so no run restores another's (or an earlier
    call's) checkpoints."""
    path = os.path.join(BUILD_DIR, *parts)
    shutil.rmtree(path, ignore_errors=True)
    return path


def cut_corpus(pairs: int, test: int = 64) -> str:
    """A dataset directory with the first ``pairs`` train and ``test`` test
    pairs of the bundled corpus."""
    data = os.path.join(BUILD_DIR, f"corpus_{pairs}")
    os.makedirs(data, exist_ok=True)
    for split, n in (("train", pairs), ("test", test)):
        for side in ("src", "tgt"):
            with open(os.path.join(ROOT, "data", f"{side}-{split}.txt"), encoding="utf-8") as f:
                head = [next(f) for _ in range(n)]
            with open(os.path.join(data, f"{side}-{split}.txt"), "w", encoding="utf-8") as f:
                f.writelines(head)
    return data


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean time of ``fn()`` in ms: CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls. Device time while the device
    is the bottleneck; for a call whose kernels take a few microseconds it
    is the host's time per call (the device waits between launches)."""
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


def cuda_graph_ms(fn, iters: int = 50, replays: int = 10, warmup: int = 3) -> float:
    """Device-only time of ``fn()`` in ms: ``iters`` calls captured in one
    CUDA graph, whose replay is timed with CUDA events (the mean over
    ``replays`` replays after one untimed), so no host time between
    launches is in it. Inputs stay where the calls left them (in L2 when
    they fit), as for ``cuda_ms``."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up (build, load) off the capture
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * iters)
    del graph
    return ms


def kernel_us(fn, calls: int = 50) -> dict:
    """Mean device time per call of each kernel ``fn()`` launches, in us,
    from ``torch.profiler`` over ``calls`` calls after a warm-up (the
    profiler times each kernel on the device, whatever the host gaps)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            out[e.key[:90]] = us / calls
    return out or "not measured"


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------------
# phase 2: what was compiled


def cuda_tool(name: str) -> str | None:
    """A CUDA toolkit binary: on PATH, under /usr/local/cuda/bin, or the copy
    that Triton's package carries (triton/backends/nvidia/bin)."""
    import importlib.util

    found = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if os.path.exists(found):
        return found
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        alt = os.path.join(os.path.dirname(spec.origin), "backends", "nvidia", "bin", name)
        if os.path.exists(alt):
            return alt
    return None


def short_names(mangled: list[str]) -> dict[str, str]:
    """Mangled kernel names -> ``name<template args>`` through cu++filt
    (or c++filt), else unchanged."""
    tool = cuda_tool("cu++filt") or shutil.which("c++filt")
    if tool is None:
        return {m: m for m in mangled}
    out = subprocess.run([tool], input="\n".join(mangled), capture_output=True, text=True,
                         timeout=60).stdout.splitlines()
    if len(out) != len(mangled):
        return {m: m for m in mangled}

    def short(d):
        for noise in ("void ", "<unnamed>::", "(anonymous namespace)::", "(int)", "(bool)"):
            d = d.replace(noise, "")
        return d.split("(")[0]

    return {m: short(d) for m, d in zip(mangled, out)}


def sass_hgmma(names):
    """Each built kernel's count of HGMMA (warpgroup MMA) instructions in
    its SASS, from ``cuobjdump -sass``. The bf16 flash forward and ring
    step (``flash_fwd_kernel_wgmma<D, Carry>``), dQ and dK/dV kernels
    (``*_kernel_wgmma``) must issue some at head_dim 32 and 64, and every
    other kernel none: the paged attention split and merge kernels and
    kernel A, whose products run on the CUDA cores, included; without
    cuobjdump the counts are "not measured"."""
    from transformer_tpu_torch.kernels import build

    tool = cuda_tool("cuobjdump")
    if tool is None:
        rec = {"phase": "build", "step": "sass_hgmma", "hgmma_by_kernel": "not measured"}
        emit(rec)
        return rec
    counts: dict[str, int] = {}
    for name in names:
        out = subprocess.run([tool, "-sass", str(build._target(name)[1])], capture_output=True,
                             text=True, check=True, timeout=300).stdout
        fn = None
        for line in out.splitlines():
            m = re.match(r"\s*Function : (\S+)", line)
            if m:
                fn = m.group(1)
                counts[fn] = 0
            elif fn is not None and "HGMMA" in line:
                counts[fn] += 1
    wgmma = {fn for fn in counts if "_kernel_wgmma" in fn}
    # Mangled template instantiations: name<D> is "nameILi<D>E", and
    # flash_fwd_kernel_wgmma<D, Carry> "…ILi<D>ELb<0 or 1>E" (1: the ring step).
    need = [f"flash_fwd_kernel_wgmmaILi{d}ELb{carry}E" for carry in (0, 1) for d in (32, 64)]
    need += [f"{k}_kernel_wgmmaILi{d}E" for k in ("flash_dq", "flash_dkdv") for d in (32, 64)]
    missing = [n for n in need if not any(n in fn and counts[fn] > 0 for fn in counts)]
    kinds = ("paged_split_kernel", "paged_combine_kernel", "fused_ln_ffn_kernel")
    cuda_cores = [fn for fn in counts if any(k in fn for k in kinds)]
    ok = (not missing and all(any(k in fn for fn in cuda_cores) for k in kinds)
          and all(counts[fn] == 0 for fn in cuda_cores)
          and all((counts[fn] > 0) == (fn in wgmma) for fn in counts))
    pretty = short_names(sorted(counts))
    rec = {"phase": "build", "step": "sass_hgmma", "tool": tool,
           "hgmma_by_kernel": {pretty[fn]: counts[fn] for fn in sorted(counts)},
           "missing": missing, "cuda_core_kernels_checked": len(cuda_cores), "ok": ok}
    emit(rec)
    if not ok:
        raise SystemExit(f"HGMMA counts are not as designed: {rec}")
    return rec


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


def check_paged_attention(label, s_q, h, h_kv, lengths, quant, nmax=None, profiled=False):
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
    device_ms = cuda_graph_ms(lambda: paged_flash_attention(q, k, v, table, lens, **extra))
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
    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, **gqa)

    library_ms = cuda_ms(library)
    library_device_ms = cuda_graph_ms(library)
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
        "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "library_device_ms": library_device_ms, "timers": TIMERS,
        "bound_ms": b_ms, "bound_us": b_ms * 1e3, "bound_by": b_by,
        "share_of_bound": b_ms / device_ms, "ok": ok,
    }
    if profiled:  # the split kernel against the merge
        rec["device_us_by_kernel"] = kernel_us(
            lambda: paged_flash_attention(q, k, v, table, lens, **extra))
    emit(rec)
    if not ok:
        raise SystemExit(
            f"paged_attention {label}: max relative err {rel}, planted fault "
            f"{fault_rel} (tolerance {tol})"
        )
    return rec


def cycling(fns):
    """A call of the next of ``fns`` in turn: captured in a CUDA graph,
    consecutive calls read different copies of their inputs."""
    state = {"i": 0}

    def call():
        fns[state["i"] % len(fns)]()
        state["i"] += 1

    return call


def dropped_slab_plain(ln, ffn, x, kw, cols):
    """The planted fault: the plain version with one CTA's dff slab (the
    ``cols`` W_out rows in the middle of dff) left out of the second
    product."""
    from transformer_tpu_torch.ops.ffn import fused_ln_ffn_plain

    dff = ffn["out"]["kernel"].shape[0]
    w_out = ffn["out"]["kernel"].clone()
    w_out[dff // 2:dff // 2 + cols] = 0
    return fused_ln_ffn_plain(ln, {**ffn, "out": {**ffn["out"], "kernel": w_out}}, x, **kw)


def check_fused_ln_ffn(label, m, activation, norm_scheme, d=512, dff=2048):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from transformer_tpu_torch.config import is_gated
    from transformer_tpu_torch.ops.ffn import fused_ln_ffn, fused_ln_ffn_plain, slab_cols

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
    fault = dropped_slab_plain(ln, ffn, x, kw, slab_cols(dt))
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    fault_err = (fault.float() - want.float()).abs().max().item()
    tol = TOL["fused_ln_ffn"]
    ok = bool(torch.isfinite(got).all().item()) and err <= tol and fault_err > tol
    # Library yardstick: the F.layer_norm + F.linear chain.
    act = {
        "relu": F.relu, "gelu": lambda z: F.gelu(z, approximate="tanh"), "silu": F.silu,
        "reglu": F.relu, "geglu": lambda z: F.gelu(z, approximate="tanh"), "swiglu": F.silu,
    }[activation]

    def kernel_call(ffn, ln):
        return lambda: fused_ln_ffn(ln, ffn, x, **kw)

    def library_call(ffn, ln):
        w_in_t = ffn["in"]["kernel"].t().contiguous()
        w_out_t = ffn["out"]["kernel"].t().contiguous()
        w_gate_t = ffn["gate"]["kernel"].t().contiguous() if gated else None

        def library():
            h = F.layer_norm(x, (d,), ln["scale"], ln["bias"], 1e-6) if norm_scheme == "pre" else x
            u = F.linear(h, w_in_t, ffn["in"]["bias"])
            z = act(F.linear(h, w_gate_t, ffn["gate"]["bias"])) * u if gated else act(u)
            y = x + F.linear(z, w_out_t, ffn["out"]["bias"])
            if norm_scheme == "pre":
                return y
            return F.layer_norm(y, (d,), ln["scale"], ln["bias"], 1e-6)

        return library

    ms = cuda_ms(kernel_call(ffn, ln))
    device_ms = cuda_graph_ms(kernel_call(ffn, ln))
    plain_ms = cuda_ms(lambda: fused_ln_ffn_plain(ln, ffn, x, **kw), iters=20)
    library = library_call(ffn, ln)
    library_ms = cuda_ms(library)
    library_device_ms = cuda_graph_ms(library)
    # Cold: COLD_COPIES copies of the weights, each call of the graph on the
    # next copy, so a copy comes round again only after the others have
    # passed through L2.
    copies = [
        ({k: {n: w.clone() for n, w in p.items()} for k, p in ffn.items()},
         {n: w.clone() for n, w in ln.items()})
        for _ in range(COLD_COPIES)
    ]
    iters = 3 * COLD_COPIES
    device_ms_cold = cuda_graph_ms(cycling([kernel_call(*c) for c in copies]), iters=iters)
    library_device_ms_cold = cuda_graph_ms(cycling([library_call(*c) for c in copies]),
                                           iters=iters)
    del copies
    mats = 3 if gated else 2
    nbytes = 2 * (2 * m * d + mats * d * dff + (mats - 1) * dff + d + 2 * d)
    flops = 2.0 * m * d * dff * mats
    b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
    rec = {
        "phase": "kernels", "kernel": "fused_ln_ffn", "case": label,
        "m": m, "d": d, "dff": dff, "activation": activation,
        "norm_scheme": norm_scheme, "dtype": "bfloat16",
        "max_abs_err": err, "tolerance": tol,
        "planted_fault_dropped_slab": fault_err,
        "ms": ms, "device_ms": device_ms, "device_ms_cold": device_ms_cold,
        "plain_ms": plain_ms, "library_ms": library_ms,
        "library_device_ms": library_device_ms,
        "library_device_ms_cold": library_device_ms_cold, "timers": TIMERS_A,
        "bound_ms": b_ms, "bound_us": b_ms * 1e3, "bound_by": b_by,
        "share_of_bound": b_ms / device_ms_cold, "share_of_bound_warm": b_ms / device_ms,
        "ok": ok,
    }
    emit(rec)
    if not ok:
        raise SystemExit(
            f"fused_ln_ffn {label}: max abs err {err}, planted fault {fault_err} "
            f"(tolerance {tol})"
        )
    return rec


# --------------------------------------------------------------------------
# phase 3: the flash kernels against their plain versions


def flash_inputs(b, s_q, s_k, h, h_kv, d, dtype, padded, seed=SEED, lengths=None):
    """Random q/k/v/dO and a (B, S_k) key mask: all True, or (``padded``)
    the first sequence's last seventh of keys padding and the last
    sequence's first 33 keys padding, so that under causality its first 33
    query rows see no key at all; or, given ``lengths``, the first
    ``lengths[i]`` keys of sequence i real and the rest padding, as a
    batch of sentences pads them (a length of 0: a row of PAD only)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to("cuda", dtype)

    q, k, v, do = t(b, s_q, h, d), t(b, s_k, h_kv, d), t(b, s_k, h_kv, d), t(b, s_q, h, d)
    mask = np.ones((b, s_k), bool)
    if lengths is not None:
        mask = np.arange(s_k)[None, :] < np.asarray(lengths)[:, None]
    elif padded:
        mask[0, s_k - s_k // 7:] = False
        mask[-1, :33] = False
    return q, k, v, do, torch.from_numpy(mask).cuda()


def sentence_lengths(b, s, seed=SEED, empty_row=False, shortest=2):
    """Ragged key lengths of a batch of B sentences padded to S: from
    ``shortest`` (2: a sentence's BOS and EOS) to S, the last row 0 (all
    PAD) with ``empty_row``. (A sequence of one key has gradients that are
    0 up to rounding, which a relative reading cannot judge.)"""
    import numpy as np

    lengths = np.random.default_rng(seed + 7).integers(shortest, s + 1, size=b)
    lengths[0] = s
    if empty_row:
        lengths[-1] = 0
    return lengths


def first_key_dropped_plain(q, k, v, do, mask, kw):
    """The planted fault of the non-causal cases: the plain versions with
    each sequence's first real key taken for padding, as a key-mask test
    off by one would give. Returns (out, dq, dk, dv)."""
    import torch

    from transformer_tpu_torch.kernels.flash_attention import (
        flash_dkdv_plain,
        flash_dq_plain,
        flash_fwd_plain,
    )

    first = torch.argmax(mask.int(), dim=1)  # each row's first real key (0 if none)
    dropped = mask.clone()
    dropped[torch.arange(mask.shape[0], device=mask.device), first] = False
    kw = dict(kw, kv_mask=dropped)
    out, lse = flash_fwd_plain(q, k, v, **kw)
    delta = row_delta(do, out)
    return (out, flash_dq_plain(q, k, v, do, lse, delta, **kw),
            *flash_dkdv_plain(q, k, v, do, lse, delta, **kw))


def out_rel(got, want):
    """Per (batch, row, head): ||got - want|| / ||want|| across head_dim
    (||got|| where the plain row is exactly 0)."""
    import torch

    diff = (got.float() - want.float()).norm(dim=-1)
    ref = want.float().norm(dim=-1)
    return torch.where(ref > 0, diff / ref.clamp_min(1e-30), diff)


def grad_rel(got, want):
    """Per (batch, row, head): ||got - want|| / ||want|| across head_dim,
    with ||want|| floored at 1e-2 of the RMS row norm of its (batch, head).
    A row whose exact gradient is 0 or cancels to about 0 (dQ of a causal
    first row, dK/dV of a padding key) thus reads its error against the
    head's scale, not against its own rounding."""
    import torch

    diff = (got.float() - want.float()).norm(dim=-1)
    ref = want.float().norm(dim=-1)
    floor = 1e-2 * ref.pow(2).mean(dim=1, keepdim=True).sqrt()
    return diff / torch.maximum(ref, floor).clamp_min(1e-30)


def head_rel(got, want):
    """Per (batch, head): ||got - want|| / ||want|| across (sequence,
    head_dim), the measure the gradients were once held to; kept to show
    how far it dilutes a fault inside one tile."""
    diff = (got.float() - want.float()).pow(2).sum(dim=(1, 3)).sqrt()
    return diff / want.float().pow(2).sum(dim=(1, 3)).sqrt().clamp_min(1e-30)


def row_delta(do, out):
    return (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()


def off_by_one_plain(q, k, v, do, mask, band):
    """The planted fault: the plain versions with the causal test off by
    one (cols < rows, the diagonal dropped). Computed exactly by running
    them causally over keys moved one position later, the first slot
    masked, and moving dK/dV back. Returns (out, dq, dk, dv)."""
    import torch

    from transformer_tpu_torch.kernels.flash_attention import (
        flash_dkdv_plain,
        flash_dq_plain,
        flash_fwd_plain,
    )

    def later(x):
        return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)

    def earlier(x):
        return torch.cat([x[:, 1:], torch.zeros_like(x[:, :1])], dim=1)

    k1, v1 = later(k), later(v)
    kw = dict(kv_mask=later(mask), causal=True, band=band)
    out, lse = flash_fwd_plain(q, k1, v1, **kw)
    delta = row_delta(do, out)
    dq = flash_dq_plain(q, k1, v1, do, lse, delta, **kw)
    dk, dv = flash_dkdv_plain(q, k1, v1, do, lse, delta, **kw)
    return out, dq, earlier(dk), earlier(dv)


def last_rows_dropped_plain(q, k, v, do, lse, delta, kw, rows=10):
    """The second planted fault, inside one tile: the plain backward
    versions with the last 10 query rows that see any key (about 15% of a
    64-row tile; the last rows of the sequence unless a band of 0 or less
    leaves those with no key) left out, as a ragged-edge guard off by 10
    in both backward kernels would give. Their lse is set so high that p
    is 0 there. Returns (dq, dk, dv)."""
    import torch

    from transformer_tpu_torch.kernels.flash_attention import flash_dkdv_plain, flash_dq_plain

    seen = torch.nonzero((lse > -1e29).any(dim=0).any(dim=0))
    hi = int(seen.max().item()) + 1
    lse = lse.clone()
    lse[..., hi - rows:hi] = 1e30
    dq = flash_dq_plain(q, k, v, do, lse, delta, **kw)
    return (dq, *flash_dkdv_plain(q, k, v, do, lse, delta, **kw))


def visible_pairs(mask, s_q, causal, band):
    """(query row, key) pairs the attention computes, summed over the
    batch, per query head: what these inputs need, not the dense S_q*S_k."""
    import torch

    cm = torch.cumsum(mask.long(), dim=1)  # (B, S_k)
    if not causal:
        return int(cm[:, -1].sum().item()) * s_q
    rows = torch.arange(s_q, device=mask.device)
    seen = cm[:, rows]
    if band is not None:
        lo = rows - band
        seen = seen - torch.where(lo >= 0, cm[:, lo.clamp_min(0)], torch.zeros_like(seen))
    return int(seen.sum().item())


def check_flash(label, dtype, b, s_q, s_k, h, h_kv, d, causal, band, padded, timed=False,
                lengths=None, device_timed=False):
    """The three flash kernels against their plain versions on one case,
    read per (batch, row, head), with the planted faults. Rows that see no
    key must come back with out = 0, lse = MASKED and dQ = 0 exactly; with
    ``lengths`` (a batch of padded sentences, non-causal cases reading the
    first-key-dropped fault) the padding keys' dK and dV must be exactly 0
    too."""
    import torch

    from transformer_tpu_torch.kernels.flash_attention import (
        flash_dkdv,
        flash_dkdv_plain,
        flash_dq,
        flash_dq_plain,
        flash_fwd,
        flash_fwd_plain,
    )

    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]
    q, k, v, do, mask = flash_inputs(b, s_q, s_k, h, h_kv, d, dt, padded, lengths=lengths)
    kw = dict(kv_mask=mask, causal=causal, band=band)
    out, lse = flash_fwd(q, k, v, **kw)
    want_out, want_lse = flash_fwd_plain(q, k, v, **kw)
    delta = row_delta(do, want_out)
    dq = flash_dq(q, k, v, do, want_lse, delta, **kw)
    dk, dv = flash_dkdv(q, k, v, do, want_lse, delta, **kw)
    torch.cuda.synchronize()
    want_dq = flash_dq_plain(q, k, v, do, want_lse, delta, **kw)
    want_dk, want_dv = flash_dkdv_plain(q, k, v, do, want_lse, delta, **kw)
    got = {"out": out, "dq": dq, "dk": dk, "dv": dv}
    want = {"out": want_out, "dq": want_dq, "dk": want_dk, "dv": want_dv}
    readings = {"out": out_rel(out, want_out).max().item()}
    readings.update({key: grad_rel(got[key], want[key]).max().item() for key in ("dq", "dk", "dv")})
    worst_batch = {key: int(grad_rel(got[key], want[key]).amax(dim=(1, 2)).argmax().item())
                   for key in ("dq", "dk", "dv")}
    max_abs = {key: (got[key].float() - want[key].float()).abs().max().item() for key in got}
    seen = want_lse > -1e29
    empty = int((~seen).sum().item())  # (batch, head, row) triples that see no key
    lse_err = (lse - want_lse)[seen].abs().max().item()
    empty_exact = bool(
        torch.all(lse[~seen] == -1e30).item()
        and torch.all(out.permute(0, 2, 1, 3)[~seen] == 0).item()
        and torch.all(dq.permute(0, 2, 1, 3)[~seen] == 0).item()
    )
    pad_keys = ~mask  # (B, S_k)
    padded_keys_exact = bool(
        torch.all(dk[pad_keys] == 0).item() and torch.all(dv[pad_keys] == 0).item()
    )
    tol = FLASH_TOL[dtype]
    finite = all(bool(torch.isfinite(t).all().item()) for t in got.values())
    ok = (
        finite and empty_exact and lse_err <= 1e-4
        and (padded_keys_exact or lengths is None)
        and readings["out"] <= tol["out"]
        and all(readings[key] <= tol["grad"] for key in ("dq", "dk", "dv"))
    )
    rec = {
        "phase": "kernels", "kernel": "flash_attention", "case": label, "dtype": dtype,
        "b": b, "s_q": s_q, "s_k": s_k, "h": h, "h_kv": h_kv, "d": d, "causal": causal,
        "band": band, "padded": padded, "rows_seeing_no_key": empty,
        "key_lengths": None if lengths is None else [int(n) for n in lengths],
        "readings": readings, "worst_batch": worst_batch, "max_abs_err": max_abs,
        "lse_max_abs_err": lse_err,
        "empty_rows_exact": empty_exact, "padding_keys_dk_dv_exact": padded_keys_exact,
        "tolerance": tol,
    }
    # A planted fault must read above the limit in every (batch, head) of
    # a sequence that has a key: the worst row of each, at its least over
    # (batch, head). (A sequence of PAD only has nothing to get wrong.)
    has_key = mask.any(dim=1)

    def worst_row_least_head(fault, key):
        return grad_rel(fault, want[key]).amax(dim=1)[has_key].min().item()

    grads = ("dq", "dk", "dv")
    if causal:
        fault = dict(zip(("out", *grads), off_by_one_plain(q, k, v, do, mask, band)))
        fault_rows = out_rel(fault["out"], want_out)
        rec["planted_fault"] = {
            "out_max_row": fault_rows.max().item(),
            "out_median_row": fault_rows.median().item(),
            **{f"{key}_worst_row_least_head": worst_row_least_head(fault[key], key)
               for key in grads},
        }
        pf = rec["planted_fault"]
        ok = ok and pf["out_max_row"] > tol["out"] and all(
            pf[f"{key}_worst_row_least_head"] > tol["grad"] for key in grads
        )
        del fault
    elif lengths is not None:
        fault = dict(zip(("out", *grads), first_key_dropped_plain(q, k, v, do, mask, kw)))
        fault_rows = out_rel(fault["out"], want_out)[has_key]
        rec["planted_key_fault"] = {
            "out_max_row": fault_rows.max().item(),
            "out_median_row": fault_rows.median().item(),
            **{f"{key}_worst_row_least_head": worst_row_least_head(fault[key], key)
               for key in grads},
        }
        pf = rec["planted_key_fault"]
        ok = ok and pf["out_max_row"] > tol["out"] and all(
            pf[f"{key}_worst_row_least_head"] > tol["grad"] for key in grads
        )
        del fault
    rows_fault = dict(zip(grads, last_rows_dropped_plain(q, k, v, do, want_lse, delta, kw)))
    rec["planted_rows_fault"] = {
        **{f"{key}_worst_row_least_head": worst_row_least_head(rows_fault[key], key)
           for key in grads},
        **{f"{key}_per_head_max": head_rel(rows_fault[key], want[key]).max().item()
           for key in grads},
    }
    ok = ok and all(
        rec["planted_rows_fault"][f"{key}_worst_row_least_head"] > tol["grad"] for key in grads
    )
    del rows_fault
    if timed:
        rec.update(time_flash(q, k, v, do, mask, kw, want_lse, delta, dtype, device_timed))
    rec["ok"] = ok
    emit(rec)
    if not ok:
        raise SystemExit(f"flash attention {label}: {rec}")
    return rec


def time_flash(q, k, v, do, mask, kw, lse, delta, dtype, device_timed=False):
    """Each kernel's time, its plain version's, the library call's (SDPA
    forward; for the two backward kernels, the backward of SDPA, which
    computes dq, dk and dv together) and the bound from this run's inputs.
    With ``device_timed`` (shapes where a call takes microseconds, so that
    ``cuda_ms`` reads the host's time per call) also each kernel's own
    device time and the library call's, by ``kernel_us``."""
    import torch
    import torch.nn.functional as F

    from transformer_tpu_torch.kernels.flash_attention import (
        flash_dkdv,
        flash_dkdv_plain,
        flash_dq,
        flash_dq_plain,
        flash_fwd,
        flash_fwd_plain,
    )

    calls = {
        "flash_fwd": lambda: flash_fwd(q, k, v, **kw),
        "flash_dq": lambda: flash_dq(q, k, v, do, lse, delta, **kw),
        "flash_dkdv": lambda: flash_dkdv(q, k, v, do, lse, delta, **kw),
    }
    ms = {name: cuda_ms(fn, iters=20) for name, fn in calls.items()}
    plain_ms = {
        "flash_fwd": cuda_ms(lambda: flash_fwd_plain(q, k, v, **kw), iters=3, warmup=1),
        "flash_dq": cuda_ms(
            lambda: flash_dq_plain(q, k, v, do, lse, delta, **kw), iters=3, warmup=1
        ),
        "flash_dkdv": cuda_ms(
            lambda: flash_dkdv_plain(q, k, v, do, lse, delta, **kw), iters=3, warmup=1
        ),
    }
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    b, s_q, h, d = q.shape
    # is_causal=True where the key mask is all True (the long4k main path);
    # otherwise the key mask (ANDed with causality) as a boolean attn_mask.
    if bool(mask.all().item()) and kw["causal"]:
        sdpa_kw, library = dict(is_causal=True), "is_causal=True"
    else:
        allowed = mask[:, None, None, :]
        if kw["causal"]:
            allowed = allowed & torch.ones((s_q, k.shape[1]), dtype=torch.bool,
                                           device=mask.device).tril()
        sdpa_kw, library = dict(attn_mask=allowed), "attn_mask=key mask"
    lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw))
    leaves = [x.clone().requires_grad_() for x in (qt, kt, vt)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, **sdpa_kw)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(sdpa_out, leaves, dot, retain_graph=True))
    library_ms = {"flash_fwd": lib_fwd, "flash_dq": lib_bwd, "flash_dkdv": lib_bwd}
    e = q.element_size()
    pairs = visible_pairs(mask, s_q, kw["causal"], kw["band"]) * h
    qb, kvb, rows = q.numel() * e, k.numel() * e, b * h * s_q * 4
    nbytes = {
        "flash_fwd": 2 * qb + 2 * kvb + rows + mask.numel(),
        "flash_dq": 3 * qb + 2 * kvb + 2 * rows + mask.numel(),
        "flash_dkdv": 2 * qb + 4 * kvb + 2 * rows + mask.numel(),
    }
    # 2 flops per multiply-add: QK^T and PV forward; S, dP and dQ; S, dP,
    # dV and dK.
    flops = {name: 2.0 * n * d * pairs
             for name, n in (("flash_fwd", 2), ("flash_dq", 3), ("flash_dkdv", 4))}
    bounds = {name: bound_ms(nbytes[name], flops[name], dtype) for name in ms}
    device = {}
    if device_timed:
        own = {name: kernel_us(fn) for name, fn in calls.items()}
        lib = [kernel_us(lambda: F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)),
               kernel_us(lambda: torch.autograd.grad(sdpa_out, leaves, dot, retain_graph=True))]
        own_ms = {
            name: sum(us for key, us in own[name].items() if f"{name}_kernel" in key) / 1e3
            if isinstance(own[name], dict) else 0.0
            for name in calls
        }
        if not all(own_ms.values()) or "not measured" in lib:
            device = {"device_ms": "not measured", "library_device_ms": "not measured"}
        else:
            lib_fwd_ms, lib_bwd_ms = (sum(us.values()) / 1e3 for us in lib)
            device = {
                "device_ms": own_ms,
                "library_device_ms": {"flash_fwd": lib_fwd_ms, "flash_dq": lib_bwd_ms,
                                      "flash_dkdv": lib_bwd_ms},
                "share_of_bound_device": {n: bounds[n][0] / own_ms[n] for n in calls},
            }
    return {
        **device,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "library": f"torch.nn.functional.scaled_dot_product_attention({library}); "
                   "backward via torch.autograd.grad (dq, dk, dv together)",
        "visible_pairs_per_head": pairs // h, "bytes": nbytes, "flops": flops,
        "bound_ms": {n: v[0] for n, v in bounds.items()},
        "bound_by": {n: v[1] for n, v in bounds.items()},
        "share_of_bound": {n: bounds[n][0] / ms[n] for n in ms},
    }


# --------------------------------------------------------------------------
# phase 3: the ring step against its plain version, and a ring replayed in
# one process


def finalise(m, l, acc, dtype):
    """(out (B, C, H, D) in ``dtype``, lse (B, H, C)) of a ring carry, as
    ``parallel/ring_attention.py`` finalises it."""
    import torch

    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l_safe.permute(0, 2, 1)[..., None]).to(dtype), m + torch.log(l_safe)


def ring_faults(carry, want, rows=10):
    """The two planted faults, as finalised carries: the plain step with
    the correction factor left out (acc not rescaled when the running
    maximum moves: acc_prev + P·V = want_acc + acc_prev·(1 - corr)), and
    the plain step with the last 10 query rows that the hop folds a key
    into left unfolded (their carry unchanged), as a ragged-edge guard off
    by 10 would give."""
    import torch

    m0, l0, acc0 = carry
    m1, l1, acc1 = want
    corr = torch.exp(m0 - m1).permute(0, 2, 1)[..., None]  # (B, C, H, 1)
    no_corr = (m1, l1, acc1 + acc0 * (1.0 - corr))
    hi = int(torch.nonzero((l1 != l0).any(dim=0).any(dim=0)).max().item()) + 1
    lo = hi - rows
    m2, l2, acc2 = (x.clone() for x in want)
    m2[..., lo:hi], l2[..., lo:hi], acc2[:, lo:hi] = m0[..., lo:hi], l0[..., lo:hi], acc0[:, lo:hi]
    return {"no_correction": no_corr, "rows_unfolded": (m2, l2, acc2)}


def check_ring_step(label, dtype, b, c, h, h_kv, d, causal, band, padded, timed=False,
                    fresh=False):
    """flash_ring_step against flash_ring_step_plain for one hop from the
    carry an earlier, unmasked hop left (``fresh``: from the carry a ring
    starts with, m = MASKED, l = 0, acc = 0). Read per row: the finalised
    out (||Δ|| / ||want|| across head_dim), lse (absolute), m (absolute)
    and l (relative); the planted faults must read above the out limit on
    the worst row (from a fresh carry there is nothing to rescale, so only
    the unfolded rows are planted). From a fresh carry, every row that sees
    no key in the hop must come back with m = MASKED, l = 0 and acc = 0
    exactly."""
    import torch

    from transformer_tpu_torch.kernels.flash_attention import (
        flash_ring_step,
        flash_ring_step_plain,
    )
    from transformer_tpu_torch.kernels.paged_flash import MASKED

    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]
    q, k, v, _, mask = flash_inputs(b, c, c, h, h_kv, d, dt, padded)
    _, k0, v0, _, _ = flash_inputs(b, c, c, h, h_kv, d, dt, False, seed=SEED + 1)
    start = (torch.full((b, h, c), MASKED, device="cuda"), torch.zeros((b, h, c), device="cuda"),
             torch.zeros((b, c, h, d), device="cuda"))
    carry = start if fresh else flash_ring_step_plain(q, k0, v0, None, *start)
    kw = dict(causal=causal, band=band)
    got = [x.clone() for x in carry]
    flash_ring_step(q, k, v, mask, *got, **kw)
    want = flash_ring_step_plain(q, k, v, mask, *carry, **kw)
    torch.cuda.synchronize()
    got_out, got_lse = finalise(*got, dt)
    want_out, want_lse = finalise(*want, dt)
    seen = want[1] > 0
    readings = {
        "out": out_rel(got_out, want_out).max().item(),
        "lse_abs": (got_lse - want_lse)[seen].abs().max().item(),
        "m_abs": (got[0] - want[0])[seen].abs().max().item(),
        "l_rel": ((got[1] - want[1]).abs() / want[1].clamp_min(1e-30))[seen].max().item(),
    }
    tol = FLASH_TOL[dtype]["out"]
    faults = {
        name: out_rel(finalise(*f, dt)[0], want_out).max().item()
        for name, f in ring_faults(carry, want).items()
        if not (fresh and name == "no_correction")
    }
    finite = all(bool(torch.isfinite(x).all().item()) for x in got)
    ok = (finite and readings["out"] <= tol and readings["lse_abs"] <= 1e-4
          and readings["m_abs"] <= 1e-4 and readings["l_rel"] <= tol
          and all(f > tol for f in faults.values()))
    if fresh:
        unseen = ~seen  # (B, H, C)
        sentinel = {
            "rows_without_a_key": int(unseen.sum().item()),
            "m_is_masked": bool((got[0][unseen] == MASKED).all().item()),
            "l_is_zero": bool((got[1][unseen] == 0).all().item()),
            "acc_is_zero": bool((got[2].permute(0, 2, 1, 3)[unseen] == 0).all().item()),
        }
        readings["sentinel"] = sentinel
        ok = ok and sentinel["rows_without_a_key"] > 0 and all(
            sentinel[k] for k in ("m_is_masked", "l_is_zero", "acc_is_zero"))
    rec = {
        "phase": "kernels", "kernel": "flash_ring_step", "case": label, "dtype": dtype,
        "b": b, "c": c, "h": h, "h_kv": h_kv, "d": d, "causal": causal, "band": band,
        "padded": padded, "fresh_carry": fresh, "readings": readings,
        "max_abs_err": (got_out.float() - want_out.float()).abs().max().item(),
        "tolerance": {"out_row_rel": tol, "l_row_rel": tol, "lse_abs": 1e-4, "m_abs": 1e-4},
        "planted_faults_worst_row": faults,
    }
    if timed:
        ms = cuda_ms(lambda: flash_ring_step(q, k, v, mask, *got, **kw), iters=20)
        plain_ms = cuda_ms(lambda: flash_ring_step_plain(q, k, v, mask, *carry, **kw),
                           iters=3, warmup=1)
        e = q.element_size()
        carry_bytes = sum(x.numel() * 4 for x in carry)
        nbytes = q.numel() * e + 2 * k.numel() * e + mask.numel() + 2 * carry_bytes
        pairs = visible_pairs(mask, c, causal, None) * h
        flops = 4.0 * d * pairs  # QK^T and PV, 2 flops per multiply-add
        b_ms, b_by = bound_ms(nbytes, flops, dtype)
        rec.update({
            "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "library": "none: no single PyTorch call folds a chunk into an online-softmax carry",
            "bytes": nbytes, "flops": flops, "bound_ms": b_ms, "bound_by": b_by,
            "share_of_bound": b_ms / ms,
        })
    rec["ok"] = ok
    emit(rec)
    if not ok:
        raise SystemExit(f"flash_ring_step {label}: {rec}")
    return rec


def ring_replay(b=4, s=4096, h=8, d=64, sp=4):
    """The ring of ``sp`` ranks replayed in one process at the main shape
    (bf16, causal, the last key padding as the sequence split pads 4095
    to 4096): each rank's hops in ring order through flash_ring_step and
    its backward through flash_chunk_bwd, against flash_fwd / flash_dq /
    flash_dkdv on the whole sequence. This holds the carry and the dK/dV
    sums across hops without any transport."""
    import torch

    from transformer_tpu_torch.kernels.flash_attention import (
        flash_chunk_bwd,
        flash_dkdv,
        flash_dq,
        flash_fwd,
        flash_ring_step,
    )
    from transformer_tpu_torch.kernels.paged_flash import MASKED

    q, k, v, do, mask = flash_inputs(b, s, s, h, h, d, torch.bfloat16, False)
    mask[:, -1] = False
    kw = dict(kv_mask=mask, causal=True)
    want_out, want_lse = flash_fwd(q, k, v, **kw)
    delta = row_delta(do, want_out)
    want = {"dq": flash_dq(q, k, v, do, want_lse, delta, **kw)}
    want["dk"], want["dv"] = flash_dkdv(q, k, v, do, want_lse, delta, **kw)
    c = s // sp

    def part(x, r):
        return x[:, r * c:(r + 1) * c].contiguous()

    outs, lses, dqs = [], [], []
    dks = [torch.zeros((b, c, h, d), device="cuda") for _ in range(sp)]
    dvs = [torch.zeros((b, c, h, d), device="cuda") for _ in range(sp)]
    for r in range(sp):
        m = torch.full((b, h, c), MASKED, device="cuda")
        l, acc = torch.zeros_like(m), torch.zeros((b, c, h, d), device="cuda")
        srcs = [(r - t) % sp for t in range(sp) if (r - t) % sp <= r]
        for src in srcs:
            flash_ring_step(part(q, r), part(k, src), part(v, src), part(mask, src), m, l, acc,
                            causal=src == r)
        out_r, lse_r = finalise(m, l, acc, torch.bfloat16)
        delta_r = row_delta(part(do, r), out_r)
        dq_r = torch.zeros((b, c, h, d), device="cuda")
        for src in srcs:
            dq_s, dk_s, dv_s = flash_chunk_bwd(
                part(q, r), part(k, src), part(v, src), part(mask, src), lse_r, delta_r,
                part(do, r), causal=src == r,
            )
            dq_r += dq_s.float()
            dks[src] += dk_s.float()
            dvs[src] += dv_s.float()
        outs.append(out_r)
        lses.append(lse_r)
        dqs.append(dq_r.to(torch.bfloat16))
    got = {"out": torch.cat(outs, 1), "dq": torch.cat(dqs, 1),
           "dk": torch.cat(dks, 1).to(torch.bfloat16), "dv": torch.cat(dvs, 1).to(torch.bfloat16)}
    torch.cuda.synchronize()
    readings = {"out": out_rel(got["out"], want_out).max().item()}
    readings.update({key: grad_rel(got[key], want[key]).max().item() for key in ("dq", "dk", "dv")})
    worst_batch = {key: int(grad_rel(got[key], want[key]).amax(dim=(1, 2)).argmax().item())
                   for key in ("dq", "dk", "dv")}
    readings["lse_abs"] = (torch.cat(lses, 2) - want_lse).abs().max().item()
    tol = FLASH_TOL["bfloat16"]
    ok = (readings["out"] <= tol["out"] and readings["lse_abs"] <= 1e-4
          and all(readings[key] <= tol["grad"] for key in ("dq", "dk", "dv")))
    rec = {"phase": "kernels", "step": "ring_replay", "b": b, "s": s, "h": h, "d": d, "sp": sp,
           "hops_folded": sum(r + 1 for r in range(sp)), "readings": readings,
           "tolerance": {**tol, "lse_abs": 1e-4}, "ok": ok}
    emit(rec)
    if not ok:
        raise SystemExit(f"ring replay failed: {rec}")
    return rec


# --------------------------------------------------------------------------
# phase 4: serving


def long4k_config(vocab_size: int, **overrides):
    """The repo's long4k preset (transformer_tpu/cli/flags.py) at full
    width: 6 layers, d_model 512, 8 heads, dff 2048, max_position 4096,
    post-LN, sinusoidal, relu, bf16; dropout off for serving."""
    from transformer_tpu_torch.config import ModelConfig

    fields = dict(
        num_layers=6, d_model=512, num_heads=8, dff=2048,
        input_vocab_size=vocab_size, target_vocab_size=vocab_size,
        max_position=4096, decoder_only=True, attention_impl="flash",
        remat=True, dropout_rate=0.0,
    )
    return ModelConfig(**{**fields, **overrides})


def vocab(target_size: int = 2**15, side: str = "tgt"):
    """The port's tokenizer built from data/{side}-train.txt (``side``
    "joint": both sides, one id space for tied tables) at the CLI's
    default target size, cached under build/vocab/."""
    from transformer_tpu_torch.data.tokenizer import SubwordTokenizer, iter_lines

    path = os.path.join(BUILD_DIR, "vocab", f"{side}-train-{target_size}.subwords")
    files = [os.path.join(ROOT, "data", f"{name}-train.txt")
             for name in (("src", "tgt") if side == "joint" else (side,))]
    t0 = time.perf_counter()
    if os.path.exists(path):
        tok, built = SubwordTokenizer.load(path), False
    else:
        tok = SubwordTokenizer.build_from_corpus(iter_lines(*files), target_vocab_size=target_size)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tok.save(path)
        built = True
    emit({
        "phase": "main", "step": "vocab", "side": side, "target_size": target_size,
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
    total_us = sum(dev_us(e) for e in events)
    device_ms = total_us / steps / 1e3
    # Kernel B is two kernels since the split: the split and the merge.
    # Kernel A is one (its cluster sums and its last stage run inside it).
    names = {"paged_attention": ("paged_split_kernel", "paged_combine_kernel"),
             "fused_ln_ffn": ("fused_ln_ffn_kernel",)}
    shares = {
        name: sum(dev_us(e) for e in events if any(k in e.key for k in keys)) / max(total_us, 1)
        for name, keys in names.items()
    }
    top = sorted(events, key=dev_us, reverse=True)[:8]
    rec = {
        "phase": "main", "step": "decode_profile", "steps": steps, "slots_busy": 4,
        "positions": sorted(st.pos for st in sched._active.values()),
        "wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms if events else "not measured",
        "device_busy_share": device_ms / wall_ms if events else "not measured",
        "kernel_share_of_device_time": shares if events else "not measured",
        "top_kernels": [
            {"name": e.key[:80], "ms_per_step": dev_us(e) / steps / 1e3,
             "calls_per_step": e.count / steps}
            for e in top
        ],
    }
    emit(rec)
    return rec


# --------------------------------------------------------------------------
# phase 5: training


def train_path(vocab_path):
    """``cli.train --preset long4k --epochs 1`` on the bundled corpus, with
    the flash launch counters set to 0 just before and read just after."""
    import statistics

    import torch

    from transformer_tpu_torch.cli import train
    from transformer_tpu_torch.convert import load_export
    from transformer_tpu_torch.data.pipeline import load_lm_splits
    from transformer_tpu_torch.kernels.flash_attention import flash_dkdv, flash_dq, flash_fwd
    from transformer_tpu_torch.models.transformer import flatten

    data = os.path.join(ROOT, "data")
    export = os.path.join(BUILD_DIR, "train_export")
    argv = [
        "--preset", "long4k", "--epochs", "1", "--dataset_path", data,
        "--tgt_vocab_file", vocab_path, "--export_path", export,
        "--ckpt_path", fresh_dir("ckpt", "train"), "--device", "cuda",
    ]
    flags = train.resolve_flags(argv)
    t0 = time.perf_counter()
    train_ds, test_ds, _ = load_lm_splits(
        data, vocab_path, batch_size=flags.batch_size, sequence_length=flags.sequence_length
    )
    windows = {
        "train_windows": train_ds.num_examples, "train_batches": len(train_ds),
        "test_windows": test_ds.num_examples, "test_batches": len(test_ds),
        "eval_rows_all_pad": len(test_ds) * flags.batch_size - test_ds.num_examples,
        "count_seconds": time.perf_counter() - t0,
    }
    logs: list[str] = []
    torch.cuda.reset_peak_memory_stats()
    flash_fwd.launches = flash_dq.launches = flash_dkdv.launches = 0
    t0 = time.perf_counter()
    trainer = train.main(argv, log_fn=logs.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": flash_fwd.launches, "flash_dq": flash_dq.launches,
                "flash_dkdv": flash_dkdv.launches}
    peak = torch.cuda.max_memory_allocated()
    cfg = trainer.model_cfg
    steps, evals = len(trainer.step_seconds), trainer.eval_batches
    forwards_per_step = 2 if cfg.remat else 1  # remat recomputes each layer's forward
    want = {
        "flash_fwd": cfg.num_layers * (forwards_per_step * steps + evals),
        "flash_dq": cfg.num_layers * steps,
        "flash_dkdv": cfg.num_layers * steps,
    }
    params, loaded_cfg = load_export(export, device="cuda")
    same = loaded_cfg == cfg and all(
        torch.equal(a, b.detach()) for a, b in zip(
            flatten(params).values(), flatten(trainer.state.params).values()
        )
    )
    ms = [t * 1e3 for t in trainer.step_seconds]
    train_loss, eval_loss = trainer.train_metrics.loss, trainer.eval_metrics.loss
    rec = {
        "phase": "train", "step": "fit", "argv": argv, "config": dataclasses.asdict(cfg),
        **windows, "steps": steps, "eval_batches": evals,
        "step_ms_mean": statistics.mean(ms), "step_ms_median": statistics.median(ms),
        "step_ms_first": ms[0], "step_ms_all": ms,
        "tokens_per_s": trainer.tokens / sum(trainer.step_seconds),
        "fit_wall_s": wall, "max_memory_allocated_bytes": peak,
        "train_loss": train_loss, "eval_loss": eval_loss,
        "eval_perplexity": math.exp(min(eval_loss, 30.0)),
        "launches": launches, "expected_launches": want, "export_loads_back": same,
        "logs": logs,
    }
    emit(rec)
    if not (math.isfinite(train_loss) and math.isfinite(eval_loss)):
        raise SystemExit(f"training produced a non-finite loss: {train_loss} / {eval_loss}")
    if evals < 1 or steps < 1:
        raise SystemExit(f"training ran {steps} steps and {evals} eval batches")
    for name, count in launches.items():
        if count <= 0 or count != want[name]:
            raise SystemExit(f"{name} launched {count} times, expected {want[name]}")
    if not same:
        raise SystemExit("the written export does not load back to the trained params")
    return trainer, train_ds, launches, rec


def fp32_train_check(tok, train_ds, layers: int = 2):
    """One fp32 train step's loss and gradients at full width (2 layers,
    S 4096, batch 4, dropout 0) from the same params and batch, once on
    the kernels and once on their plain versions."""
    import torch

    from transformer_tpu_torch.config import TrainConfig
    from transformer_tpu_torch.models.transformer import init_params

    cfg = long4k_config(tok.model_vocab_size, num_layers=layers, dtype="float32")
    tcfg = TrainConfig(batch_size=4, sequence_length=4096)
    params = init_params(cfg, torch.Generator().manual_seed(SEED), device="cuda")
    _, tgt = next(iter(train_ds.batches(0)))
    tgt = torch.from_numpy(tgt).to(params["decoder"]["embedding"]["table"].device, torch.long)
    kernels_vs_plain_step(
        {"phase": "train", "step": "fp32_train_check", "layers": layers, "batch": 4,
         "sequence_length": 4096}, cfg, tcfg, params, tgt,
    )


def kernels_vs_plain_step(rec, cfg, tcfg, params, tgt, src=None):
    """One train step's loss and gradients from ``params`` on one batch,
    once on the kernels and once on their plain versions, held to
    TRAIN_TOL (``hold_to_train_tol``)."""
    from transformer_tpu_torch.models.transformer import flatten, unflatten
    from transformer_tpu_torch.train.trainer import loss_and_grads

    runs = []
    for reference in (False, True):
        p = unflatten({k: v.clone().requires_grad_() for k, v in flatten(params).items()})
        metrics, grads = loss_and_grads(p, tgt, cfg, tcfg, key=None, reference=reference,
                                        src=src)
        runs.append((float(metrics["loss"]), grads))
        del p, metrics, grads
    return hold_to_train_tol(rec, runs[0], runs[1], "fp32 kernels-vs-plain train step")


def hold_to_train_tol(rec, got_run, want_run, what):
    """Two (loss, gradients by leaf) of one step held to TRAIN_TOL: loss
    relative, every leaf's relative norm; the attention key biases (zero
    gradient up to rounding) to a fraction of the query biases' gradient
    instead, on both sides."""
    (loss, got), (want_loss, want) = got_run, want_run
    worst, worst_key = 0.0, None
    for key, g in got.items():
        if key.endswith("mha/key/bias"):
            continue
        rel = ((g - want[key]).norm() / want[key].norm().clamp_min(1e-30)).item()
        if rel > worst:
            worst, worst_key = rel, key
    key_bias = 0.0
    for key in got:
        if key.endswith("mha/key/bias"):  # zero up to rounding
            q_key = key.replace("key/bias", "query/bias")
            for grads in (got, want):
                ratio = (grads[key].norm() / grads[q_key].norm().clamp_min(1e-30)).item()
                key_bias = max(key_bias, ratio)
    loss_rel = abs(loss - want_loss) / abs(want_loss)
    rec = {
        **rec, "loss": loss, "want_loss": want_loss,
        "loss_rel_diff": loss_rel, "grad_worst_rel": worst, "grad_worst_leaf": worst_key,
        "key_bias_grad_ratio": key_bias, "leaves": len(got), "tolerance": TRAIN_TOL,
    }
    emit(rec)
    if not (loss_rel <= TRAIN_TOL["loss_rel"] and worst <= TRAIN_TOL["grad_rel"]
            and key_bias <= TRAIN_TOL["key_bias_ratio"]):
        raise SystemExit(f"{what} failed: {rec}")
    return rec


def train_profile(trainer, train_ds, steps: int = 3, phase: str = "train"):
    """Where a train step's time goes: ``steps`` steps on the host clock,
    then the same number under ``torch.profiler`` for device time by
    kernel. Device busy share = summed kernel time / unprofiled wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    batches = list(train_ds.batches(1))[: 2 * steps + 1]
    trainer.state, _ = trainer.train_step(trainer.state, *batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for src, tgt in batches[1 : steps + 1]:
        trainer.state, _ = trainer.train_step(trainer.state, src, tgt)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for src, tgt in batches[steps + 1 :]:
            trainer.state, _ = trainer.train_step(trainer.state, src, tgt)
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    events = [
        e for e in prof.key_averages()
        if str(getattr(e, "device_type", "")).endswith("CUDA") and dev_us(e) > 0
    ]
    total_us = sum(dev_us(e) for e in events)
    device_ms = total_us / steps / 1e3
    shares = {
        name: sum(dev_us(e) for e in events if f"{name}_kernel" in e.key) / max(total_us, 1)
        for name in ("flash_fwd", "flash_dq", "flash_dkdv")
    }
    top = sorted(events, key=dev_us, reverse=True)[:10]
    # The host's side of the same window: operators by their own CPU time
    # (the profiler's overhead included), to see what keeps the device idle.
    host = sorted(
        (e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CPU")),
        key=lambda e: e.self_cpu_time_total, reverse=True,
    )[:8]
    rec = {
        "phase": phase, "step": "train_profile", "steps": steps,
        "wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms if events else "not measured",
        "device_busy_share": device_ms / wall_ms if events else "not measured",
        "flash_share_of_device_time": shares if events else "not measured",
        "top_kernels": [
            {"name": e.key[:90], "ms_per_step": dev_us(e) / steps / 1e3,
             "calls_per_step": e.count / steps}
            for e in top
        ],
        "top_host_ops": [
            {"name": e.key[:60], "self_cpu_ms_per_step": e.self_cpu_time_total / steps / 1e3,
             "calls_per_step": e.count / steps}
            for e in host
        ],
    }
    emit(rec)
    return rec


# --------------------------------------------------------------------------
# phase 7: sequence-parallel training, the main path of the ring


def sp_train_path(vocab_path, single, sp: int = 4):
    """``cli.distributed_train --preset long4k --attention_impl ring --sp 4
    --epochs 1`` under ``torch.distributed.run``: four processes on this
    one card, so the transport is gloo through host memory. The kernel
    counters of each process start at 0 with it and are read from its
    report at the end. Losses must be within 0.01 of the single-card run
    of phase 5 (same seed, same dropout draws)."""
    import statistics

    from transformer_tpu_torch.convert import load_export, params_digest

    export = os.path.join(BUILD_DIR, "sp_train_export")
    report_path = os.path.join(BUILD_DIR, "sp_train_report.json")
    args = [
        "--preset", "long4k", "--attention_impl", "ring", "--sp", str(sp), "--epochs", "1",
        "--dataset_path", os.path.join(ROOT, "data"), "--tgt_vocab_file", vocab_path,
        "--export_path", export, "--ckpt_path", fresh_dir("ckpt", "sp_train"),
        "--device", "cuda", "--metrics_json", report_path,
    ]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(sp), "-m", "transformer_tpu_torch.cli.distributed_train", *args]
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "2"}
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(
            f"sequence-parallel training failed (exit {proc.returncode}):\n"
            f"{proc.stdout[-4000:]}\n{proc.stderr[-6000:]}"
        )
    with open(report_path) as f:
        report = json.load(f)
    ranks = report["ranks"]
    cfg = single["config"]
    steps, evals = len(ranks[0]["step_seconds"]), ranks[0]["eval_batches"]
    per_rank = {r["rank"]: r["launches"] for r in ranks}
    launches = {name: sum(r[name] for r in per_rank.values()) for name in per_rank[0]}
    hops = sum(r + 1 for r in range(sp))  # rank r folds its own chunk and the r before it
    layers = cfg["num_layers"]
    want = {
        "flash_fwd": 0,
        "flash_ring_step": layers * hops * (2 * steps + evals),  # remat: each forward twice
        "flash_dq": layers * hops * steps,
        "flash_dkdv": layers * hops * steps,
    }
    params, loaded_cfg = load_export(export, device="cuda")
    digest = params_digest(params)
    ms = [t * 1e3 for t in ranks[0]["step_seconds"]]
    train_loss, eval_loss = ranks[0]["train_loss"], ranks[0]["eval_loss"]
    rec = {
        "phase": "sp_train", "step": "fit", "argv": args, "processes": sp,
        "transport": ranks[0]["transport"], "card": nvidia_smi_line(),
        "devices": [r["device"] for r in ranks],
        "staged_bytes_per_rank": [r["staged_bytes"] for r in ranks],
        "steps": steps, "eval_batches": evals,
        "step_ms_mean": statistics.mean(ms), "step_ms_median": statistics.median(ms),
        "step_ms_first": ms[0], "step_ms_all": ms,
        "tokens_per_s": ranks[0]["tokens"] / sum(ranks[0]["step_seconds"]),
        "wall_s": wall, "train_loss": train_loss, "eval_loss": eval_loss,
        "single_card_train_loss": single["train_loss"],
        "single_card_eval_loss": single["eval_loss"],
        "launches_per_rank": per_rank, "launches": launches, "expected_launches": want,
        "export_loads_back": digest == ranks[0]["params_sha256"],
        "ranks_hold_the_same_params": len({r["params_sha256"] for r in ranks}) == 1,
        "logs": proc.stdout.splitlines()[-12:],
    }
    emit(rec)
    if rec["transport"] != "gloo":
        raise SystemExit(f"{sp} processes on one card must use gloo, got {rec['transport']}")
    if not (abs(train_loss - single["train_loss"]) <= 0.01
            and abs(eval_loss - single["eval_loss"]) <= 0.01):
        raise SystemExit(f"sequence-parallel losses {train_loss}/{eval_loss} are not within "
                         f"0.01 of the single-card {single['train_loss']}/{single['eval_loss']}")
    if steps != single["steps"] or evals != single["eval_batches"] or loaded_cfg.num_layers != layers:
        raise SystemExit(f"sequence-parallel run took {steps} steps / {evals} evals")
    for name, count in launches.items():
        if count != want[name] or (want[name] and count <= 0):
            raise SystemExit(f"{name} launched {count} times in the ring, expected {want[name]}")
    if not (rec["export_loads_back"] and rec["ranks_hold_the_same_params"]):
        raise SystemExit("the ranks' params differ, or the export does not load back to them")
    return rec


def _fp32_ring_worker(rank, world, port, vocab_size, tgt, layers, out_path):
    """One rank of the fp32 ring check: one step's loss and gradients
    (summed over the ring), written by rank 0."""
    import torch

    from transformer_tpu_torch.config import MeshConfig, TrainConfig
    from transformer_tpu_torch.models.transformer import flatten, init_params
    from transformer_tpu_torch.parallel.distributed import _seq_parallel_forward_loss
    from transformer_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    from transformer_tpu_torch.train.trainer import loss_and_grads

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost", MASTER_PORT=str(port))
    mesh = make_mesh(MeshConfig(seq=world), initialize_distributed("cuda", log_fn=lambda *_: None))
    cfg = long4k_config(vocab_size, num_layers=layers, dtype="float32", attention_impl="ring")
    params = init_params(cfg, torch.Generator().manual_seed(SEED), device=mesh.device)
    for p in flatten(params).values():
        p.requires_grad_(True)
    metrics, grads = loss_and_grads(
        params, torch.from_numpy(tgt).to(mesh.device, torch.long), cfg,
        TrainConfig(batch_size=4, sequence_length=4096), None,
        forward_loss=_seq_parallel_forward_loss(mesh),
    )
    mesh.all_reduce_sum_([*grads.values(), *metrics.values()])
    if rank == 0:
        torch.save({"loss": float(metrics["loss"]), "grads": {k: g.cpu() for k, g in grads.items()}},
                   out_path)
    torch.distributed.destroy_process_group()


def fp32_ring_check(tok, train_ds, layers: int = 2, sp: int = 4):
    """One fp32 step at full width (2 layers, S 4096, batch 4, dropout 0)
    from one init: the sp=4 ring (kernels, four processes on this card)
    against the single-process flash step (kernels). Limits as the fp32
    train check: loss 1e-5 relative, the worst gradient leaf 1e-3, the key
    biases' gradient below 1e-3 of the query biases' on both sides."""
    import socket

    import torch
    import torch.multiprocessing as mp

    from transformer_tpu_torch.config import TrainConfig
    from transformer_tpu_torch.models.transformer import flatten, init_params
    from transformer_tpu_torch.train.trainer import loss_and_grads

    _, tgt = next(iter(train_ds.batches(0)))
    out_path = os.path.join(BUILD_DIR, "fp32_ring_grads.pt")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mp.spawn(_fp32_ring_worker, args=(sp, port, tok.model_vocab_size, tgt, layers, out_path),
             nprocs=sp, join=True)
    ring_s = time.perf_counter() - t0
    ring = torch.load(out_path)
    cfg = long4k_config(tok.model_vocab_size, num_layers=layers, dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(SEED), device="cuda")
    for p in flatten(params).values():
        p.requires_grad_(True)
    metrics, want = loss_and_grads(
        params, torch.from_numpy(tgt).to("cuda", torch.long), cfg,
        TrainConfig(batch_size=4, sequence_length=4096), None,
    )
    want_loss = float(metrics["loss"])
    worst, worst_key, key_bias = 0.0, None, 0.0
    for key, w in want.items():
        g = ring["grads"][key].cuda()
        if key.endswith("self_mha/key/bias"):  # zero up to rounding
            q_key = key.replace("key/bias", "query/bias")
            for grads in ({key: g, q_key: ring["grads"][q_key].cuda()}, want):
                ratio = (grads[key].norm() / grads[q_key].norm().clamp_min(1e-30)).item()
                key_bias = max(key_bias, ratio)
            continue
        rel = ((g - w).norm() / w.norm().clamp_min(1e-30)).item()
        if rel > worst:
            worst, worst_key = rel, key
    loss_rel = abs(ring["loss"] - want_loss) / abs(want_loss)
    rec = {
        "phase": "sp_train", "step": "fp32_ring_check", "layers": layers, "batch": 4,
        "sequence_length": 4096, "processes": sp, "ring_loss": ring["loss"],
        "flash_loss": want_loss, "loss_rel_diff": loss_rel, "grad_worst_rel": worst,
        "grad_worst_leaf": worst_key, "key_bias_grad_ratio": key_bias, "leaves": len(want),
        "ring_seconds": ring_s, "tolerance": TRAIN_TOL,
    }
    emit(rec)
    if not (loss_rel <= TRAIN_TOL["loss_rel"] and worst <= TRAIN_TOL["grad_rel"]
            and key_bias <= TRAIN_TOL["key_bias_ratio"]):
        raise SystemExit(f"fp32 ring check failed: {rec}")


# --------------------------------------------------------------------------
# phase 6: seq2seq training, translation and scoring


S2S_LEN = 64  # --sequence_length of the seq2seq main path (bench.py's seq)
BUCKETS = (16, 32, 48, 64)  # phase 9's --length_buckets


def seq2seq_flash_checks():
    """The flash kernels at the seq2seq path's shapes, bf16 and fp32: the
    encoder's self-attention (B 64, S 64, non-causal, ragged key lengths,
    one row of PAD only), the decoder's (B 64, S 63 after the
    teacher-forcing shift, causal, padded), and the encoders of the big
    (16 x 64 at B 32) and tiny (4 x 32) presets. The bf16 encoder and
    decoder cases are timed."""
    b, s = 64, S2S_LEN
    enc = sentence_lengths(b, s, empty_row=True)
    dec = sentence_lengths(b, s - 1, seed=SEED + 1)
    recs, timed = [], {}
    for dtype in ("bfloat16", "float32"):
        bf16 = dtype == "bfloat16"
        timed_enc = check_flash("seq2seq encoder", dtype, b, s, s, 8, 8, 64, False, None, True,
                                timed=bf16, lengths=enc, device_timed=bf16)
        timed_dec = check_flash("seq2seq decoder", dtype, b, s - 1, s - 1, 8, 8, 64, True, None,
                                True, timed=bf16, lengths=dec, device_timed=bf16)
        recs += [
            timed_enc, timed_dec,
            check_flash("big encoder", dtype, 32, s, s, 16, 16, 64, False, None, True,
                        lengths=sentence_lengths(32, s, seed=SEED + 2, empty_row=True)),
            check_flash("tiny encoder", dtype, b, s, s, 4, 4, 32, False, None, True,
                        lengths=sentence_lengths(b, s, seed=SEED + 3, empty_row=True)),
        ]
        # The length buckets' widths (phase 9, --length_buckets 16,32,48,64):
        # the encoder at S 16, 32, 48 over ragged lengths up to S, the
        # decoder causal at S 15, 31, 47 over lengths from 3. (On a causal
        # sequence of 2 keys the off-by-one fault's bf16 dK can land within
        # 0.002 of the true one on some head, so that fault cannot be read
        # there; the kernel's own readings at 2 keys are held by the
        # encoder cases and the S 63 decoder case.)
        for w in BUCKETS[:-1]:
            recs += [
                check_flash(f"bucket {w} encoder", dtype, b, w, w, 8, 8, 64, False, None, True,
                            lengths=sentence_lengths(b, w, seed=SEED + w, empty_row=True)),
                check_flash(f"bucket {w} decoder", dtype, b, w - 1, w - 1, 8, 8, 64, True, None,
                            True, lengths=sentence_lengths(b, w - 1, seed=SEED + w + 1,
                                                           shortest=3)),
            ]
        if bf16:
            timed = {"encoder": timed_enc, "decoder": timed_dec}
    return recs, timed


def flash_counters():
    from transformer_tpu_torch.kernels.flash_attention import flash_dkdv, flash_dq, flash_fwd

    return flash_fwd, flash_dq, flash_dkdv


def read_flash_counters(reset: bool = False) -> dict:
    out = {fn.__name__: fn.launches for fn in flash_counters()}
    if reset:
        for fn in flash_counters():
            fn.launches = 0
    return out


def seq2seq_train_path(src_vocab, tgt_vocab):
    """``cli.train --preset base --attention_impl flash --sequence_length
    64 --epochs 1`` on the bundled corpus: Transformer-base at full width
    (6 + 6 layers, d 512, 8 heads, dff 2048, bf16, batch 64, dropout 0.1),
    then the epilogue's sample translation, export and BLEU on 200 test
    pairs. The flash counters are set to 0 just before and read just
    after: 12 forward, 12 dQ and 12 dK/dV launches a train step, 12
    forward launches an eval batch, 6 (the encoder) a translate call."""
    import statistics

    import torch

    from transformer_tpu_torch.cli import train
    from transformer_tpu_torch.convert import load_export
    from transformer_tpu_torch.data.pipeline import load_dataset
    from transformer_tpu_torch.models.transformer import flatten

    data = os.path.join(ROOT, "data")
    export = os.path.join(BUILD_DIR, "seq2seq_export")
    argv = [
        "--preset", "base", "--attention_impl", "flash", "--sequence_length", str(S2S_LEN),
        "--epochs", "1", "--dataset_path", data, "--src_vocab_file", src_vocab,
        "--tgt_vocab_file", tgt_vocab, "--export_path", export,
        "--ckpt_path", fresh_dir("ckpt", "seq2seq"), "--device", "cuda",
    ]
    flags = train.resolve_flags(argv)
    t0 = time.perf_counter()
    train_ds, test_ds, _, _ = load_dataset(data, src_vocab, tgt_vocab, batch_size=flags.batch_size,
                                           sequence_length=flags.sequence_length)
    pairs = {
        "train_pairs": train_ds.num_examples, "train_batches": len(train_ds),
        "test_pairs": test_ds.num_examples, "test_batches": len(test_ds),
        "count_seconds": time.perf_counter() - t0,
    }
    logs: list[str] = []
    torch.cuda.reset_peak_memory_stats()
    read_flash_counters(reset=True)
    t0 = time.perf_counter()
    trainer = train.main(argv, log_fn=logs.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_flash_counters()
    peak = torch.cuda.max_memory_allocated()
    cfg = trainer.model_cfg
    steps, evals = len(trainer.step_seconds), trainer.eval_batches
    bleu_line = next((ln for ln in logs if ln.startswith("test BLEU")), "")
    match = re.match(r"test BLEU ([-0-9.naif]+) on (\d+) pairs", bleu_line)
    bleu_pairs = int(match.group(2)) if match else 0
    translate_calls = 1 + -(-bleu_pairs // flags.batch_size)  # the sample + BLEU batches
    layers = 2 * cfg.num_layers
    want = {
        "flash_fwd": layers * (steps + evals) + cfg.num_layers * translate_calls,
        "flash_dq": layers * steps,
        "flash_dkdv": layers * steps,
    }
    params, loaded_cfg = load_export(export, device="cuda")
    same = loaded_cfg == cfg and all(
        torch.equal(a, b.detach()) for a, b in zip(
            flatten(params).values(), flatten(trainer.state.params).values()
        )
    )
    step_s = trainer.step_seconds
    ms = [t * 1e3 for t in step_s]
    later = ms[1:] or ms
    train_loss, eval_loss = trainer.train_metrics.loss, trainer.eval_metrics.loss
    bleu = float(match.group(1)) if match else float("nan")
    rec = {
        "phase": "seq2seq", "step": "fit", "argv": argv, "config": dataclasses.asdict(cfg),
        **pairs, "steps": steps, "eval_batches": evals, "step_ms_first": ms[0],
        "step_ms_median": statistics.median(later), "step_ms_mean": statistics.mean(later),
        "step_ms_all": ms,
        "target_positions_per_s": trainer.tokens / sum(step_s),
        "target_tokens_per_s": trainer.train_metrics.weight / sum(step_s),
        "target_tokens": trainer.train_metrics.weight,
        "fit_and_epilogue_wall_s": wall, "max_memory_allocated_bytes": peak,
        "train_loss": train_loss, "eval_loss": eval_loss, "bleu": bleu,
        "bleu_pairs": bleu_pairs, "translate_calls": translate_calls,
        "launches": launches, "expected_launches": want, "export_loads_back": same,
        "logs": logs,
    }
    emit(rec)
    if not (math.isfinite(train_loss) and math.isfinite(eval_loss) and math.isfinite(bleu)):
        raise SystemExit(f"seq2seq: non-finite loss or BLEU: {train_loss} / {eval_loss} / {bleu}")
    if steps < 1 or evals < 1 or bleu_pairs != 200:
        raise SystemExit(f"seq2seq ran {steps} steps, {evals} eval batches, BLEU on "
                         f"{bleu_pairs} pairs")
    for name, count in launches.items():
        if count <= 0 or count != want[name]:
            raise SystemExit(f"{name} launched {count} times on the seq2seq path, "
                             f"expected {want[name]}")
    if not same:
        raise SystemExit("the seq2seq export does not load back to the trained params")
    return trainer, train_ds, export, launches, rec


def seq2seq_fp32_check(trainer, batch, layers: int = 2):
    """One fp32 seq2seq train step at base width (2 + 2 layers, B 64, S
    64, dropout 0, label smoothing 0.1) on a corpus batch, kernels against
    their plain versions."""
    import dataclasses as dc

    import torch

    from transformer_tpu_torch.config import TrainConfig
    from transformer_tpu_torch.models.transformer import init_params

    cfg = dc.replace(trainer.model_cfg, num_layers=layers, dtype="float32", dropout_rate=0.0)
    tcfg = TrainConfig(batch_size=64, sequence_length=S2S_LEN, label_smoothing=0.1)
    params = init_params(cfg, torch.Generator().manual_seed(SEED), device="cuda")
    src, tgt = (torch.from_numpy(a).to("cuda", torch.long) for a in batch)
    return kernels_vs_plain_step(
        {"phase": "seq2seq", "step": "fp32_train_check", "layers": layers, "batch": 64,
         "sequence_length": S2S_LEN, "label_smoothing": 0.1}, cfg, tcfg, params, tgt, src=src,
    )


def source_sentences(n: int) -> list[str]:
    with open(os.path.join(ROOT, "data", "src-test.txt"), encoding="utf-8") as f:
        return [next(f).strip() for _ in range(n)]


def translate_path(export, src_vocab, tgt_vocab, batch_size: int = 64):
    """``cli.translate`` on the trained export, greedy and ``--beam 4``, on
    8 test sentences read from stdin, then ``cli.evaluate --limit 200 --beam 1``, with the
    flash counters set to 0 just before and read just after (6 forward
    launches, the encoder, per translate call). Greedy and beam are timed
    on the host clock."""
    import torch

    from transformer_tpu_torch.cli import evaluate
    from transformer_tpu_torch.cli import translate as cli_translate

    common = ["--export_path", export, "--src_vocab_file", src_vocab, "--tgt_vocab_file",
              tgt_vocab, "--max_len", str(S2S_LEN), "--device", "cuda"]
    sentences = "".join(line + "\n" for line in source_sentences(8))
    read_flash_counters(reset=True)
    times, outputs = {}, {}
    for beam in (1, 4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outputs[beam] = cli_translate.main(
            common + ["--beam", str(beam)], stdin=io.StringIO(sentences), stdout=io.StringIO()
        )
        torch.cuda.synchronize()
        times[beam] = time.perf_counter() - t0
    out = io.StringIO()
    t0 = time.perf_counter()
    result = evaluate.main(common + ["--src_file", os.path.join(ROOT, "data", "src-test.txt"),
                                     "--tgt_file", os.path.join(ROOT, "data", "tgt-test.txt"),
                                     "--limit", "200", "--beam", "1"], stdout=out)
    eval_s = time.perf_counter() - t0
    launches = read_flash_counters()
    line = out.getvalue().strip()
    evaluate_batches = -(-200 // batch_size)
    want = {"flash_fwd": 6 * (2 + evaluate_batches), "flash_dq": 0, "flash_dkdv": 0}
    rec = {
        "phase": "seq2seq", "step": "translate", "sentences": 8,
        "greedy_wall_s": times[1], "beam4_wall_s": times[4], "evaluate_wall_s": eval_s,
        "greedy": outputs[1], "beam4": outputs[4], "evaluate_json_line": line,
        "launches": launches, "expected_launches": want,
    }
    emit(rec)
    print(line, flush=True)
    if json.loads(line) != result or result["n"] != 200 or not math.isfinite(result["bleu"]):
        raise SystemExit(f"cli.evaluate printed {line!r}")
    if len(outputs[1]) != 8 or len(outputs[4]) != 8:
        raise SystemExit("cli.translate did not answer every sentence")
    if launches != want:
        raise SystemExit(f"translate path launches {launches}, expected {want}")
    return launches, rec


def fp32_decode_tokens_check(trainer, src_tok, tgt_tok, layers: int = 2):
    """Greedy and beam-4 tokens at base width (2 + 2 layers, fp32, random
    weights from the seed) with the flash encoder and with its plain
    version, for 5 test sentences that ``_pad_batch`` fills to 8 rows with
    rows of PAD only: they must be identical. Each decode is also timed on
    the host clock, and greedy and beam under the profiler for device
    time."""
    import dataclasses as dc

    import torch
    from torch.profiler import ProfilerActivity, profile

    from transformer_tpu_torch.models.transformer import init_params
    from transformer_tpu_torch.train.decode import _pad_batch, beam_search_decode, greedy_decode

    cfg = dc.replace(trainer.model_cfg, num_layers=layers, dtype="float32", dropout_rate=0.0)
    params = init_params(cfg, torch.Generator().manual_seed(SEED + 1), device="cuda")
    encoded = [[src_tok.bos_id, *src_tok.encode(t), src_tok.eos_id][:S2S_LEN]
               for t in source_sentences(5)]
    ids, n = _pad_batch(encoded, S2S_LEN)
    src = torch.from_numpy(ids).to("cuda", torch.long)
    ends = (tgt_tok.bos_id, tgt_tok.eos_id)
    tokens, times = {}, {}
    for name, fn in (("greedy", greedy_decode), ("beam4", beam_search_decode)):
        kw = dict(beam_size=4, alpha=0.6) if name == "beam4" else {}
        for reference in (False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tokens[name, reference] = fn(params, src, cfg, S2S_LEN, *ends, reference=reference,
                                         **kw)
            torch.cuda.synchronize()
            times[f"{name}_{'plain' if reference else 'kernels'}_s"] = time.perf_counter() - t0
    device_ms = {}
    for name, fn in (("greedy", greedy_decode), ("beam4", beam_search_decode)):
        kw = dict(beam_size=4, alpha=0.6) if name == "beam4" else {}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(params, src, cfg, S2S_LEN, *ends, **kw)
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
                 for e in prof.key_averages())
        device_ms[name] = us / 1e3 if us else "not measured"
    same = {name: bool(torch.equal(tokens[name, False], tokens[name, True]))
            for name in ("greedy", "beam4")}
    rec = {
        "phase": "seq2seq", "step": "fp32_decode_tokens", "layers": layers, "rows": ids.shape[0],
        "real_rows": n, "identical": same, "host_s": times, "device_ms": device_ms,
        "greedy_tokens_row0": tokens["greedy", False][0].tolist(),
        "beam4_tokens_row0": tokens["beam4", False][0].tolist(),
        "dummy_rows_all_pad": bool((tokens["greedy", False][n:] == 0).all().item()
                                   and (tokens["beam4", False][n:] == 0).all().item()),
    }
    emit(rec)
    if not all(same.values()) or not rec["dummy_rows_all_pad"]:
        raise SystemExit(f"flash vs plain encoder decode tokens differ: {rec}")
    return rec


def presets_path(src_vocab, tgt_vocab, joint_vocab, pairs: int = 1280):
    """The tiny, big and tied presets through ``cli.train --attention_impl
    flash`` for one epoch on the first ``pairs`` corpus pairs (and 64 test
    pairs), BLEU off: losses finite, every flash kernel launched."""
    import shutil as sh

    import torch

    from transformer_tpu_torch.cli import train

    data = cut_corpus(pairs)
    recs = []
    for preset in ("tiny", "big", "tied"):
        src_v, tgt_v = (joint_vocab, joint_vocab) if preset == "tied" else (src_vocab, tgt_vocab)
        export = os.path.join(BUILD_DIR, f"seq2seq_{preset}_export")
        argv = ["--preset", preset, "--attention_impl", "flash", "--sequence_length",
                str(S2S_LEN), "--epochs", "1", "--dataset_path", data, "--src_vocab_file", src_v,
                "--tgt_vocab_file", tgt_v, "--export_path", export, "--eval_bleu", "false",
                "--ckpt_path", fresh_dir("ckpt", preset), "--device", "cuda"]
        read_flash_counters(reset=True)
        t0 = time.perf_counter()
        trainer = train.main(argv, log_fn=lambda _: None)
        torch.cuda.synchronize()
        cfg = trainer.model_cfg
        rec = {
            "phase": "seq2seq", "step": "preset", "preset": preset, "wall_s":
            time.perf_counter() - t0, "steps": len(trainer.step_seconds),
            "layers": cfg.num_layers, "d_model": cfg.d_model, "heads": cfg.num_heads,
            "tied": [cfg.tie_embeddings, cfg.tie_output],
            "label_smoothing": trainer.train_cfg.label_smoothing,
            "train_loss": trainer.train_metrics.loss, "eval_loss": trainer.eval_metrics.loss,
            "launches": read_flash_counters(),
        }
        emit(rec)
        recs.append(rec)
        ok = (math.isfinite(rec["train_loss"]) and math.isfinite(rec["eval_loss"])
              and rec["steps"] > 0 and all(n > 0 for n in rec["launches"].values()))
        del trainer
        sh.rmtree(export, ignore_errors=True)
        fresh_dir("ckpt", preset)
        torch.cuda.empty_cache()
        if not ok:
            raise SystemExit(f"preset {preset} failed: {rec}")
    return recs


# --------------------------------------------------------------------------
# phase 8: checkpoints, resume, preemption and export on the base path


# 1,300 corpus pairs leave 1,293 under the 64-token filter: 20 steps of 64
# an epoch (the first 1,280 leave 19).
CKPT_PAIRS = 1300


def ckpt_argv(data, src_vocab, tgt_vocab, root, name, epochs, *extra):
    """``cli.train --preset base --attention_impl flash --sequence_length
    64 --grad_accum 2`` on the cut corpus, checkpointing to ``root/name``."""
    return [
        "--preset", "base", "--attention_impl", "flash", "--sequence_length", str(S2S_LEN),
        "--grad_accum", "2", "--epochs", str(epochs), "--dataset_path", data,
        "--src_vocab_file", src_vocab, "--tgt_vocab_file", tgt_vocab,
        "--ckpt_path", os.path.join(root, name), "--export_path", os.path.join(root, f"{name}_export"),
        "--eval_bleu", "false", "--device", "cuda", *extra,
    ]


def ckpt_fit(argv, phase_launches: dict):
    """One ``cli.train`` run in this process with the flash counters set to
    0 just before and read just after (added to ``phase_launches``), held
    to 12 launches of each kernel a micro-step (24 a step at
    ``--grad_accum 2``), 12 forward launches an eval batch and 6 for the
    epilogue's sample translation. Returns (trainer, logs, record)."""
    import statistics

    import torch

    from transformer_tpu_torch.cli import train
    from transformer_tpu_torch.convert import params_digest

    logs: list[str] = []
    read_flash_counters(reset=True)
    t0 = time.perf_counter()
    trainer = train.main(argv, log_fn=logs.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_flash_counters()
    for name, count in launches.items():
        phase_launches[name] += count
    cfg, accum = trainer.model_cfg, trainer.train_cfg.grad_accum_steps
    steps, evals, layers = len(trainer.step_seconds), trainer.eval_batches, 2 * cfg.num_layers
    want = {
        "flash_fwd": layers * (accum * steps + evals) + cfg.num_layers,
        "flash_dq": layers * accum * steps,
        "flash_dkdv": layers * accum * steps,
    }
    ms = [t * 1e3 for t in trainer.step_seconds] or [float("nan")]
    rec = {
        "epochs": trainer.train_cfg.epochs, "steps": steps, "final_step": trainer.state.step,
        "eval_batches": evals, "wall_s": wall, "step_ms_median": statistics.median(ms),
        "step_ms_mean": statistics.mean(ms), "step_ms_first": ms[0],
        "launches": launches, "expected_launches": want,
        "train_loss": trainer.train_metrics.loss, "params_sha256": params_digest(trainer.state.params),
        "logs": [ln for ln in logs if not ln.startswith("sample translation")],
    }
    if launches != want:
        raise SystemExit(f"checkpoints: launches {launches}, expected {want}: {rec}")
    return trainer, logs, rec


def params_spread(a, b) -> dict:
    """Largest absolute difference between two parameter sets, and the
    leaves that differ."""
    from transformer_tpu_torch.models.transformer import flatten

    fa, fb = flatten(a), flatten(b)
    diffs = {k: (fa[k].detach() - fb[k].detach()).abs().max().item() for k in fa}
    return {"max_abs": max(diffs.values()), "leaves": sorted(k for k, d in diffs.items() if d)}


def preempted_run(argv, steps_per_epoch: int) -> dict:
    """``cli.train ... --async_checkpoint`` in a subprocess; SIGTERM is sent
    when it logs the end of epoch 1, so it lands in epoch 2's first steps.
    The run must log ``preemption (signal 15) at step S: checkpoint saved
    to ...`` with S in epoch 2 and exit 0."""
    import signal

    cmd = [sys.executable, "-u", "-m", "transformer_tpu_torch.cli.train", *argv]
    env = {**os.environ, "PYTHONPATH": ROOT, "PYTHONUNBUFFERED": "1"}
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines, signalled = [], None
    try:
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            if signalled is None and line.startswith("epoch 1/2 done"):
                proc.send_signal(signal.SIGTERM)
                signalled = time.perf_counter() - t0
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    found = [re.fullmatch(r"preemption \(signal (\d+)\) at step (\d+): checkpoint saved to (.+)", ln)
             for ln in lines]
    found = [m for m in found if m]
    rec = {"exit_code": rc, "signalled_after_s": signalled, "wall_s": time.perf_counter() - t0,
           "logs": [ln for ln in lines if not ln.startswith("sample translation")][-12:]}
    if rc != 0 or signalled is None or len(found) != 1:
        raise SystemExit(f"checkpoints: the preempted run did not save on SIGTERM: {rec}")
    signum, step, path = int(found[0].group(1)), int(found[0].group(2)), found[0].group(3)
    rec.update(signal=signum, step=step, path=path)
    if signum != signal.SIGTERM or not steps_per_epoch < step <= 2 * steps_per_epoch:
        raise SystemExit(f"checkpoints: preemption at step {step} is not in epoch 2: {rec}")
    return rec


def flip_byte(path: str) -> int:
    """Flip one byte in the middle of ``path``; returns its offset."""
    offset = os.path.getsize(path) // 2
    with open(path, "r+b") as f:
        f.seek(offset)
        byte = f.read(1)
        f.seek(offset)
        f.write(bytes([byte[0] ^ 0xFF]))
    return offset


def save_timings(state, root, reps: int = 2) -> dict:
    """Host time the train loop is blocked in ``save`` (sync: snapshot and
    write; async: the snapshot, the write left to the worker), the async
    write's time to durable, and ``restore_latest`` (read, manifest check,
    copy to the card) of the state at full width."""
    import torch

    from transformer_tpu_torch.convert import params_digest
    from transformer_tpu_torch.train.checkpoint import (
        AsyncCheckpointManager,
        CheckpointManager,
        verify_manifest,
    )

    sync = CheckpointManager(os.path.join(root, "timing_sync"), max_to_keep=1)
    asyn = AsyncCheckpointManager(os.path.join(root, "timing_async"), max_to_keep=1)
    out = {k: [] for k in ("sync_save_s", "async_stall_s", "async_durable_s",
                           "restore_and_verify_s", "verify_s")}
    digest = params_digest(state.params)
    for i in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sync.save(state, step=i)
        out["sync_save_s"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        asyn.save(state, step=i)
        out["async_stall_s"].append(time.perf_counter() - t0)
        asyn.wait()
        out["async_durable_s"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        verify_manifest(sync.path(i))
        out["verify_s"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        restored = sync.restore_latest(state)
        torch.cuda.synchronize()
        out["restore_and_verify_s"].append(time.perf_counter() - t0)
        if params_digest(restored.params) != digest or restored.step != state.step:
            raise SystemExit("checkpoints: a restored state differs from the saved one")
        del restored
    return out


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, n)) for n in os.listdir(path))


def ckpt_fp32_accum_check(model_cfg, batch, layers: int = 2):
    """One fp32 train step at base width (2 + 2 layers, B 64, S 64, dropout
    0, kernels on) with ``grad_accum_steps=2`` against the whole batch:
    loss and every gradient leaf held to TRAIN_TOL."""
    import dataclasses as dc

    import torch

    from transformer_tpu_torch.config import TrainConfig
    from transformer_tpu_torch.models.transformer import flatten, init_params, unflatten
    from transformer_tpu_torch.train.state import TrainState
    from transformer_tpu_torch.train.trainer import make_train_step

    class Capture:  # an optimizer that keeps the gradients and moves nothing
        def update(self, grads, state, params=None):
            self.grads = grads
            return {k: torch.zeros_like(g) for k, g in grads.items()}, state

    cfg = dc.replace(model_cfg, num_layers=layers, dtype="float32", dropout_rate=0.0)
    params = init_params(cfg, torch.Generator().manual_seed(SEED), device="cuda")
    runs = []
    for accum in (2, 1):
        tcfg = TrainConfig(batch_size=64, sequence_length=S2S_LEN, grad_accum_steps=accum)
        p = unflatten({k: v.clone().requires_grad_() for k, v in flatten(params).items()})
        cap = Capture()
        _, m = make_train_step(cfg, tcfg, tx=cap)(TrainState(0, p, None), *batch)
        runs.append((float(m["loss"]), cap.grads))
    return hold_to_train_tol(
        {"phase": "checkpoints", "step": "fp32_grad_accum_check", "layers": layers, "batch": 64,
         "sequence_length": S2S_LEN, "grad_accum": 2, "against": "the whole batch, kernels on"},
        runs[0], runs[1], "fp32 grad_accum 2 against the whole batch",
    )


def checkpoints_path(src_vocab, tgt_vocab):
    """U: ``cli.train`` base/flash/``--grad_accum 2`` for 2 epochs. R: the
    same for 1 epoch, then relaunched for 2 on its directory, which must
    restore, resume at epoch 2 and end bit-identical to U (if it does not,
    U runs again: a U-to-U spread names nondeterminism and holds R to it).
    P: U in a subprocess with ``--async_checkpoint``, SIGTERM in epoch 2;
    its checkpoint must verify against its manifest, a relaunch resume at
    epoch 2 and end n steps later; one byte flipped in the newest
    checkpoint's arrays.npz, the next relaunch must fall back to the step
    before. Then save and restore timings, ``cli.export --average_last 2
    --quantize int8`` from R (within the int8 bound of the fp32 average,
    smaller than fp32), ``cli.translate`` and ``cli.evaluate --limit 200``
    on it, and the fp32 accumulation check. Returns the flash launches of
    the phase's in-process runs."""
    import numpy as np
    import torch

    from transformer_tpu_torch.cli import evaluate
    from transformer_tpu_torch.cli import export as cli_export
    from transformer_tpu_torch.cli import translate as cli_translate
    from transformer_tpu_torch.convert import load_export
    from transformer_tpu_torch.data.pipeline import load_dataset
    from transformer_tpu_torch.models.transformer import flatten
    from transformer_tpu_torch.train.checkpoint import (
        CheckpointManager,
        _q8_group_axes,
        load_manifest,
        verify_manifest,
    )

    data = cut_corpus(CKPT_PAIRS)
    root = fresh_dir("ckpt", "checkpoints")
    launches = {fn.__name__: 0 for fn in flash_counters()}

    def argv(name, epochs, *extra):
        return ckpt_argv(data, src_vocab, tgt_vocab, root, name, epochs, *extra)

    # U and R
    u, _, u_rec = ckpt_fit(argv("u", 2), launches)
    n = u_rec["steps"] // 2
    r1, _, r1_rec = ckpt_fit(argv("r", 1), launches)
    del r1
    r, r_logs, r_rec = ckpt_fit(argv("r", 2), launches)
    resumed = (f"restored checkpoint at step {n}" in r_logs
               and f"resuming at epoch 2/2 (step {n})" in r_logs and r_rec["steps"] == n)
    rec = {"phase": "checkpoints", "step": "resume", "card": nvidia_smi_line(),
           "steps_per_epoch": n, "U": u_rec, "R_epoch_1": r1_rec, "R_relaunch": r_rec,
           "bit_identical": r_rec["params_sha256"] == u_rec["params_sha256"]}
    if not rec["bit_identical"]:
        u2, _, u2_rec = ckpt_fit(argv("u2", 2), launches)
        rec["U_again"] = u2_rec
        rec["u_to_u_spread"] = params_spread(u.state.params, u2.state.params)
        rec["r_to_u_spread"] = params_spread(r.state.params, u.state.params)
        del u2
    emit(rec)
    if n != 20 or u_rec["final_step"] != 2 * n or not resumed:
        raise SystemExit(f"checkpoints: U took {u_rec['steps']} steps, or R did not resume at "
                         f"epoch 2 (step {n}): {r_rec['logs']}")
    if not rec["bit_identical"] and not (
            0 < rec["r_to_u_spread"]["max_abs"] <= rec["u_to_u_spread"]["max_abs"]):
        raise SystemExit(f"checkpoints: R differs from U beyond U's own spread: {rec}")
    del u
    torch.cuda.empty_cache()

    # P: preempted, relaunched, then a byte flipped in the newest checkpoint
    pre = preempted_run(argv("p", 2, "--async_checkpoint"), n)
    s = pre["step"]
    p_mgr = CheckpointManager(os.path.join(root, "p"))
    pre["manifest_digest"] = verify_manifest(p_mgr.path(s))
    if pre["path"] != p_mgr.path(s) or p_mgr.all_steps() != [s]:
        raise SystemExit(f"checkpoints: the preempted run left {p_mgr.all_steps()}: {pre}")
    p1, p1_logs, p1_rec = ckpt_fit(argv("p", 2), launches)
    relaunched = (f"resuming at epoch 2/2 (step {s})" in p1_logs and p1_rec["final_step"] == s + n)
    offset = flip_byte(os.path.join(p_mgr.path(s + n), "arrays.npz"))
    p2, p2_logs, p2_rec = ckpt_fit(argv("p", 2), launches)
    fell_back = (any(ln.startswith(f"checkpoint at step {s + n} unreadable") for ln in p2_logs)
                 and f"restored checkpoint at step {s}" in p2_logs
                 and p2_rec["final_step"] == s + n)
    rec = {"phase": "checkpoints", "step": "preempt", "card": nvidia_smi_line(),
           "preempted": pre, "relaunch": p1_rec, "flipped_byte_at": offset,
           "relaunch_after_the_flip": p2_rec,
           "flip_relaunch_equals_first_relaunch": p2_rec["params_sha256"] == p1_rec["params_sha256"]}
    emit(rec)
    if not (relaunched and fell_back):
        raise SystemExit(f"checkpoints: preempted run's relaunches failed: {rec}")
    del p1, p2
    torch.cuda.empty_cache()

    # what a checkpoint costs at full width
    r_mgr = CheckpointManager(os.path.join(root, "r"))
    timings = save_timings(r.state, root)
    rec = {"phase": "checkpoints", "step": "timings", "card": nvidia_smi_line(),
           "checkpoint_bytes": dir_bytes(r_mgr.path(2 * n)),
           "arrays_npz_bytes": os.path.getsize(os.path.join(r_mgr.path(2 * n), "arrays.npz")),
           "leaves": len(load_manifest(r_mgr.path(2 * n))["arrays"]),
           **timings,
           "timers": "host clock (time.perf_counter) around save / wait / verify_manifest / "
                     "restore_latest + synchronize, after a synchronize; files in the page cache"}
    emit(rec)

    # export: the average of R's two checkpoints, int8 and fp32
    common = ["--preset", "base", "--attention_impl", "flash", "--sequence_length", str(S2S_LEN),
              "--src_vocab_file", src_vocab, "--tgt_vocab_file", tgt_vocab,
              "--ckpt_path", r_mgr.directory, "--average_last", "2", "--device", "cuda"]
    q8, fp = os.path.join(root, "q8_export"), os.path.join(root, "fp32_export")
    t0 = time.perf_counter()
    steps = cli_export.main(common + ["--quantize", "int8", "--export_path", q8],
                            log_fn=lambda _: None)
    q8_s = time.perf_counter() - t0
    cli_export.main(common + ["--export_path", fp], log_fn=lambda _: None)
    got, cfg = load_export(q8, device="cuda")
    want, want_cfg = load_export(fp, device="cuda")
    # Every quantized element within half its group's quantization step of
    # the fp32 average, as the JAX package's int8 test holds it, plus the
    # fp32 rounding of the codes' division and the dequantizing product
    # (one spacing of the group's largest value and of the result) where
    # that test allows a flat 1e-8; elements past the flat 1e-8 are counted.
    worst, quantized, outside, past_flat = 0.0, 0, [], 0
    for key, w in flatten(want).items():
        w, g = w.float().cpu().numpy(), flatten(got)[key].float().cpu().numpy()
        if w.ndim < 2 or w.size < 1024 or key.endswith("/bias"):
            if not (g == w).all():
                outside.append(key)
            continue
        quantized += 1
        amax = np.max(np.abs(w), axis=_q8_group_axes(key, w), keepdims=True)
        half, err = amax / 127.0 * 0.5, np.abs(w - g)
        if not np.all(err <= half + np.spacing(amax) + np.spacing(np.abs(g))):
            outside.append(key)
        past_flat += int(np.count_nonzero(err > half + 1e-8))
        worst = max(worst, float((err / np.maximum(half, 1e-30)).max()))
    sizes = {"int8_params_npz_bytes": os.path.getsize(os.path.join(q8, "params.npz")),
             "fp32_params_npz_bytes": os.path.getsize(os.path.join(fp, "params.npz"))}
    tr_common = ["--export_path", q8, "--src_vocab_file", src_vocab, "--tgt_vocab_file",
                 tgt_vocab, "--max_len", str(S2S_LEN), "--device", "cuda"]
    sentences = "".join(line + "\n" for line in source_sentences(8))
    read_flash_counters(reset=True)
    greedy = cli_translate.main(tr_common + ["--beam", "1"], stdin=io.StringIO(sentences),
                                stdout=io.StringIO())
    out = io.StringIO()
    result = evaluate.main(tr_common + ["--src_file", os.path.join(ROOT, "data", "src-test.txt"),
                                        "--tgt_file", os.path.join(ROOT, "data", "tgt-test.txt"),
                                        "--limit", "200", "--beam", "1"], stdout=out)
    for name, count in read_flash_counters().items():
        launches[name] += count
    line = out.getvalue().strip()
    rec = {"phase": "checkpoints", "step": "export", "card": nvidia_smi_line(),
           "averaged_steps": steps, "int8_export_s": q8_s, **sizes,
           "int8_to_fp32": sizes["int8_params_npz_bytes"] / sizes["fp32_params_npz_bytes"],
           "quantized_leaves": quantized, "worst_error_in_half_steps": worst,
           "leaves_outside_the_bound": outside, "elements_past_a_flat_1e-8": past_flat,
           "greedy": greedy, "evaluate_json_line": line}
    emit(rec)
    print(line, flush=True)
    if steps != [n, 2 * n] or cfg != want_cfg or quantized == 0 or outside:
        raise SystemExit(f"checkpoints: the int8 export is not within its bound: {rec}")
    if sizes["int8_params_npz_bytes"] >= sizes["fp32_params_npz_bytes"] / 2.5:
        raise SystemExit(f"checkpoints: the int8 export is not smaller than fp32: {rec}")
    if len(greedy) != 8 or json.loads(line) != result or result["n"] != 200 \
            or not math.isfinite(result["bleu"]):
        raise SystemExit(f"checkpoints: translate/evaluate on the int8 export failed: {rec}")

    train_ds, _, _, _ = load_dataset(data, src_vocab, tgt_vocab, batch_size=64,
                                     sequence_length=S2S_LEN)
    ckpt_fp32_accum_check(r.model_cfg, next(iter(train_ds.batches(0))))
    del r
    torch.cuda.empty_cache()
    fresh_dir("ckpt", "checkpoints")
    return launches


# --------------------------------------------------------------------------
# phase 9: steps_per_dispatch (the step replayed from a CUDA graph), length
# buckets and the "dots" remat policy


def dispatch_argv(data, src_vocab, tgt_vocab, root, name, epochs, k, *extra):
    """``cli.train --preset base --attention_impl flash --sequence_length
    64 --steps_per_dispatch k`` on the cut corpus, checkpointing to
    ``root/name``."""
    return [
        "--preset", "base", "--attention_impl", "flash", "--sequence_length", str(S2S_LEN),
        "--steps_per_dispatch", str(k), "--epochs", str(epochs), "--dataset_path", data,
        "--src_vocab_file", src_vocab, "--tgt_vocab_file", tgt_vocab,
        "--ckpt_path", os.path.join(root, name), "--export_path", os.path.join(root, f"{name}_export"),
        "--eval_bleu", "false", "--device", "cuda", *extra,
    ]


def memory_mark() -> int:
    """Collect what earlier runs left for the garbage collector, reset the
    peak and return the bytes still allocated: a run's peak above this
    mark is its own."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def dispatch_fit(argv, launches: dict, epoch_steps: int):
    """``ckpt_fit`` (counters held to 12 launches of each kernel a step, 12
    forward launches an eval batch, 6 for the sample translation) with the
    run's captures, peak memory and real target tokens per second of its
    last epoch (``epoch_steps`` steps)."""
    import torch

    mark = memory_mark()
    trainer, logs, rec = ckpt_fit(argv, launches)
    graph = trainer.graph
    last = trainer.step_seconds[-epoch_steps:]
    rec.update({
        "steps_per_dispatch": trainer.train_cfg.steps_per_dispatch,
        "dispatches": [k for k, _ in trainer.dispatches],
        "captures": 0 if graph is None else len(graph.captures),
        "capture_s_by_shape": [] if graph is None else [
            {"src": list(sig[0]), "tgt": list(sig[1]), "seconds": sec}
            for sig, sec in graph.captures],
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "peak_above_start_bytes": torch.cuda.max_memory_allocated() - mark,
        "target_tokens_per_s_last_epoch": trainer.train_metrics.weight / sum(last),
        "eval_loss": trainer.eval_metrics.loss,
    })
    if not (math.isfinite(rec["train_loss"]) and math.isfinite(rec["eval_loss"])):
        raise SystemExit(f"dispatch: non-finite loss: {rec}")
    return trainer, logs, rec


def window_profile(trainer, batches, k, label):
    """Busy share of one window of the run's own step: one ``k``-step
    dispatch (k > 1: the replayed graph) or 3 single steps (k = 1), on the
    host clock, then a second window under ``torch.profiler`` for the
    device time and the host's launch calls. ``batches`` holds three
    windows' worth of one shape."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    n = k if k > 1 else 3

    def window(part):
        if k > 1:
            src, tgt = np.stack([b[0] for b in part]), np.stack([b[1] for b in part])
            trainer.state, _ = trainer.multi_step(trainer.state, src, tgt)
        else:
            for src, tgt in part:
                trainer.state, _ = trainer.train_step(trainer.state, src, tgt)

    window(batches[:n])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    window(batches[n : 2 * n])
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    tokens = sum(int((tgt[:, 1:] != 0).sum()) for _, tgt in batches[n : 2 * n])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        window(batches[2 * n : 3 * n])
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    averages = prof.key_averages()
    device_us = sum(dev_us(e) for e in averages
                    if str(getattr(e, "device_type", "")).endswith("CUDA"))
    launch_calls = {e.key: e.count for e in averages
                    if "Launch" in e.key and e.key.startswith("cu")}
    rec = {
        "phase": "dispatch", "step": "window_profile", "run": label, "card": nvidia_smi_line(),
        "steps": n, "steps_per_dispatch": k, "wall_ms": wall_ms, "wall_ms_per_step": wall_ms / n,
        "target_tokens": tokens, "target_tokens_per_s": tokens / wall_ms * 1e3,
        "device_ms": device_us / 1e3 if device_us else "not measured",
        "device_ms_per_step": device_us / 1e3 / n if device_us else "not measured",
        "device_busy_share": device_us / 1e3 / wall_ms if device_us else "not measured",
        "launch_calls": launch_calls,
        "launch_calls_per_step": {name: c / n for name, c in launch_calls.items()},
        "timers": "wall: host clock around one window ending in a synchronize; device: "
                  "torch.profiler's device time over a second window of the same size",
    }
    emit(rec)
    return rec


def batches_of_width(train_ds, width, count, epochs=12):
    """``count`` train batches ``width`` columns wide, from successive
    epochs' orders."""
    out = []
    for epoch in range(epochs):
        out += [b for b in train_ds.batches(epoch) if b[1].shape[1] == width]
        if len(out) >= count:
            return out[:count]
    raise SystemExit(f"dispatch: fewer than {count} batches of width {width}")


def dispatch_path(src_vocab, tgt_vocab, full_export):
    """E: base for 2 epochs at ``--steps_per_dispatch 1`` (eager steps). D:
    the same at 8 (groups of 8, 8 and 4 an epoch, each step a replay of
    the one captured graph): its parameters must equal E's bit for bit
    (else within 1e-6 of each leaf's largest value, the differing leaves
    named) and its flash counters E's. RD: 1 epoch at 8, relaunched to 2,
    must log the resume and end with D's parameters. BK: one epoch at
    ``--length_buckets 16,32,48,64 --steps_per_dispatch 8``: one capture
    per bucket that occurs. Then long4k with ``--remat_policy dots`` at 1
    and at 4 steps a dispatch against phase 5's full-remat export
    (``full_export``): bit for bit. E, D, BK and the dots runs each get a
    profiled window, and long4k with full remat at 4 steps a dispatch too
    (the same memory mark and card state as the dots runs). Returns the
    flash launches of the phase's runs."""
    import statistics

    import torch

    from transformer_tpu_torch.cli import train
    from transformer_tpu_torch.convert import load_export, params_digest
    from transformer_tpu_torch.data.pipeline import load_dataset, load_lm_splits
    from transformer_tpu_torch.models.transformer import flatten

    data = cut_corpus(CKPT_PAIRS)
    root = fresh_dir("ckpt", "dispatch")
    launches = {fn.__name__: 0 for fn in flash_counters()}
    train_ds = load_dataset(data, src_vocab, tgt_vocab, batch_size=64,
                            sequence_length=S2S_LEN)[0]
    n = len(train_ds)

    def argv(name, epochs, k, *extra):
        return dispatch_argv(data, src_vocab, tgt_vocab, root, name, epochs, k, *extra)

    # E and D
    e, _, e_rec = dispatch_fit(argv("e", 2, 1), launches, n)
    e_params = {k: v.detach().clone() for k, v in flatten(e.state.params).items()}
    profiles = {"E": window_profile(e, batches_of_width(train_ds, S2S_LEN, 9), 1, "E")}
    del e
    torch.cuda.empty_cache()
    d, _, d_rec = dispatch_fit(argv("d", 2, 8), launches, n)
    diff = {key: ((v.detach() - e_params[key]).abs().max()
                  / e_params[key].abs().max().clamp_min(1e-30)).item()
            for key, v in flatten(d.state.params).items()}
    profiles["D"] = window_profile(d, batches_of_width(train_ds, S2S_LEN, 24), 8, "D")
    del d, e_params
    torch.cuda.empty_cache()
    rec = {
        "phase": "dispatch", "step": "eager_vs_replay", "card": nvidia_smi_line(),
        "steps_per_epoch": n, "E": e_rec, "D": d_rec,
        "bit_identical": d_rec["params_sha256"] == e_rec["params_sha256"],
        "worst_leaf_rel_diff": max(diff.values()),
        "differing_leaves": sorted(k for k, v in diff.items() if v),
        "launches_equal": d_rec["launches"] == e_rec["launches"],
    }
    emit(rec)
    groups = [min(8, n - i) for i in range(0, n, 8)] * 2
    if d_rec["dispatches"] != groups or e_rec["dispatches"] != [1] * 2 * n:
        raise SystemExit(f"dispatch: D dispatched {d_rec['dispatches']}, expected {groups}")
    if not rec["launches_equal"] or d_rec["captures"] != 1 or e_rec["captures"] != 0:
        raise SystemExit(f"dispatch: counters or captures differ between E and D: {rec}")
    if not rec["bit_identical"] and rec["worst_leaf_rel_diff"] > 1e-6:
        raise SystemExit(f"dispatch: D's parameters differ from E's beyond 1e-6: {rec}")

    # RD: resumed at K 8
    _, _, rd1_rec = dispatch_fit(argv("rd", 1, 8), launches, n)
    rd, rd_logs, rd_rec = dispatch_fit(argv("rd", 2, 8), launches, n)
    resumed = (f"restored checkpoint at step {n}" in rd_logs
               and f"resuming at epoch 2/2 (step {n})" in rd_logs)
    rec = {"phase": "dispatch", "step": "resume", "card": nvidia_smi_line(),
           "RD_epoch_1": rd1_rec, "RD_relaunch": rd_rec, "resumed": resumed,
           "equals_D": rd_rec["params_sha256"] == d_rec["params_sha256"]}
    emit(rec)
    if not (resumed and rec["equals_D"] and rd_rec["final_step"] == 2 * n):
        raise SystemExit(f"dispatch: the run resumed at K 8 does not end as D: {rec}")
    del rd
    torch.cuda.empty_cache()

    # BK: length buckets
    bk_ds = load_dataset(data, src_vocab, tgt_vocab, batch_size=64, sequence_length=S2S_LEN,
                         length_buckets=BUCKETS)[0]
    widths = sorted({tgt.shape[1] for _, tgt in bk_ds.batches(0)})
    bk, _, bk_rec = dispatch_fit(
        argv("bk", 1, 8, "--length_buckets", ",".join(map(str, BUCKETS))), launches, len(bk_ds))
    captured = sorted(c["tgt"][1] for c in bk_rec["capture_s_by_shape"])
    wide = max(widths, key=lambda w: sum(1 for _, t in bk_ds.batches(0) if t.shape[1] == w))
    profiles["BK"] = window_profile(bk, batches_of_width(bk_ds, wide, 24), 8, f"BK width {wide}")
    rec = {"phase": "dispatch", "step": "buckets", "card": nvidia_smi_line(), "BK": bk_rec,
           "bucket_batches": {w: sum(1 for _, t in bk_ds.batches(0) if t.shape[1] == w)
                              for w in widths},
           "widths_in_epoch": widths, "captured_widths": captured,
           "padded_positions_per_epoch": sum(t.size for _, t in bk_ds.batches(0)),
           "flat_positions_per_epoch": n * 64 * S2S_LEN}
    emit(rec)
    if captured != widths:
        raise SystemExit(f"dispatch: BK captured widths {captured}, its epoch has {widths}")
    del bk
    torch.cuda.empty_cache()

    # long4k under the "dots" policy at K 1 and K 4, and full remat at K 4,
    # each against phase 5's full remat at K 1
    want = params_digest(load_export(full_export, device="cuda")[0])
    lm_ds = load_lm_splits(os.path.join(ROOT, "data"), tgt_vocab, batch_size=4,
                           sequence_length=4096)[0]
    dots = {}
    for policy, k in (("dots", 1), ("dots", 4), ("full", 4)):
        name = f"{policy} K{k}"
        lm_argv = ["--preset", "long4k", "--remat_policy", policy, "--steps_per_dispatch", str(k),
                   "--epochs", "1", "--dataset_path", os.path.join(ROOT, "data"),
                   "--tgt_vocab_file", tgt_vocab,
                   "--export_path", os.path.join(root, f"{policy}{k}_export"),
                   "--ckpt_path", os.path.join(root, f"{policy}{k}"), "--device", "cuda"]
        logs: list[str] = []
        read_flash_counters(reset=True)
        mark = memory_mark()
        t0 = time.perf_counter()
        tr = train.main(lm_argv, log_fn=logs.append)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_flash_counters()
        for kernel, count in got.items():
            launches[kernel] += count
        cfg, steps = tr.model_cfg, len(tr.step_seconds)
        expect = {"flash_fwd": cfg.num_layers * (2 * steps + tr.eval_batches),
                  "flash_dq": cfg.num_layers * steps, "flash_dkdv": cfg.num_layers * steps}
        ms = [t * 1e3 for t in tr.step_seconds]
        dots[name] = {
            "argv": lm_argv, "steps_per_dispatch": k, "steps": steps,
            "dispatches": [j for j, _ in tr.dispatches],
            "wall_s": wall, "step_ms_median": statistics.median(ms),
            "step_ms_mean": statistics.mean(ms), "step_ms_first": ms[0],
            "captures": 0 if tr.graph is None else len(tr.graph.captures),
            "capture_s_by_shape": [] if tr.graph is None else [
                {"tgt": list(sig[1]), "seconds": sec} for sig, sec in tr.graph.captures],
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "peak_above_start_bytes": torch.cuda.max_memory_allocated() - mark,
            "target_positions_per_s": tr.tokens / sum(tr.step_seconds),
            "target_tokens_per_s": tr.train_metrics.weight / sum(tr.step_seconds),
            "train_loss": tr.train_metrics.loss, "launches": got, "expected_launches": expect,
            "params_sha256": params_digest(tr.state.params), "equals_full_remat":
                params_digest(tr.state.params) == want,
        }
        profiles[f"long4k {name}"] = window_profile(
            tr, list(lm_ds.batches(1))[: 3 * (k if k > 1 else 3)], k, f"long4k {name}")
        del tr
        torch.cuda.empty_cache()
    rec = {"phase": "dispatch", "step": "dots", "card": nvidia_smi_line(),
           "phase_5_full_remat_params_sha256": want, **dots}
    emit(rec)
    for name, r in dots.items():
        if r["launches"] != r["expected_launches"] or not math.isfinite(r["train_loss"]):
            raise SystemExit(f"dispatch: long4k {name}: {r}")
        if not r["equals_full_remat"] or r["captures"] != (1 if r["steps_per_dispatch"] > 1 else 0):
            raise SystemExit(f"dispatch: long4k {name} differs from phase 5's full remat: {rec}")
    emit({"phase": "dispatch", "step": "summary", "card": nvidia_smi_line(),
          "runs": {
              label: {key: r.get(key) for key in (
                  "steps_per_dispatch", "step_ms_median", "step_ms_mean", "step_ms_first",
                  "captures", "capture_s_by_shape", "target_tokens_per_s_last_epoch",
                  "target_tokens_per_s", "max_memory_allocated_bytes", "peak_above_start_bytes")}
              for label, r in (("E", e_rec), ("D", d_rec), ("BK", bk_rec),
                               *((f"long4k {n}", r) for n, r in dots.items()))},
          "windows": {label: {key: p[key] for key in (
              "wall_ms_per_step", "device_ms_per_step", "device_busy_share",
              "target_tokens_per_s", "launch_calls_per_step")}
              for label, p in profiles.items()}})
    fresh_dir("ckpt", "dispatch")
    return launches


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
    reports = build.build(["paged_attention", "fused_ln_ffn", "flash_attention"])
    emit({
        "phase": "build", "seconds": time.perf_counter() - t0,
        "ptxas": {
            name: [ln.strip() for ln in rep.splitlines()
                   if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
            for name, rep in reports.items()
        },
    })
    sass_hgmma(list(reports))

    # 3. kernels against their plain versions, long4k shapes
    spread = [1, 100, 517, 1024, 1700, 2048, 3001, 4096]
    b_recs = []
    for s_q in (1, 4):
        b_recs.append(check_paged_attention(f"bf16 s_q={s_q}", s_q, 8, 8, spread, False))
        b_recs.append(check_paged_attention(f"int8 s_q={s_q}", s_q, 8, 8, spread, True))
        b_recs.append(check_paged_attention(f"gqa h_kv=2 s_q={s_q}", s_q, 8, 2, spread, False))
    # The split's edges (128-position splits at 16-token blocks): lengths
    # of one split, one split + 1 and 1; S_q = 4 rows straddling a split's
    # end (positions 126-129 and 254-257); a table 257 entries wide with
    # every length under one split, so most CTAs write empty partials; int8
    # and GQA at the edges.
    b_recs += [
        check_paged_attention("split edges", 1, 8, 8, [128, 129, 1, 127, 256, 257], False),
        check_paged_attention("split edges s_q=4 straddling", 4, 8, 8, [130, 258, 4, 129], False),
        check_paged_attention("nmax=257 every length under one split", 1, 8, 8,
                              [100, 20, 127, 64], False, nmax=257),
        check_paged_attention("split edges int8", 1, 8, 8, [128, 129, 1, 300], True),
        check_paged_attention("split edges gqa h_kv=2 s_q=4", 4, 8, 2, [128, 129, 4, 258], False),
    ]
    # The main path's shape: 4 slots, one decode row, table width 257
    # (serve_max_total 4097 / 16-token blocks), prompt-scale lengths.
    b_main = check_paged_attention("main path", 1, 8, 8, [1001, 311, 701, 131], False, nmax=257,
                                   profiled=True)
    a_recs = []
    for m in (1, 8, 64):
        a_recs.append(check_fused_ln_ffn(f"relu post m={m}", m, "relu", "post"))
        a_recs.append(check_fused_ln_ffn(f"swiglu pre m={m}", m, "swiglu", "pre"))
        a_recs.append(check_fused_ln_ffn(f"gelu pre m={m}", m, "gelu", "pre"))
    a_main = check_fused_ln_ffn("main path", 4, "relu", "post")
    # Flash kernels: the training path's shape (B 4, S 4095 = the window
    # less the teacher-forcing shift, 8 heads of 64, bf16, causal, the
    # padding mask all True), then fp32, padding with rows that see no
    # key, GQA with a window, S_q != S_k, and head_dim 32.
    f_main = check_flash("main path", "bfloat16", 4, 4095, 4095, 8, 8, 64, True, None, False,
                         timed=True)
    f_recs = [
        check_flash("fp32 causal padded", "float32", 2, 1000, 1000, 8, 8, 64, True, None, True),
        check_flash("bf16 causal padded", "bfloat16", 2, 1000, 1000, 8, 8, 64, True, None, True),
        check_flash("bf16 gqa h_kv=2 window=256", "bfloat16", 2, 2048, 2048, 8, 2, 64,
                    True, 256, False),
        check_flash("bf16 cross s_q=512 s_k=1500 padded", "bfloat16", 2, 512, 1500, 8, 8, 64,
                    False, None, True),
        check_flash("fp32 d=32 causal", "float32", 2, 777, 777, 4, 4, 32, True, None, False),
    ]
    # The band apart from causality, as the ring backward passes it: bands
    # of +256, 0 and -100 without causality (a band of 0 or less leaves the
    # last rows with no key at all).
    f_recs += [
        check_flash(f"bf16 gqa h_kv=2 band={band} non-causal", "bfloat16", 2, 2048, 2048, 8, 2,
                    64, False, band, False)
        for band in (256, 0, -100)
    ]
    # The bf16 tensor-core kernels' edges: head_dim 32; S shorter than a
    # tile (one query row over 100 keys; 63 rows, the last sequence's first
    # 33 seeing no key); S one row past two 64-row tiles; GQA with a group
    # of 4.
    f_recs += [
        check_flash("bf16 d=32 causal", "bfloat16", 2, 777, 777, 4, 4, 32, True, None, False),
        check_flash("bf16 s_q=1 s_k=100 padded", "bfloat16", 2, 1, 100, 8, 8, 64, False, None,
                    True),
        check_flash("bf16 s=63 causal padded", "bfloat16", 2, 63, 63, 8, 8, 64, True, None, True),
        check_flash("bf16 s=129 causal", "bfloat16", 2, 129, 129, 8, 8, 64, True, None, False),
        check_flash("bf16 gqa h_kv=2 causal padded", "bfloat16", 2, 1000, 1000, 8, 2, 64, True,
                    None, True),
    ]
    # The ring step: the main path's hops (B 4, C 1024 = 4096 / 4, 8 heads
    # of 64, bf16) on and below the diagonal, then fp32 with padding, GQA
    # with a positive band and with one of 0 or less, a ragged C, and the
    # first hop of a ring (a fresh carry) with a band that leaves rows, and
    # whole CTAs, no key.
    r_diag = check_ring_step("main path diagonal hop", "bfloat16", 4, 1024, 8, 8, 64, True, None,
                             False, timed=True)
    r_below = check_ring_step("main path hop below the diagonal", "bfloat16", 4, 1024, 8, 8, 64,
                              False, None, False, timed=True)
    r_recs = [
        r_diag, r_below,
        check_ring_step("fp32 causal padded", "float32", 2, 1000, 8, 8, 64, True, None, True),
        check_ring_step("bf16 gqa h_kv=2 band=300", "bfloat16", 2, 1024, 8, 2, 64, True, 300, False),
        check_ring_step("bf16 gqa h_kv=2 band=-100", "bfloat16", 2, 1024, 8, 2, 64, False, -100,
                        True),
        check_ring_step("bf16 ragged c=1000", "bfloat16", 2, 1000, 8, 8, 64, False, None, True),
        check_ring_step("bf16 fresh carry band=-100", "bfloat16", 2, 1024, 8, 8, 64, False, -100,
                        True, fresh=True),
        check_ring_step("fp32 d=32 gqa band=0", "float32", 2, 777, 4, 2, 32, False, 0, False),
    ]
    ring_replay()

    # 4. serving
    tok, vocab_path = vocab()
    cfg, export, reqs, launches = main_path(tok, vocab_path)
    fp32_decode_check(cfg, export, tok, reqs)
    decode_profile(export, tok, reqs)

    # 5. training on one card
    trainer, train_ds, train_launches, single = train_path(vocab_path)
    fp32_train_check(tok, train_ds)
    train_profile(trainer, train_ds)
    del trainer
    torch.cuda.empty_cache()

    # 6. seq2seq: the flash kernels at its shapes, Transformer-base trained
    # for an epoch and scored, fp32 checks, translation, the other presets
    s2s_recs, s2s_timed = seq2seq_flash_checks()
    src_tok, src_vocab = vocab(side="src")
    s2s_trainer, s2s_train_ds, s2s_export, s2s_launches, _ = seq2seq_train_path(
        src_vocab, vocab_path
    )
    train_profile(s2s_trainer, s2s_train_ds, phase="seq2seq")
    seq2seq_fp32_check(s2s_trainer, next(iter(s2s_train_ds.batches(0))))
    tr_launches, _ = translate_path(s2s_export, src_vocab, vocab_path)
    fp32_decode_tokens_check(s2s_trainer, src_tok, tok)
    del s2s_trainer
    torch.cuda.empty_cache()
    _, joint_vocab = vocab(side="joint")
    presets_path(src_vocab, vocab_path, joint_vocab)

    # 7. sequence-parallel training over four processes on this card
    sp = sp_train_path(vocab_path, single)
    fp32_ring_check(tok, train_ds)
    fresh_dir("ckpt")  # the earlier runs' checkpoints

    # 8. checkpoints, resume, preemption and export on the base path
    ckpt_launches = checkpoints_path(src_vocab, vocab_path)

    # 9. steps_per_dispatch as CUDA-graph replays, buckets, dots
    disp_launches = dispatch_path(src_vocab, vocab_path, os.path.join(BUILD_DIR, "train_export"))

    def summary(name, main_rec, recs, replaces):
        cold = {k: main_rec[k] for k in ("device_ms_cold", "library_device_ms_cold",
                                         "share_of_bound_warm") if k in main_rec}
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
            "ms": main_rec["ms"], "device_ms": main_rec["device_ms"],
            "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"], "bound_us": main_rec["bound_us"],
            "bound_by": main_rec["bound_by"], "library_ms": main_rec["library_ms"],
            "library_device_ms": main_rec["library_device_ms"], "timers": main_rec["timers"],
            "share_of_bound": main_rec["share_of_bound"], **cold,
        }

    def flash_summary(name, readings):
        def pick(rec, key):
            val = rec.get(key, "not measured")
            return val[name] if isinstance(val, dict) else val

        recs = [f_main] + f_recs + s2s_recs
        by_path = {"train": train_launches[name], "sp_train": sp["launches"][name],
                   "seq2seq_train": s2s_launches[name], "translate": tr_launches[name],
                   "ckpt": ckpt_launches[name], "dispatch": disp_launches[name]}
        return {
            "name": name, "route": "cuda",
            "source": "transformer_tpu_torch/csrc/flash_attention.cu",
            "replaces": FLASH_REPLACES[name],
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"][k] for r in recs for k in readings),
            "max_reading": max(r["readings"][k] for r in recs for k in readings),
            "tolerance": FLASH_TOL,
            "tolerance_on": "worst (batch, row, head) relative across head_dim",
            "ms": f_main["ms"][name], "plain_ms": f_main["plain_ms"][name],
            "bound_ms": f_main["bound_ms"][name], "bound_by": f_main["bound_by"][name],
            "library_ms": f_main["library_ms"][name],
            "share_of_bound": f_main["share_of_bound"][name],
            "seq2seq": {
                part: {key: pick(rec, key) for key in (
                    "ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
                    "bound_ms", "bound_by", "share_of_bound", "share_of_bound_device")}
                for part, rec in s2s_timed.items()
            },
            "timers": {"ms": "cuda_ms (device-bound at the main shape)", "library_ms": "cuda_ms",
                       "seq2seq": "ms, plain_ms, library_ms: cuda_ms (the host's time per call "
                                  "at B 64, S 64); device_ms, library_device_ms: kernel_us "
                                  "(profiler device time per call)"},
        }

    print(smi, flush=True)
    emit({"kernels": [
        summary("paged_attention", b_main, b_recs,
                "transformer_tpu/kernels/paged_flash.py:62 _paged_kernel"),
        summary("fused_ln_ffn", a_main, a_recs,
                "transformer_tpu/ops/ffn.py:112 _fused_kernel"),
        flash_summary("flash_fwd", ("out",)),
        flash_summary("flash_dq", ("dq",)),
        flash_summary("flash_dkdv", ("dk", "dv")),
        {
            "name": "flash_ring_step", "route": "cuda",
            "source": "transformer_tpu_torch/csrc/flash_attention.cu",
            "replaces": FLASH_REPLACES["flash_ring_step"],
            "launches": sp["launches"]["flash_ring_step"],
            "launches_by_path": {"sp_train": sp["launches"]["flash_ring_step"]},
            "max_abs_err": max(r["max_abs_err"] for r in r_recs),
            "max_reading": max(r["readings"]["out"] for r in r_recs),
            "tolerance": {k: v["out"] for k, v in FLASH_TOL.items()},
            "tolerance_on": "worst (batch, row, head) relative across head_dim of acc / l",
            "ms": r_below["ms"], "ms_diagonal": r_diag["ms"],
            "plain_ms": r_below["plain_ms"], "plain_ms_diagonal": r_diag["plain_ms"],
            "bound_ms": r_below["bound_ms"], "bound_by": r_below["bound_by"],
            "bound_ms_diagonal": r_diag["bound_ms"], "bound_by_diagonal": r_diag["bound_by"],
            "library_ms": None, "share_of_bound": r_below["share_of_bound"],
            "share_of_bound_diagonal": r_diag["share_of_bound"],
            "timers": {"ms": "cuda_ms (device-bound at the main shape)"},
        },
    ]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
