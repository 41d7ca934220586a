#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It needs a CUDA device and nvcc, builds
the port's kernels from ``transformer_tpu_torch/csrc``, and exits non-zero
if anything fails (with no CUDA device it exits non-zero at once: nothing
runs on the CPU). It prints one JSON line per check, in seventeen phases
(the tenth runs right after the fourth, on its export; the eleventh to
the seventeenth last):

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
   -1e30, l = 0 and acc = 0 bit for bit; a ring of 4 is replayed
   in one process at the main shape against the whole-sequence kernels;
   and the training kernels run at phase 11's shapes, bf16 and fp32: the
   flash kernels at B 16 (a quarter of the seq2seq batch), at 2 heads a
   process (Ulysses; B 64 x S 64, and long4k's B 4 x S 4096 in bf16), the
   ring step at chunks of 16 over ragged sentences, where a chunk of
   padding only must leave the carry as it found it, bit for bit;
4. serving: a long4k-width decoder-only LM (random weights from a seed,
   written as an export) serves JSONL requests through
   ``transformer_tpu_torch.cli.serve`` with the paged KV pool, each step
   replayed from a CUDA graph; both decode kernels' launch counters must
   equal layers x decode forwards. Then a few decode forwards at fp32
   compare the kernels with their plain versions, and profiled windows of
   decode steps, eager and replayed, show where a step's time goes;
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
   ``transformer_tpu_torch.cli.train --preset base --num_layers 2
   --attention_impl flash --sequence_length 64 --epochs 1``
   (Transformer-base at full width, its depth cut to 2 + 2 layers, on the
   bundled corpus), whose flash counters must equal 4 launches of each
   kernel a train step, 4 forward launches an eval batch and 2 a
   translate call of the epilogue's sample translation and BLEU on 200
   test pairs; a profiled window of its train steps; one fp32 train step
   (2 + 2 layers) kernels against plain versions; ``cli.translate``
   greedy and ``--beam 4`` and ``cli.evaluate --limit 200`` on the export
   (its JSON line printed); greedy and beam-4 tokens with the flash encoder
   and its plain version at fp32 (2 + 2 layers), which must be identical;
   and the tiny, big and tied presets for an epoch of 1280 pairs;
7. sequence-parallel training: ``torch.distributed.run`` starts four
   processes of ``transformer_tpu_torch.cli.distributed_train --preset
   long4k --num_layers 2 --attention_impl ring --sp 4 --epochs 1
   --consistency_check`` on this one card (gloo, staged through host
   memory; long4k's width, its depth cut to 2 layers to make room for
   phase 17); each rank's counters of the ring step and both
   backward kernels must equal what steps, hops and eval batches imply,
   the losses must be within 0.01 of a single-card ``cli.train`` run of
   the same flags (the phase's first run), and every rank's parameters
   and the export must be bit-identical. One
   fp32 step at full width (2 layers) over a ring of four processes
   compares with the single-process flash step (run in phase 11's four
   worker processes: one spawn for both phases' fp32 checks);
8. checkpoints: ``cli.train --preset base --num_layers 2 --attention_impl
   flash --sequence_length 64 --grad_accum 2`` (Transformer-base's width,
   its depth cut to 2 + 2 layers: the phase holds its runs to each other)
   on the first 1,300 corpus pairs
   (20 steps an epoch), each run with its own ``--ckpt_path``: U trains 2
   epochs; R trains 1, then is relaunched for 2 on the same path and must
   log the restore and ``resuming at epoch 2/2 (step 20)`` and end with
   U's parameters bit for bit (else U runs again and R is held to the
   U-to-U spread); every run's flash counters must equal 8 launches of
   each kernel a step (4 per micro-step), 4 forward launches an eval
   batch and 2 for the sample translation. P runs U's flags with
   ``--async_checkpoint`` in a subprocess that gets SIGTERM once it logs
   the end of epoch 1: its log must name a step S in epoch 2 whose
   checkpoint verifies against its manifest, a relaunch must resume at
   epoch 2 and end at S + 20, and after one byte of the newest arrays.npz
   is flipped the next relaunch must fall back to S. Then the save stall
   (sync and async), the async write's time to durable, restore + verify
   and the checkpoint's bytes at full width, 2 + 2 layers;
   ``cli.export --average_last 2
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
   3 single steps): wall, device time, busy share and launch calls;
10. speculative decoding and the prefix cache: kernel B at S_q 5 (k 4 + 1)
   on the main path's lengths over the 257-entry table, with rows
   straddling its splits, and int8; kernel A at M 20 (4 slots x 5), relu
   post-LN; each with its planted fault. Whether a row's bits depend on
   the rows sharing its call (the forward's products, kernels B and A;
   bf16 and fp32; reported). Phase 4's 14 requests with
   ``--speculate_k 4``, under the n-gram drafter and with
   ``--draft_checkpoint`` set to the export itself: greedy answers
   byte-identical to phase 4's (bf16 products and both kernels give each
   row the same bits at any row count), drafted and accepted printed. 16
   requests sharing a 512-token prefix of data/tgt-test.txt (tails of
   16-200 tokens, ``max_new`` 32), served twice through one scheduler
   without and with ``--prefix_cache_mb 256``, in bf16 and fp32, and in
   fp32 at 2 slots over a ``--kv_pool_blocks`` too small for the device
   tier: the second pass must hit every request's block-aligned prompt,
   the spill must happen, and the fp32 answers must equal the cache-off
   ones (the bf16 ones that differ are counted: a hit moves the suffix's
   first positions from decode steps to the prefill, which rounds
   otherwise in bf16). Then the decode (k 0) and verify (k 4, rows with
   drafts) forwards replayed from their graphs against
   ``paged_decode_forward`` on copies of the pools, 20 steps each: logits
   and pools bit for bit, launch counts equal, one capture each; a window
   of each, replayed and eager; and phase 4's requests served in fp32
   without and with ``--speculate_k 4``, the greedy answers that differ
   counted (fp32 products are not row-invariant on the card);
11. seq2seq over processes: ``cli.distributed_train --preset base
   --sequence_length 64 --epochs 1 --consistency_check`` on the 1,300
   pairs as four processes on this card (gloo), under ``--dp 4`` (flash),
   ``--attention_impl ring --sp 4`` and ``--attention_impl ulysses --sp
   4``: each rank's flash and ring counters must equal what steps, hops
   and eval batches imply (plus rank 0's sample translation), every rank
   must end with the same parameters (the consistency check passing after
   the epoch and at the end) and every step's loss must be within 0.01 of
   phase 9's E in its first epoch (``cli.train``, the same flags and
   seed); the dp 4 export is translated and scored. Then long4k with
   ``--num_layers 2 --attention_impl ulysses --sp 4``, held to phase 7's
   single-card run of its depth as phase 7 holds the ring's, its flash
   counters to what steps and eval batches imply. Then one fp32 step
   (2 + 2 layers, B 64) under each of the
   three meshes against the single-process flash step (the same processes
   then take phase 7's fp32 ring step). Each run reports
   its step median and first step, real target tokens a second across the
   job, staged bytes by kind, the consistency check's time and its wall;
12. the grouped serving path, ``cli.generate`` and admission control, on
   phases 6's and 4's exports: ``transformer_tpu_torch.cli.serve
   --serve_batch 64`` on the Transformer-base export (flash encoder)
   answers 48 raw lines of data/src-test.txt (greedy), 16 ``{"src": ...,
   "beam": 4}`` lines, a malformed line and a ``prompt`` line: every answer
   must be ``translate``'s on the group the server formed, the two errors
   JAX's ``serve_lines`` lines (no ``code``), and ``flash_fwd`` must have
   launched 6 times per ``translate`` call (member retries included);
   the answers that differ from ``cli.translate``'s are counted. Then
   ``cli.generate --max_new 32`` on phase 4's 14 prompts and the same
   through ``cli.serve --serve_slots 0`` (dense caches, plain cached
   attention: timed, tokens a second, time a tick), ``speculative_generate``
   at k 4 on the 4 shortest (its stats), a profiled window of their batch
   through ``generate`` (device time and busy share a tick), and the
   answers that disagree with phase
   4's or with batch-1 ``generate``'s counted. Last, phase 4's export
   served with ``--max_backlog 4`` by the replayed scheduler: phase 4's 14
   requests at once (10 answer ``backpressure``), two with ``deadline_ms``
   0, one queued and one in-flight request cancelled through ``cancel()``
   and one with ``max_new`` 512 whose 120 ms deadline expires
   mid-generation: the codes and counts must be the expected ones, aborted
   answers carry ``partial``, completed answers are byte-identical to
   phase 4's, the pool's free blocks are back at their start and kernels B
   and A launched layers x decode forwards;
13. the JAX server's default layouts, rolling-window caches and the
   circuit breakers (``layouts_path``, ``windowed_path``,
   ``breaker_path``): phase 4's export and 14 requests served under
   ``--kv_layout dense`` and ``--kv_layout paged --decode_kernel xla``,
   plain and at ``--speculate_k 4``: the two layouts' answers must be
   byte-identical, kernels B and A must not launch, every step must go
   through the run's one captured graph (replays counted); the answers
   that differ from phase 4's and a profiled window per layout beside
   phase 10's kernel step are reported; phase 10's shared-prefix requests
   twice on the dense layout with ``--prefix_cache_mb 64`` must hit. Then
   long4k with ``--attention_window 1024`` at 2 layers (its depth cut: the
   batch-1 ``generate`` it is held to runs ~3,900 eager ticks a dtype)
   trained for one epoch on 3,000 corpus lines (the flash kernels' band
   path, counted) and served on the
   dense layout's rolling 1024-row buffers at ``--prefill_chunk 512``:
   phase 4's 14 requests and two of about 1,500 and 3,000 tokens; in fp32
   the answers must equal batch-1 ``cli.generate``'s (bf16 differences
   counted), and ``--kv_layout paged``, ``--speculate_k`` and
   ``--prefix_cache_mb`` must each raise the JAX package's message. Last,
   the breaker drill on ``--kv_layout paged --decode_kernel paged_flash
   --speculate_k 4 --prefix_cache_mb 64 --breaker_threshold 2`` over a
   pool that forces the prefix tier to spill, with a test clock and
   ``BREAKER_SPEC`` armed: every request answered once, in order, with
   JAX's codes; both breakers closed -> open -> half_open -> closed; a
   spill, a host-restored hit, a corrupt block caught; then, both
   closed, phase 4's greedy answers byte-identical; slots, pins and pool
   blocks back at their start; kernels B and A launched layers x
   forwards;
14. the serving fleet (``fleet_path``): ``cli.router``'s Router over two
   replica worker processes sharing the card (``serve/replica.py``, the
   dense layout, no kernel launched), on phase 4's export: in fp32, phase
   4's 14 requests and phase 10's 16 shared-prefix requests (greedy
   answers byte-identical to phase 13's fp32 dense answers and to a
   single fp32 scheduler's; every shared-prefix request on one worker);
   a worker SIGKILLed after its first answer (every request answered
   once, as before; the supervisor's respawn warmed from the survivor and
   admitted: its time to recover); a checkpoint with a flipped byte
   refused before any worker is touched; ``route.canary`` rolling a
   canary back; a live upgrade to long4k's widths from seed 1 under
   traffic (old- and new-tagged answers each equal their weights' single
   scheduler; no capture after warm-up, no serving tensor moved by a
   flip; the flip's milliseconds); ``--disaggregate`` with one prefill
   and one decode worker (phase 10's answers byte-identical, the KV
   handoff's bytes and seconds) and ``--fault_spec ckpt.swap:at=1``
   aborting a flip with the old weights serving; the same traffic on a
   bf16 fleet, reported. ``python3 chip_smoke.py --only fleet`` runs this
   phase alone (its references computed there);
15. the encoder-only masked LM (``mlm_path``): the three flash kernels at
   its shape (B 64 x S 128, 8 heads of 64, bidirectional, a ragged key
   tail with a row of PAD only), bf16 and fp32, against their plain
   versions with phase 3's limits and planted faults, timed beside SDPA
   with the same key mask and the bound; ``cli.train --preset base
   --objective mlm --attention_impl flash --sequence_length 128
   --batch_size 64 --steps_per_dispatch 8`` for an epoch of the bundled
   German side (noam warmup cut to 100): the loss must fall, each kernel
   launched a layer a step and the forward a layer an eval batch; step
   median, tokens and masked tokens a second; the first 8 steps run again
   from the seed eagerly and through a captured step (masks drawn from
   the generators registered with the graph) must give bit-identical
   losses and parameters, and the run's first dispatch loss; a profiled
   window (busy share); ``--optimizer adafactor`` at 2 layers for two
   epochs: the loss must fall, the optimizer state under half the
   parameters, the last checkpoint restored bit for bit; then the base
   export behind ``cli.serve``: 16 fill lines of data/tgt-test.txt (one or
   two words masked, ``top_k`` 5) and a malformed line, in bf16 and fp32,
   flash and xla: ``flash_fwd`` a layer a ``fill_mask`` call (none with
   xla); fp32 flash and xla lines equal with their probabilities taken out
   and the probabilities within 1e-5 (the gate); the bf16 argmax fills
   that differ counted. ``python3 chip_smoke.py --only mlm`` runs this
   phase alone. The bf16 MLM forward is also timed cold: the graph's
   calls cycle through 16 copies of q, k, v (more than the L2 holds), as
   kernel A's cold timer, beside SDPA's cold time;
16. the trainer's command line (``paper_path``): the native library
   (``transformer_tpu_torch/native``) built with g++ from the checkout
   (seconds), and both 2^15 vocabularies built by its BPE trainer, which
   must equal the Python-built ones of build/vocab/ piece for piece (both
   times printed); ``cli.train --preset base --attention_impl flash
   --sequence_length 64 --epochs 1 --warmup_steps 4000`` at full depth
   (6 + 6) on the data path's defaults, so through the native loader: its epoch and batch counts
   must show it ran, the epoch's rows must be examples of the corpus
   once each (an epoch without the remainder dropped holds the same
   multiset of rows as the numpy path's), the loss must fall, and the
   flash counters must equal 12 launches of each kernel a step, 12
   forward launches an eval batch and 6 a translate call; step median,
   BLEU on 200 test pairs, a profiled window (busy share), and each
   loader's epoch iterated alone (the host's wait for a batch); the
   source paper's command line at 2 + 2 layers, ``--preset base
   --enable_function=true --per_replica_batch_size 64 --streaming
   --buffer_size 1000 --epochs 1`` (xla attention, as the paper's) over
   tfds-format vocabulary files written with ``TfdsSubwordTokenizer.save``
   (the corpus's frequent tokens, then its alphabet and the escape
   characters): the buffer's peak at most 1,000 examples, the loss
   falling, every data/src-test.txt line round-tripping through the tfds
   tokenizer; and ``cli.translate --attention_out`` on 8 test sentences:
   on the streaming export JAX's keys, every map row summing to 1 within
   1e-2 and decoder block 1 zero above the diagonal; on the base flash
   export the ids and the cross-attention (block 2) maps only, as the
   JAX dump writes for flash, and 6 + 8 x 12 forward launches.
   ``python3 chip_smoke.py --only paper`` runs this phase alone;
17. telemetry (``telemetry_path``): (a) phase 4's 14 requests through
   ``cli.serve`` on paged_flash with ``--metrics_jsonl --trace`` (the
   program profiler, the flight recorder and the default SLOs on): the
   answers byte-identical to phase 4's, the steps, captures, replays and
   kernel B and A launches equal to phase 4's; ``python -m
   transformer_tpu_torch.obs summarize`` rendering the ``perf:`` rows,
   ``obs slo`` the default objectives, ``obs trace`` 14 ``serve.request``
   roots; the profiler's p50 of ``serve.pool_step_paged_flash`` beside
   phase 10's replayed step. (b) phase 9's D run (base 2 + 2 layers, K 8,
   the 1,300 pairs) again with ``--metrics_jsonl --trace --profile_dir
   --tb_log_dir``: its losses bit-identical to D's, the same captures
   and flash counters, ``train_steps_total`` the steps taken,
   ``train.memory``'s peak equal to ``torch.cuda.max_memory_allocated``,
   the ``torch.profiler`` window naming the three flash kernels and
   TensorBoard files for train and test. (c) two fp32 replica workers
   behind ``cli.router`` with ``--metrics_jsonl --trace`` and an idle
   drain (``--max_replicas 2 --scale_idle 1``) on 8 greedy requests: the
   answers equal to a single scheduler's, a log a process
   (``<path>.r0``, ``<path>.r1``), each worker's request spans under the
   router's, and ``summarize`` over the three logs rendering the
   ``router:`` and ``fleet:`` lines. Telemetry's overhead: the serve
   step and the train step with it on and off (phases 4 and 9).
   ``python3 chip_smoke.py --only telemetry`` runs this phase alone (with
   phase 4's serving and phase 9's D run as its references).

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
    # The first profiler session of a process can come back without device
    # events (the first case profiled once read "not measured"), so an
    # empty session is taken once more.
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
            if us > 0:
                out[e.key[:90]] = us / calls
        if out:
            return out
    return "not measured"


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
                    fresh=False, lengths=None):
    """flash_ring_step against flash_ring_step_plain for one hop from the
    carry an earlier, unmasked hop left (``fresh``: from the carry a ring
    starts with, m = MASKED, l = 0, acc = 0). Read per row: the finalised
    out (||Δ|| / ||want|| across head_dim), lse (absolute), m (absolute)
    and l (relative); the planted faults must read above the out limit on
    the worst row (from a fresh carry there is nothing to rescale, so only
    the unfolded rows are planted). From a fresh carry, every row that sees
    no key in the hop must come back with m = MASKED, l = 0 and acc = 0
    exactly. With ``lengths`` (the visiting chunk's real keys per
    sequence, as sentences padded over a sequence split leave them) some
    sequences' chunks are padding only: their carry must come back as it
    went in, bit for bit."""
    import torch

    from transformer_tpu_torch.kernels.flash_attention import (
        flash_ring_step,
        flash_ring_step_plain,
    )
    from transformer_tpu_torch.kernels.paged_flash import MASKED

    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]
    q, k, v, _, mask = flash_inputs(b, c, c, h, h_kv, d, dt, padded, lengths=lengths)
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
    if lengths is not None:
        idle = ~mask.any(dim=1)  # sequences whose visiting chunk is padding only
        readings["padding_chunks"] = {
            "sequences": int(idle.sum().item()),
            "carry_bit_identical": all(torch.equal(g[idle], c0[idle]) for g, c0 in zip(got, carry)),
        }
        ok = ok and readings["padding_chunks"]["sequences"] > 0 and readings[
            "padding_chunks"]["carry_bit_identical"]
    rec = {
        "phase": "kernels", "kernel": "flash_ring_step", "case": label, "dtype": dtype,
        "b": b, "c": c, "h": h, "h_kv": h_kv, "d": d, "causal": causal, "band": band,
        "padded": padded, "fresh_carry": fresh, "readings": readings,
        "key_lengths": None if lengths is None else [int(n) for n in lengths],
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
    default target size by the Python BPE trainer (phase 16 holds the
    native one to it), cached under build/vocab/."""
    from transformer_tpu_torch import native
    from transformer_tpu_torch.data.tokenizer import SubwordTokenizer, iter_lines

    path = os.path.join(BUILD_DIR, "vocab", f"{side}-train-{target_size}.subwords")
    files = [os.path.join(ROOT, "data", f"{name}-train.txt")
             for name in (("src", "tgt") if side == "joint" else (side,))]
    t0 = time.perf_counter()
    if os.path.exists(path):
        tok, built = SubwordTokenizer.load(path), False
    else:
        saved, native._lib = native._lib, False  # the Python trainer
        try:
            tok = SubwordTokenizer.build_from_corpus(iter_lines(*files),
                                                     target_vocab_size=target_size)
        finally:
            native._lib = saved
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
    argv = serve_argv(export, vocab_path)
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
        "captures": [{"shape": list(sig), "seconds": sec} for sig, sec in sched.forward.captures],
        "replays": sched.forward.replays,
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
    return cfg, export, reqs, launches, answers, rec


PAGED_FLASH = ("--kv_layout", "paged", "--decode_kernel", "paged_flash")
PAGED_FLASH_KW = dict(kv_layout="paged", decode_kernel="paged_flash")


def serve_argv(export, vocab_path, *extra, layout=PAGED_FLASH) -> list[str]:
    """``cli.serve``'s flags on the main path (4 slots, 16-token blocks,
    64-token prefill chunks, the paged pool on kernels B and A unless
    ``layout`` names another), plus ``extra``."""
    return [
        "--export_path", export, "--tgt_vocab_file", vocab_path,
        "--serve_slots", "4", "--prefix_block", "16", "--prefill_chunk", "64",
        *layout, "--device", "cuda", *extra,
    ]


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
        device="cuda", **PAGED_FLASH_KW,
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


def step_window(sched, steps: int) -> dict:
    """Where a serving step's time goes: ``steps`` steps timed on the host
    clock (ending in a synchronize), then as many under ``torch.profiler``
    for device time by kernel and the host's launch calls. Device busy
    share = summed kernel time / unprofiled wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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
    averages = prof.key_averages()
    events = [
        e for e in averages
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
    launch_calls = {e.key: e.count / steps for e in averages
                    if "Launch" in e.key and e.key.startswith("cu")}
    return {
        "steps": steps, "slots_busy": len(sched._active),
        "positions": sorted(st.pos for st in sched._active.values()),
        "wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms if events else "not measured",
        "device_busy_share": device_ms / wall_ms if events else "not measured",
        "kernel_share_of_device_time": shares if events else "not measured",
        "launch_calls_per_step": launch_calls,
        "top_kernels": [
            {"name": e.key[:80], "ms_per_step": dev_us(e) / steps / 1e3,
             "calls_per_step": e.count / steps}
            for e in top
        ],
    }


def decode_profile(export, tok, reqs, steps: int = 20):
    """The main path's decode step, eager and replayed from its CUDA graph
    (``serve/graph.py``), in one scheduler: four slots busy with the
    longest prompts, a window of each (``step_window``), eager first."""
    from transformer_tpu_torch.convert import load_export
    from transformer_tpu_torch.serve.scheduler import ContinuousScheduler

    params, cfg = load_export(export, device="cuda")
    sched = ContinuousScheduler(
        params, cfg, tok, num_slots=4, prefill_chunk=64, kv_block=16, device="cuda",
        **PAGED_FLASH_KW,
    )
    longest = sorted(reqs, key=lambda r: -len(r["prompt"]))[:4]
    for r in longest:
        sched.submit({"prompt": r["prompt"], "max_new": 64})
    sched.admit()
    graph = sched.forward
    sched.forward = graph.eager
    for _ in range(5):
        sched.step()
    eager = step_window(sched, steps)
    sched.forward = graph
    for _ in range(5):
        sched.step()
    replayed = step_window(sched, steps)
    rec = {
        "phase": "main", "step": "decode_profile", "card": nvidia_smi_line(),
        "eager": eager, "graph": replayed,
        "captures": [{"shape": list(sig), "seconds": sec} for sig, sec in graph.captures],
        "timers": "wall: host clock around the window ending in a synchronize; device: "
                  "torch.profiler's kernel time over a second window of the same size",
    }
    emit(rec)
    return rec


# --------------------------------------------------------------------------
# phase 5: training


def train_path(vocab_path, *extra, name: str = "train"):
    """``cli.train --preset long4k --epochs 1`` (plus ``extra``) on the
    bundled corpus, with the flash launch counters set to 0 just before
    and read just after; ``name`` labels its record, export and
    checkpoints."""
    import statistics

    import torch

    from transformer_tpu_torch.cli import train
    from transformer_tpu_torch.convert import load_export
    from transformer_tpu_torch.data.pipeline import load_lm_splits
    from transformer_tpu_torch.kernels.flash_attention import flash_dkdv, flash_dq, flash_fwd
    from transformer_tpu_torch.models.transformer import flatten

    data = os.path.join(ROOT, "data")
    export = os.path.join(BUILD_DIR, f"{name}_export")
    argv = [
        "--preset", "long4k", "--epochs", "1", "--dataset_path", data,
        "--tgt_vocab_file", vocab_path, "--export_path", export,
        "--ckpt_path", fresh_dir("ckpt", name), "--device", "cuda", *extra,
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
        "phase": name, "step": "fit", "argv": argv, "config": dataclasses.asdict(cfg),
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


SP_LAYERS = 2  # long4k's depth in phase 7 (the width is long4k's)


def sp_train_path(vocab_path, single, sp: int = 4):
    """``cli.distributed_train --preset long4k --num_layers 2
    --attention_impl ring --sp 4 --epochs 1 --consistency_check`` under
    ``torch.distributed.run``: four processes on this one card, so the
    transport is gloo through host memory (``dist_fit``). Rank r folds its
    own chunk and the r before it: L x (r + 1) ring steps a forward (each
    twice a step under remat), and as many dQ and dK/dV a step. Losses
    must be within 0.01 of ``single``, the single-card run of the same
    flags (same seed, same dropout draws)."""
    export = os.path.join(BUILD_DIR, "sp_train_export")
    args = [
        "--preset", "long4k", "--num_layers", str(SP_LAYERS), "--attention_impl", "ring",
        "--sp", str(sp), "--epochs", "1",
        "--consistency_check", "--dataset_path", os.path.join(ROOT, "data"),
        "--tgt_vocab_file", vocab_path, "--export_path", export,
        "--ckpt_path", fresh_dir("ckpt", "sp_train"), "--device", "cuda",
    ]
    layers = single["config"]["num_layers"]

    def want(rank, steps, evals):
        hops = layers * (rank + 1)
        return {"flash_fwd": 0, "flash_ring_step": hops * (2 * steps + evals),
                "flash_dq": hops * steps, "flash_dkdv": hops * steps}

    rec, _ = dist_fit("sp_train", "fit", args, want, export, procs=sp)
    hold_to_single(rec, single)
    return rec


def hold_to_single(rec, single):
    """A long4k run over processes (phase 7's ring, phase 11's Ulysses)
    against the single-card run of its flags: the same steps and eval
    batches, train and eval loss within 0.01."""
    held = {key: rec[key] for key in ("steps", "eval_batches", "train_loss", "eval_loss")}
    want = {key: single[key] for key in held}
    emit({"phase": rec["phase"], "step": f"{rec['step']} against the single card", "got": held,
          "single_card": want, "limit": 0.01})
    if not (held["steps"] == want["steps"] and held["eval_batches"] == want["eval_batches"]
            and abs(held["train_loss"] - want["train_loss"]) <= 0.01
            and abs(held["eval_loss"] - want["eval_loss"]) <= 0.01):
        raise SystemExit(f"{rec['step']}: not within 0.01 of the single card's losses: "
                         f"{held} / {want}")


def distributed_run(args, procs: int, name: str, timeout: int = 600):
    """``cli.distributed_train`` with ``args`` under ``torch.distributed.run``
    in ``procs`` processes on this one card (gloo through host memory),
    each rank's report gathered with ``--metrics_json``. The kernel
    counters of each process start at 0 with it. Returns (the finished
    process, the ranks' reports, wall seconds); a failed run fails the
    script."""
    report_path = os.path.join(BUILD_DIR, f"{name}_report.json")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(procs), "-m", "transformer_tpu_torch.cli.distributed_train", *args,
           "--metrics_json", report_path]
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "2"}
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(
            f"{name}: cli.distributed_train failed (exit {proc.returncode}):\n"
            f"{proc.stdout[-4000:]}\n{proc.stderr[-6000:]}"
        )
    with open(report_path) as f:
        return proc, json.load(f)["ranks"], wall


def dist_fit(phase, name, args, want_fn, export, procs: int = 4):
    """One ``distributed_run``, held: every rank's kernel counters equal
    ``want_fn(rank, steps, eval_batches)``, every rank ends with the same
    parameters (and the export loads back to them), the consistency check
    ran after each epoch and at the end and passed, the losses are finite
    and every rank read the same ones. Returns the record (step times,
    real target tokens a second across the job, staged bytes by kind, the
    check's time, wall) and the counters summed over the ranks."""
    import statistics

    from transformer_tpu_torch.convert import load_export, params_digest

    proc, ranks, wall = distributed_run(args, procs, name)
    r0 = ranks[0]
    steps, evals = len(r0["step_seconds"]), r0["eval_batches"]
    per_rank = {r["rank"]: r["launches"] for r in ranks}
    want = {r: want_fn(r, steps, evals) for r in per_rank}
    launches = {k: sum(c[k] for c in per_rank.values()) for k in per_rank[0]}
    params, _ = load_export(export, device="cuda")
    ms = [t * 1e3 for t in r0["step_seconds"]]
    consistency = [r["consistency_check"] for r in ranks]
    rec = {
        "phase": phase, "step": name, "argv": args, "processes": procs,
        "card": nvidia_smi_line(), "transport": r0["transport"], "steps": steps,
        "eval_batches": evals, "step_ms_first": ms[0],
        "step_ms_median": statistics.median(ms[1:] or ms), "step_ms_all": ms,
        "target_tokens": r0["target_tokens"],
        "target_tokens_per_s": r0["target_tokens"] / sum(r0["step_seconds"]),
        "staged_bytes_per_rank": [r["staged_bytes"] for r in ranks],
        "staged_bytes_per_step_rank0": {k: v / steps for k, v in r0["staged_bytes"].items()},
        "consistency_check": consistency, "wall_s": wall,
        "train_loss": r0["train_loss"], "eval_loss": r0["eval_loss"], "losses": r0["losses"],
        "launches_per_rank": per_rank, "expected_launches_per_rank": want,
        "launches": launches,
        "ranks_hold_the_same_params": len({r["params_sha256"] for r in ranks}) == 1,
        "export_loads_back": params_digest(params) == r0["params_sha256"],
        "logs": [ln for ln in proc.stdout.splitlines() if not ln.startswith("sample")][-14:],
    }
    emit(rec)
    del params
    if rec["transport"] != "gloo":
        raise SystemExit(f"{name}: {procs} processes on one card must use gloo")
    if per_rank != want:
        raise SystemExit(f"{name}: launches {per_rank}, expected {want}")
    if not (rec["ranks_hold_the_same_params"] and rec["export_loads_back"]):
        raise SystemExit(f"{name}: the ranks' params differ, or the export does not load back")
    if not all(c["passed"] and c["checks"] == 2 for c in consistency):
        raise SystemExit(f"{name}: the consistency check did not run twice and pass: {consistency}")
    if any(r["losses"] != r0["losses"] for r in ranks) or not all(
            math.isfinite(x) for x in r0["losses"] + [r0["eval_loss"]]):
        raise SystemExit(f"{name}: the ranks' losses differ or are not finite")
    return rec, launches


def _fp32_ring_step(process, vocab_size, tgt, layers):
    """One rank's part of the fp32 ring check: one long4k step's loss and
    gradients over a ring of the processes (summed over the ring)."""
    import torch

    from transformer_tpu_torch.config import MeshConfig, TrainConfig
    from transformer_tpu_torch.models.transformer import flatten, init_params
    from transformer_tpu_torch.parallel.distributed import _seq_parallel_forward_loss
    from transformer_tpu_torch.parallel.mesh import make_mesh
    from transformer_tpu_torch.train.trainer import loss_and_grads

    mesh = make_mesh(MeshConfig(seq=process.world_size), process)
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
    return {"loss": float(metrics["loss"]), "grads": {k: g.cpu() for k, g in grads.items()}}


def fp32_ring_check(tok, tgt, ring, layers: int = 2, sp: int = 4):
    """One fp32 step at full width (2 layers, S 4096, batch 4, dropout 0)
    from one init: the sp=4 ring (kernels, four processes on this card:
    ``ring``, run in phase 11's worker processes, ``_fp32_ring_step``, on
    the batch ``tgt``) against the single-process flash step (kernels).
    Limits as the fp32 train check: loss 1e-5 relative, the worst gradient
    leaf 1e-3, the key biases' gradient below 1e-3 of the query biases' on
    both sides."""
    import torch

    from transformer_tpu_torch.config import TrainConfig
    from transformer_tpu_torch.models.transformer import flatten, init_params
    from transformer_tpu_torch.train.trainer import loss_and_grads

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
        "ring_seconds": ring["seconds"], "tolerance": TRAIN_TOL,
    }
    emit(rec)
    if not (loss_rel <= TRAIN_TOL["loss_rel"] and worst <= TRAIN_TOL["grad_rel"]
            and key_bias <= TRAIN_TOL["key_bias_ratio"]):
        raise SystemExit(f"fp32 ring check failed: {rec}")


# --------------------------------------------------------------------------
# phase 6: seq2seq training, translation and scoring


S2S_LEN = 64  # --sequence_length of the seq2seq main path (bench.py's seq)
S2S_LAYERS = 2  # phase 6's base depth, cut from 6 + 6 to keep the script in its time
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
    (d 512, 8 heads, dff 2048, bf16, batch 64, dropout 0.1), its depth cut
    to ``S2S_LAYERS`` + ``S2S_LAYERS`` layers to keep the script in its
    time, then the epilogue's sample translation, export and BLEU on 200
    test pairs. The flash counters are set to 0 just before and read just
    after: 2 × layers forward, dQ and dK/dV launches a train step, as many
    forward launches an eval batch, layers (the encoder) a translate
    call."""
    import statistics

    import torch

    from transformer_tpu_torch.cli import train
    from transformer_tpu_torch.convert import load_export
    from transformer_tpu_torch.data.pipeline import load_dataset
    from transformer_tpu_torch.models.transformer import flatten

    data = os.path.join(ROOT, "data")
    export = os.path.join(BUILD_DIR, "seq2seq_export")
    argv = [
        "--preset", "base", "--num_layers", str(S2S_LAYERS), "--attention_impl", "flash",
        "--sequence_length", str(S2S_LEN),
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


def translate_path(export, src_vocab, tgt_vocab, batch_size: int = 64, phase: str = "seq2seq"):
    """``cli.translate`` on the trained export, greedy and ``--beam 4``, on
    8 test sentences read from stdin, then ``cli.evaluate --limit 200 --beam 1``, with the
    flash counters set to 0 just before and read just after (a forward
    launch per encoder layer per translate call and per evaluate batch).
    Greedy and beam are timed on the host clock."""
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
    with open(os.path.join(export, "config.json")) as f:
        layers = json.load(f)["num_layers"]
    want = {"flash_fwd": layers * (2 + evaluate_batches), "flash_dq": 0, "flash_dkdv": 0}
    rec = {
        "phase": phase, "step": "translate", "sentences": 8,
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


PRESET_LAYERS = 2  # the presets' depth, cut (big and tied have 6 + 6 at full depth)


def presets_path(src_vocab, tgt_vocab, joint_vocab, pairs: int = 1280):
    """The tiny, big and tied presets through ``cli.train --attention_impl
    flash`` for one epoch on the first ``pairs`` corpus pairs (and 64 test
    pairs), BLEU off, at their widths and ``PRESET_LAYERS`` layers: losses
    finite, every flash kernel launched."""
    import shutil as sh

    import torch

    from transformer_tpu_torch.cli import train

    data = cut_corpus(pairs)
    recs = []
    for preset in ("tiny", "big", "tied"):
        src_v, tgt_v = (joint_vocab, joint_vocab) if preset == "tied" else (src_vocab, tgt_vocab)
        export = os.path.join(BUILD_DIR, f"seq2seq_{preset}_export")
        argv = ["--preset", preset, "--num_layers", str(PRESET_LAYERS),
                "--attention_impl", "flash", "--sequence_length",
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
CKPT_LAYERS = 2  # encoder and decoder layers of phases 8, 9 and 11's Transformer-base


def ckpt_argv(data, src_vocab, tgt_vocab, root, name, epochs, *extra):
    """``cli.train --preset base --attention_impl flash --sequence_length
    64 --grad_accum 2`` on the cut corpus, checkpointing to ``root/name``;
    its depth cut to 2 + 2 layers (the phase holds its runs to each other,
    not to another phase's, and the cut keeps the script in its time)."""
    return [
        "--preset", "base", "--num_layers", str(CKPT_LAYERS), "--attention_impl", "flash",
        "--sequence_length", str(S2S_LEN),
        "--grad_accum", "2", "--epochs", str(epochs), "--dataset_path", data,
        "--src_vocab_file", src_vocab, "--tgt_vocab_file", tgt_vocab,
        "--ckpt_path", os.path.join(root, name), "--export_path", os.path.join(root, f"{name}_export"),
        "--eval_bleu", "false", "--device", "cuda", *extra,
    ]


def ckpt_fit(argv, phase_launches: dict):
    """One ``cli.train`` run in this process with the flash counters set to
    0 just before and read just after (added to ``phase_launches``), held
    to a launch of each kernel a layer a micro-step (two at ``--grad_accum
    2``), a forward launch a layer an eval batch and one a decoder layer
    for the epilogue's sample translation. Returns (trainer, logs,
    record)."""
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
        "losses": trainer.losses,
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
    common = ["--preset", "base", "--num_layers", str(CKPT_LAYERS), "--attention_impl", "flash",
              "--sequence_length", str(S2S_LEN), "--src_vocab_file", src_vocab,
              "--tgt_vocab_file", tgt_vocab, "--ckpt_path", r_mgr.directory,
              "--average_last", "2", "--device", "cuda"]
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
    ``root/name``; its depth cut to 2 + 2 layers as phase 8's (phase 11
    holds its losses to E's, at the same depth)."""
    return [
        "--preset", "base", "--num_layers", str(CKPT_LAYERS), "--attention_impl", "flash",
        "--sequence_length", str(S2S_LEN),
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
    """``ckpt_fit`` (counters held to a launch of each kernel a layer a
    step, a forward launch a layer an eval batch, one a decoder layer for
    the sample translation) with the
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
        "dispatch_ms": [sec * 1e3 for _, sec in trainer.dispatches],
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


def window_profile(trainer, batches, k, label, phase="dispatch"):
    """Busy share of one window of the run's own step: one ``k``-step
    dispatch (k > 1: the replayed graph) or 3 single steps (k = 1), on the
    host clock, then a second window under ``torch.profiler`` for the
    device time and the host's launch calls. ``batches`` holds three
    windows' worth of one shape. Target tokens are the non-PAD ids the
    loss can score: past the teacher-forcing shift, or (the masked LM)
    the whole window."""
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
    shift = 0 if trainer.train_cfg.objective == "mlm" else 1
    tokens = sum(int((tgt[:, shift:] != 0).sum()) for _, tgt in batches[n : 2 * n])
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
        "phase": phase, "step": "window_profile", "run": label, "card": nvidia_smi_line(),
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
    flash launches of the phase's runs and E's and D's records (phase 11
    holds E's per-step losses, phase 17 D's)."""
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
    return launches, {**e_rec, "steps_per_epoch": n}, d_rec


# --------------------------------------------------------------------------
# phase 10: speculative decoding, the prefix cache, and the decode and
# verify forwards replayed from CUDA graphs

SPEC_K = 4


def verify_kernel_checks():
    """Kernels B and A at the verify step's shapes: S_q = k + 1 rows per
    slot on the main path's lengths, over a table 257 entries wide (the
    slot budget 4097 + k slack over 16-token blocks), and rows straddling
    the 128-position splits (126-130, 254-258, 380-384); kernel A at M =
    4 slots x (k + 1) = 20 rows, not a multiple of its 8-row chunk. Each
    reads its planted fault (``check_paged_attention``,
    ``check_fused_ln_ffn``)."""
    w = SPEC_K + 1
    slot_blocks = -(-(4097 + SPEC_K) // 16)
    b_recs = [
        check_paged_attention(f"verify s_q={w} main path", w, 8, 8, [1001, 311, 701, 131],
                              False, nmax=slot_blocks),
        check_paged_attention(f"verify s_q={w} straddling splits", w, 8, 8, [131, 259, 5, 385],
                              False, nmax=slot_blocks),
        check_paged_attention(f"verify s_q={w} int8", w, 8, 8, [1001, 311, 701, 131], True,
                              nmax=slot_blocks),
    ]
    a_rec = check_fused_ln_ffn(f"verify relu post m={4 * w}", 4 * w, "relu", "post")
    return b_recs, a_rec


def row_invariance(seed: int = SEED) -> dict:
    """Whether row r of a call depends on how many rows share the call,
    at the decode forward's long4k shapes, bf16 and fp32: a q/k/v
    projection (einsum over (N, S_q, 512) x (512, 8, 64)) and the
    vocabulary projection (x (512, 32768)) at 4 x 5 rows against each of
    the 5 columns alone (4 rows), kernel B at S_q 5 against each row alone
    at its own length, kernel A at M 20 against 4. The speculative
    answers can equal the plain path's bit for bit only where every entry
    is invariant."""
    import torch

    from transformer_tpu_torch.kernels.paged_flash import paged_flash_attention
    from transformer_tpu_torch.ops.ffn import fused_ln_ffn

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    n, w, d, dff = 4, SPEC_K + 1, 512, 2048
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        x = rand(n, w, d).to(dt)
        wq, wl = rand(d, 8, 64, scale=0.05).to(dt), rand(d, 32768, scale=0.05).to(dt)
        q_all = torch.einsum("bsm,mhd->bshd", x, wq)
        l_all = x @ wl
        table = (torch.randperm(4 * 257, generator=g, device="cuda")[: n * 257] + 1)
        table = table.reshape(n, 257).to(torch.int32)
        k, v = rand(1 + 4 * 257, 16, 8, 64).to(dt), rand(1 + 4 * 257, 16, 8, 64).to(dt)
        index = torch.tensor([1001, 311, 701, 126], dtype=torch.int32, device="cuda")
        q = rand(n, w, 8, 64).to(dt)
        b_all = paged_flash_attention(q, k, v, table, index + w)
        ffn = {"in": {"kernel": rand(d, dff, scale=0.04).to(dt), "bias": rand(dff).to(dt)},
               "out": {"kernel": rand(dff, d, scale=0.04).to(dt), "bias": rand(d).to(dt)}}
        ln = {"scale": rand(d) + 1.0, "bias": rand(d, scale=0.1)}
        kw = dict(activation="relu", norm_scheme="post")
        a_all = fused_ln_ffn(ln, ffn, x, **kw)
        cols = range(w)
        out[str(dt).split(".")[1]] = {
            "qkv_projection": all(torch.equal(
                q_all[:, j:j + 1], torch.einsum("bsm,mhd->bshd", x[:, j:j + 1].contiguous(), wq))
                for j in cols),
            "vocabulary_projection": all(torch.equal(l_all[:, j], x[:, j].contiguous() @ wl)
                                         for j in cols),
            "paged_attention": all(torch.equal(b_all[:, j:j + 1], paged_flash_attention(
                q[:, j:j + 1].contiguous(), k, v, table, index + j + 1)) for j in cols),
            "fused_ln_ffn": all(torch.equal(a_all[:, j:j + 1], fused_ln_ffn(
                ln, ffn, x[:, j:j + 1].contiguous(), **kw)) for j in cols),
        }
    rec = {"phase": "speculative", "step": "row_invariance", "card": nvidia_smi_line(),
           "rows": f"{n} x {w} against {n} x 1", **out}
    emit(rec)
    return rec


def serve_passes(argv, passes) -> tuple:
    """Build ``cli.serve``'s scheduler from ``argv`` and serve each list of
    ``passes`` through the CLI's loop in turn (one cache and pool across
    them). Kernel B and A counters are set to 0 before and read after (and
    must read layers x steps on the paged_flash layout, 0 on the others);
    returns (scheduler, [(answers, stats of the pass, wall s)], launches)."""
    import queue

    import torch

    from transformer_tpu_torch.cli import serve
    from transformer_tpu_torch.kernels.paged_flash import paged_flash_attention
    from transformer_tpu_torch.ops.ffn import fused_ln_ffn

    sched = serve.build_scheduler(serve.build_parser().parse_args(argv))
    paged_flash_attention.launches = 0
    fused_ln_ffn.launches = 0
    runs = []
    for reqs in passes:
        before = dict(sched.stats)
        q: queue.Queue = queue.Queue()
        for r in reqs:
            q.put(json.dumps(r) + "\n")
        q.put(None)
        out = io.StringIO()
        t0 = time.perf_counter()
        serve.serve_continuous(q, sched, out)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.append(([json.loads(line) for line in out.getvalue().splitlines()],
                     {k: sched.stats[k] - before[k] for k in sched.stats}, wall))
    launches = {"paged_attention": paged_flash_attention.launches,
                "fused_ln_ffn": fused_ln_ffn.launches}
    # Kernels B and A run on the paged_flash layout only: layers x steps
    # there, none on the dense and gathered-view layouts.
    kernels = sched.decode_kernel == "paged_flash"
    want = sched.cfg.num_layers * sched.stats["steps"] if kernels else 0
    for name, count in launches.items():
        if count != want or (kernels and count <= 0):
            raise SystemExit(f"{name} launched {count} times in {argv}, expected {want}")
    return sched, runs, launches


def speculative_path(export, vocab_path, reqs, plain_answers, plain_rec):
    """Phase 4's 14 requests with ``--speculate_k 4``: the n-gram drafter,
    then ``--draft_checkpoint`` set to the served export itself. Greedy
    answers must be byte-identical to phase 4's; sampled ones answered."""
    launches = {}
    greedy = [i for i, r in enumerate(reqs) if "temperature" not in r]
    for label, extra in (("ngram", ()), ("draft_checkpoint", ("--draft_checkpoint", export))):
        argv = serve_argv(export, vocab_path, "--speculate_k", str(SPEC_K), *extra)
        sched, [(answers, st, wall)], counts = serve_passes(argv, [reqs])
        launches[label] = counts
        differing = [i for i in greedy if answers[i] != plain_answers[i]]
        rec = {
            "phase": "speculative", "step": "serve", "drafter": label, "argv": argv,
            "card": nvidia_smi_line(), "requests": len(reqs),
            "errors": [a for a in answers if "error" in a],
            "greedy_requests": len(greedy), "greedy_differing": differing,
            "drafted": st["drafted"], "accepted": st["accepted"],
            "accepted_share": st["accepted"] / max(1, st["drafted"]),
            "verify_steps": st["steps"], "plain_decode_steps": plain_rec["decode_forwards"],
            "generated_tokens": st["generated_tokens"],
            "tokens_per_s": st["generated_tokens"] / wall, "serve_wall_s": wall,
            "plain_serve_wall_s": plain_rec["serve_wall_s"],
            "verify_step_ms": st["decode_s"] / max(1, st["steps"]) * 1e3,
            "launches": counts, "expected_launches": sched.cfg.num_layers * st["steps"],
            "captures": [{"shape": list(sig), "seconds": sec}
                         for sig, sec in sched.forward.captures],
        }
        emit(rec)
        if rec["errors"] or len(answers) != len(reqs) or differing or not st["drafted"]:
            raise SystemExit(f"speculative serving ({label}) failed: {rec}")
        del sched
    return launches


def fp32_speculative_check(export, vocab_path, reqs):
    """Phase 4's requests served in fp32 without and with ``--speculate_k
    4`` (the n-gram drafter). Reported, not held: fp32 products are not
    row-invariant on the card, so a verify row may round otherwise than
    the decode row it replaces; the greedy answers that differ are
    counted. Returns the launches and both runs' answers (phase 13 holds
    its fp32 runs to them)."""
    export32 = fp32_export(export)
    greedy = [i for i, r in enumerate(reqs) if "temperature" not in r]
    runs, launches = {}, {}
    for label, extra in (("fp32 plain", ()), ("fp32 ngram", ("--speculate_k", str(SPEC_K)))):
        sched, [(answers, st, wall)], counts = serve_passes(
            serve_argv(export32, vocab_path, *extra), [reqs])
        runs[label] = (answers, st, wall)
        launches[label] = counts
        del sched
    plain, spec = runs["fp32 plain"][0], runs["fp32 ngram"][0]
    st, wall = runs["fp32 ngram"][1], runs["fp32 ngram"][2]
    rec = {
        "phase": "speculative", "step": "fp32", "card": nvidia_smi_line(),
        "requests": len(reqs), "greedy_requests": len(greedy),
        "greedy_differing": [i for i in greedy if spec[i] != plain[i]],
        "errors": [a for a in plain + spec if "error" in a],
        "drafted": st["drafted"], "accepted": st["accepted"],
        "accepted_share": st["accepted"] / max(1, st["drafted"]), "verify_steps": st["steps"],
        "plain_steps": runs["fp32 plain"][1]["steps"], "serve_wall_s": wall,
        "plain_serve_wall_s": runs["fp32 plain"][2], "launches": launches,
    }
    emit(rec)
    if rec["errors"] or len(spec) != len(reqs) or not st["drafted"]:
        raise SystemExit(f"fp32 speculative serving failed: {rec}")
    return launches, {"plain": plain, "ngram": spec}


def prefix_requests(tok, n: int = 16) -> list[dict]:
    """``n`` greedy requests sharing one 512-token prefix (the first words
    of data/tgt-test.txt), each with its own tail of 16 to 200 tokens from
    further on in the file, ``max_new`` 32."""
    with open(os.path.join(ROOT, "data", "tgt-test.txt"), encoding="utf-8") as f:
        words = f.read().split()

    def take(start, tokens):
        out = []
        while len(tok.encode(" ".join(out))) < tokens:
            out.append(words[(start + len(out)) % len(words)])
        return out

    prefix = take(0, 512)
    tails = [16 + round(i * (200 - 16) / (n - 1)) for i in range(n)]
    return [{"prompt": " ".join(prefix + take(4000 + 400 * i, t)), "max_new": 32}
            for i, t in enumerate(tails)]


def export_variant(export, name: str, **config) -> str:
    """The export with ``config`` overriding fields of its config (the
    same parameters, linked) in ``build/<name>``."""
    path = fresh_dir(name)
    os.makedirs(path)
    with open(os.path.join(export, "config.json")) as f:
        base = json.load(f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({**base, **config}, f)
    os.link(os.path.join(export, "params.npz"), os.path.join(path, "params.npz"))
    return path


def fp32_export(export, name: str = "smoke_export_fp32") -> str:
    """The export with its config's dtype set to float32: the model served
    in fp32."""
    return export_variant(export, name, dtype="float32")


def prefix_path(export, vocab_path, tok):
    """16 requests sharing a 512-token prefix, served twice through one
    scheduler: without the cache, with ``--prefix_cache_mb 256``, and (fp32,
    2 slots) with the cache over a pool too small to keep the device tier,
    which must spill to the host tier. The second pass must hit every request's
    block-aligned prompt (``floor((L - 1) / 16) * 16`` tokens). In fp32
    every answer with the cache must equal the answer without it. In bf16
    the differing answers are counted, not held: a hit moves the suffix's
    first positions from decode steps to the prefill forward, which rounds
    differently in bf16 (the JAX package's rule, ``n = m +
    prefill_len_for(L - m)``)."""
    reqs = prefix_requests(tok)
    lengths = [len(tok.encode(r["prompt"])) + 1 for r in reqs]
    aligned = sum((L - 1) // 16 * 16 for L in lengths)
    ids = [tok.encode(r["prompt"]) for r in reqs]
    shared = min(next((j for j, (a, b) in enumerate(zip(x, ids[0])) if a != b), len(x))
                 for x in ids[1:])
    # The spill runs at 2 slots over the sink and the blocks two slots can
    # reach without sharing (after a spill a slot restoring the prefix
    # from the host holds its own copy): every live slot fits, the device
    # tier's donations (a block per 16 prompt tokens past the shared ones,
    # and those) do not. At 4 slots that bound leaves room for the tier.
    pool = 1 + 2 * -(-(max(lengths) + 32) // 16)
    export32 = fp32_export(export)
    cache = ("--prefix_cache_mb", "256")
    two = ("--serve_slots", "2")
    runs, launches = {}, {}
    for label, path, extra in (
        ("bf16 off", export, ()), ("bf16 cache", export, cache),
        ("fp32 off", export32, ()), ("fp32 cache", export32, cache),
        ("fp32 off 2 slots", export32, two),
        ("fp32 spill 2 slots", export32, (*two, *cache, "--kv_pool_blocks", str(pool))),
    ):
        sched, passes, counts = serve_passes(serve_argv(path, vocab_path, *extra), [reqs, reqs])
        launches[label] = counts
        pc = sched.prefix_cache
        runs[label] = {
            "argv_extra": list(extra),
            "passes": [
                {"wall_s": wall, "steps": st["steps"], "prefill_tokens": st["prefill_tokens"],
                 "prefix_hit_tokens": st["prefix_hit_tokens"],
                 "prefix_alias_tokens": st["prefix_alias_tokens"],
                 "host_restored_tokens": st["host_restored_tokens"],
                 "kv_spilled_blocks": st["kv_spilled_blocks"],
                 "kv_preempted": st["kv_preempted"],
                 "generated_tokens": st["generated_tokens"],
                 "prefill_ms": st["prefill_s"] * 1e3,
                 "errors": [a for a in answers if "error" in a]}
                for answers, st, wall in passes],
            "answers": [a for answers, _, _ in passes for a in answers],
            "cache_stats": None if pc is None else dict(pc.stats),
            "launches": counts,
        }
        del sched, pc
    differing = {
        label: [i for i, (a, b) in enumerate(zip(runs[label]["answers"], runs[off]["answers"]))
                if a != b]
        for label, off in (("bf16 cache", "bf16 off"), ("fp32 cache", "fp32 off"),
                           ("fp32 spill 2 slots", "fp32 off 2 slots"))}
    rec = {
        "phase": "prefix_cache", "step": "serve", "card": nvidia_smi_line(),
        "requests": len(reqs), "prompt_tokens": lengths, "shared_prefix_tokens": shared + 1,
        "pass_2_block_aligned_tokens": aligned, "spill_pool_blocks": pool,
        **{label: {k: v for k, v in r.items() if k != "answers"} for label, r in runs.items()},
        "differing_from_off": differing,
    }
    emit(rec)
    failed = [label for label, r in runs.items()
              if any(p["errors"] for p in r["passes"]) or len(r["answers"]) != 2 * len(reqs)]
    if failed or differing["fp32 cache"] or differing["fp32 spill 2 slots"]:
        raise SystemExit(f"prefix cache: answers differ or failed ({failed}): {rec}")
    for label in ("bf16 cache", "fp32 cache"):
        if runs[label]["passes"][1]["prefix_hit_tokens"] != aligned:
            raise SystemExit(f"prefix cache: {label}'s second pass hit "
                             f"{runs[label]['passes'][1]['prefix_hit_tokens']} of {aligned}")
    if not sum(p["kv_spilled_blocks"] for p in runs["fp32 spill 2 slots"]["passes"]):
        raise SystemExit(f"prefix cache: no block spilled over a {pool}-block pool")
    return launches


def graph_path(export, tok, reqs, steps: int = 20):
    """The decode (k 0) and verify (k 4) forwards replayed from their CUDA
    graphs against the eager forward: four slots on the longest prompts,
    ``steps`` steps each checked (the logits of the replay and of
    ``paged_decode_forward`` on a copy of the pools before it, bit for
    bit; the pools after; the launch counts), verify steps once every
    prompt tail is in (so the rows carry drafts); then a window of each,
    replayed and eager (``step_window``)."""
    import torch

    from transformer_tpu_torch.convert import load_export
    from transformer_tpu_torch.kernels import launch_counts
    from transformer_tpu_torch.models.paged_decode import paged_decode_forward
    from transformer_tpu_torch.serve.scheduler import ContinuousScheduler

    params, cfg = load_export(export, device="cuda")
    longest = sorted(reqs, key=lambda r: -len(r["prompt"]))[:4]
    out = {}
    for k in (0, SPEC_K):
        sched = ContinuousScheduler(params, cfg, tok, num_slots=4, prefill_chunk=64,
                                    kv_block=16, speculate_k=k, device="cuda",
                                    **PAGED_FLASH_KW)
        for r in longest:
            sched.submit({"prompt": r["prompt"], "max_new": 600})
        sched.admit()
        while k and any(st.pos < st.prompt_len for st in sched._active.values()):
            sched.step()
        graph = sched.forward
        checks = []

        def checked(toks, table, index, graph=graph, sched=sched, checks=checks):
            ref = [{key: t.clone() for key, t in p.items()} for p in sched.pools]
            c0 = launch_counts()
            got = graph(toks, table, index).clone()
            c1 = launch_counts()
            want, _ = paged_decode_forward(
                sched.params, torch.from_numpy(toks).cuda(), ref,
                torch.from_numpy(table).to(torch.int32).cuda(),
                torch.from_numpy(index).to(torch.int32).cuda(), sched.cfg,
                block_tokens=sched.block_tokens,
            )
            c2 = launch_counts()
            checks.append({
                "logits_equal": torch.equal(got, want),
                "logits_max_abs_diff": (got.float() - want.float()).abs().max().item(),
                "pools_equal": all(torch.equal(p[key], r[key])
                                   for p, r in zip(sched.pools, ref) for key in p),
                "launches_equal": {n: c1[n] - c0[n] for n in c1} == {n: c2[n] - c1[n] for n in c1},
                "launches": {n: c1[n] - c0[n] for n in c1 if c1[n] - c0[n]},
            })
            return got

        sched.forward = checked
        drafted = sched.stats["drafted"]
        for _ in range(steps):
            sched.step()
        sched.forward = graph
        replayed = step_window(sched, steps)
        sched.forward = graph.eager
        eager = step_window(sched, steps)
        label = "verify" if k else "decode"
        out[label] = {
            "speculate_k": k, "checked_steps": len(checks),
            "all_bit_identical": all(c["logits_equal"] and c["pools_equal"] for c in checks),
            "launches_equal": all(c["launches_equal"] for c in checks),
            "launches_per_step": checks[-1]["launches"] if checks else None,
            "worst_logits_abs_diff": max(c["logits_max_abs_diff"] for c in checks),
            "drafted_in_checked_steps": sched.stats["drafted"] - drafted,
            "captures": [{"shape": list(sig), "seconds": sec} for sig, sec in graph.captures],
            "graph": replayed, "eager": eager,
        }
        del sched, graph
        torch.cuda.empty_cache()
    rec = {"phase": "graphs", "step": "replay_vs_eager", "card": nvidia_smi_line(), **out}
    emit(rec)
    for label, r in out.items():
        if not (r["checked_steps"] == steps and r["all_bit_identical"] and r["launches_equal"]
                and len(r["captures"]) == 1):
            raise SystemExit(f"graphs: the replayed {label} forward differs from eager: {r}")
    if not out["verify"]["drafted_in_checked_steps"]:
        raise SystemExit("graphs: the checked verify steps carried no drafts")
    return rec


# --------------------------------------------------------------------------
# phase 11: seq2seq training over processes (data × sequence parallel)


def dist_kernel_checks():
    """The training kernels at the shapes phase 11 gives them, bf16 and
    fp32, each with its plain-version comparison and planted faults: the
    flash kernels at B 16 (a quarter of the batch under ``--dp 4``: the
    encoder at S 64 over ragged lengths with a row of PAD only, the
    decoder causal at S 63), and at 2 heads a process (Ulysses at ``--sp
    4``: B 64 over the whole S 64, the decoder's 63 padded to 64; and
    long4k's B 4, S 4096, bf16); the ring step at chunks of 16 (ring ``--sp
    4``): an encoder hop (not causal) over the third chunk of ragged
    source sentences, from an earlier hop's carry and from a fresh one,
    where the sequences that ended before the chunk visit with padding
    only and must leave the carry bit for bit; and the decoder's diagonal
    hop (causal) over the second chunk of ragged targets."""
    import numpy as np

    b, s, c = 64, S2S_LEN, S2S_LEN // 4
    flash, ring = [], []
    for dtype in ("bfloat16", "float32"):
        flash += [
            check_flash("dp4 encoder b=16", dtype, 16, s, s, 8, 8, 64, False, None, True,
                        lengths=sentence_lengths(16, s, seed=SEED + 11, empty_row=True)),
            check_flash("dp4 decoder b=16 s=63", dtype, 16, s - 1, s - 1, 8, 8, 64, True, None,
                        True, lengths=sentence_lengths(16, s - 1, seed=SEED + 12, shortest=3)),
            check_flash("ulysses encoder h=2", dtype, b, s, s, 2, 2, 64, False, None, True,
                        lengths=sentence_lengths(b, s, seed=SEED + 13, empty_row=True)),
            check_flash("ulysses decoder h=2 s=64", dtype, b, s, s, 2, 2, 64, True, None, True,
                        lengths=sentence_lengths(b, s - 1, seed=SEED + 14, shortest=3)),
        ]
        enc = np.clip(sentence_lengths(b, s, seed=SEED + 15) - 2 * c, 0, c)
        dec = np.clip(sentence_lengths(b, s - 1, seed=SEED + 16, shortest=3) - c, 0, c)
        ring += [
            check_ring_step("ring c=16 encoder hop, chunks of PAD", dtype, b, c, 8, 8, 64, False,
                            None, True, lengths=enc),
            check_ring_step("ring c=16 encoder first hop, chunks of PAD", dtype, b, c, 8, 8, 64,
                            False, None, True, fresh=True, lengths=enc),
            check_ring_step("ring c=16 decoder diagonal hop", dtype, b, c, 8, 8, 64, True, None,
                            True, lengths=dec),
        ]
    flash.append(check_flash("ulysses long4k h=2", "bfloat16", 4, 4096, 4096, 2, 2, 64, True,
                             None, True))
    return flash, ring


def dist_argv(data, src_vocab, tgt_vocab, root, name, impl, *mesh):
    """``cli.distributed_train --preset base --attention_impl impl
    --sequence_length 64 --epochs 1 --consistency_check`` at phase 9's
    depth (``CKPT_LAYERS`` + ``CKPT_LAYERS``) on the cut corpus over
    ``mesh`` (``--dp 4`` or ``--sp 4``)."""
    return [
        "--preset", "base", "--num_layers", str(CKPT_LAYERS), "--attention_impl", impl,
        "--sequence_length", str(S2S_LEN),
        "--epochs", "1", "--consistency_check", *mesh, "--dataset_path", data,
        "--src_vocab_file", src_vocab, "--tgt_vocab_file", tgt_vocab,
        "--ckpt_path", os.path.join(root, name), "--export_path", os.path.join(root, f"{name}_export"),
        "--eval_bleu", "false", "--device", "cuda",
    ]


def hold_losses(rec, want_losses, label):
    """Every step's loss within 0.01 of the single-process run's."""
    got = rec["losses"]
    diff = [abs(a - b) for a, b in zip(got, want_losses)]
    rec_h = {"phase": "s2s_dist", "step": f"{rec['step']} losses against {label}",
             "steps": len(got), "reference_steps": len(want_losses),
             "worst_step_diff": max(diff), "step_diffs": diff, "limit": 0.01}
    emit(rec_h)
    if len(got) != len(want_losses) or max(diff) > 0.01:
        raise SystemExit(f"{rec['step']}: losses not within 0.01 of {label}: {rec_h}")
    return rec_h


def _fp32_mesh_worker(rank, world, port, model_kw, batch, ring_job, out_path):
    """One rank of the fp32 parity checks: one seq2seq step's loss and
    gradients (summed over the processes) under dp 4 with flash, ring sp 4
    and Ulysses sp 4 in turn, then phase 7's long4k ring step
    (``ring_job`` = (vocab size, batch, layers)), written by rank 0: one
    spawn of the four processes for both phases' checks."""
    import torch

    from transformer_tpu_torch.config import MeshConfig, ModelConfig, TrainConfig
    from transformer_tpu_torch.models.transformer import flatten, init_params
    from transformer_tpu_torch.parallel.distributed import _seq_parallel_forward_loss
    from transformer_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    from transformer_tpu_torch.train.trainer import loss_and_grads

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost", MASTER_PORT=str(port))
    process = initialize_distributed("cuda", log_fn=lambda *_: None)
    src, tgt = (torch.from_numpy(a).to(process.device, torch.long) for a in batch)
    out = {}
    for label, impl, mesh_cfg in (("dp4 flash", "flash", MeshConfig(data=world)),
                                  ("ring sp4", "ring", MeshConfig(seq=world)),
                                  ("ulysses sp4", "ulysses", MeshConfig(seq=world))):
        mesh = make_mesh(mesh_cfg, process)
        cfg = ModelConfig(**{**model_kw, "attention_impl": impl})
        params = init_params(cfg, torch.Generator().manual_seed(SEED), device=process.device)
        for p in flatten(params).values():
            p.requires_grad_(True)
        t0 = time.perf_counter()
        metrics, grads = loss_and_grads(params, tgt, cfg, TrainConfig(batch_size=64), None,
                                        forward_loss=_seq_parallel_forward_loss(mesh), src=src)
        mesh.all_reduce_sum_([*grads.values(), *metrics.values()])
        torch.cuda.synchronize()
        out[label] = {"loss": float(metrics["loss"]), "seconds": time.perf_counter() - t0,
                      "grads": {k: g.cpu() for k, g in grads.items()}}
        del params, metrics, grads
    t0 = time.perf_counter()
    out["long4k ring"] = _fp32_ring_step(process, *ring_job)
    torch.cuda.synchronize()
    out["long4k ring"]["seconds"] = time.perf_counter() - t0
    if rank == 0:
        torch.save(out, out_path)
    torch.distributed.destroy_process_group()


def s2s_fp32_mesh_check(model_cfg, batch, tok, lm_tgt, layers: int = 2, procs: int = 4):
    """One fp32 seq2seq step at base width (2 + 2 layers, B 64, S 64,
    dropout 0, kernels on) over four processes on this card, under dp 4
    (flash), ring sp 4 and Ulysses sp 4, each against the single-process
    flash step from the same init and batch, held to the fp32 step's
    limits (``hold_to_train_tol``); the same processes then take phase 7's
    fp32 long4k ring step on ``lm_tgt`` (``fp32_ring_check``)."""
    import dataclasses as dc
    import socket

    import torch
    import torch.multiprocessing as mp

    from transformer_tpu_torch.config import TrainConfig
    from transformer_tpu_torch.models.transformer import flatten, init_params
    from transformer_tpu_torch.train.trainer import loss_and_grads

    cfg = dc.replace(model_cfg, num_layers=layers, dtype="float32", dropout_rate=0.0,
                     attention_impl="flash")
    model_kw = dc.asdict(cfg)
    out_path = os.path.join(BUILD_DIR, "fp32_mesh_grads.pt")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mp.spawn(_fp32_mesh_worker, args=(procs, port, model_kw, batch,
                                      (tok.model_vocab_size, lm_tgt, layers), out_path),
             nprocs=procs, join=True)
    spawn_s = time.perf_counter() - t0
    runs = torch.load(out_path)
    fp32_ring_check(tok, lm_tgt, runs.pop("long4k ring"), layers, procs)
    params = init_params(cfg, torch.Generator().manual_seed(SEED), device="cuda")
    for p in flatten(params).values():
        p.requires_grad_(True)
    src, tgt = (torch.from_numpy(a).to("cuda", torch.long) for a in batch)
    metrics, want = loss_and_grads(params, tgt, cfg, TrainConfig(batch_size=64), None, src=src)
    want_run = (float(metrics["loss"]), want)
    recs = []
    for label, run in runs.items():
        got = {k: g.cuda() for k, g in run["grads"].items()}
        recs.append(hold_to_train_tol(
            {"phase": "s2s_dist", "step": "fp32_mesh_check", "mesh": label, "layers": layers,
             "batch": 64, "processes": procs, "step_seconds": run["seconds"],
             "spawn_seconds": spawn_s},
            (run["loss"], got), want_run, f"fp32 {label} step against the single-process step"))
    return recs


def s2s_dist_path(src_vocab, tgt_vocab, e_rec, single):
    """Phase 11. Transformer-base (d 512, 8 x 64, dff 2048, bf16, batch 64,
    dropout 0.1; its depth cut to L + L = 2 + 2 layers, as phase 9's)
    trained for an epoch of the 1,300 cut pairs
    (20 steps) through ``cli.distributed_train --consistency_check`` by
    four processes on this card, under ``--dp 4`` (flash), ``--sp 4`` with
    ring attention and ``--sp 4`` with Ulysses: counters per rank (flash:
    2L of each kernel a step, 2L forward an eval batch, L more on rank 0
    for the epilogue's sample translation; ring: rank r folds L x 4
    encoder hops and L x (r + 1) decoder hops a forward, and as many dQ
    and dK/dV a step), bit-identical ranks, and every step's loss within
    0.01 of phase 9's E (``cli.train``, the same flags and seed) in its
    first epoch. The dp 4 export is translated (greedy and beam 4, 8
    sentences) and scored (``cli.evaluate --limit 200``). Then long4k at
    2 layers with ``--attention_impl ulysses --sp 4`` for an epoch, held
    to ``single`` (phase 7's single-card run of its flags) within 0.01.
    Returns the flash and ring counters of the phase's main-path runs."""
    data = cut_corpus(CKPT_PAIRS)
    root = fresh_dir("ckpt", "s2s_dist")
    launches = {"flash_fwd": 0, "flash_dq": 0, "flash_dkdv": 0, "flash_ring_step": 0}
    e_losses = e_rec["losses"][: e_rec["steps_per_epoch"]]
    L = CKPT_LAYERS
    hops = {r: L * 4 + L * (r + 1) for r in range(4)}  # encoder: every hop; decoder: causal

    def flash_want(rank, steps, evals):
        return {"flash_fwd": 2 * L * (steps + evals) + (L if rank == 0 else 0),
                "flash_ring_step": 0, "flash_dq": 2 * L * steps, "flash_dkdv": 2 * L * steps}

    def ring_want(rank, steps, evals):
        return {"flash_fwd": L if rank == 0 else 0,
                "flash_ring_step": hops[rank] * (steps + evals),
                "flash_dq": hops[rank] * steps, "flash_dkdv": hops[rank] * steps}

    recs = {}
    for name, impl, mesh, want_fn in (("dp4_flash", "flash", ("--dp", "4"), flash_want),
                                      ("ring_sp4", "ring", ("--sp", "4"), ring_want),
                                      ("ulysses_sp4", "ulysses", ("--sp", "4"), flash_want)):
        args = dist_argv(data, src_vocab, tgt_vocab, root, name, impl, *mesh)
        rec, counts = dist_fit("s2s_dist", name, args, want_fn,
                               os.path.join(root, f"{name}_export"))
        hold_losses(rec, e_losses, "phase 9's E, epoch 1")
        recs[name] = rec
        for key, n in counts.items():
            launches[key] += n
    tr_launches, tr_rec = translate_path(os.path.join(root, "dp4_flash_export"), src_vocab,
                                         tgt_vocab, phase="s2s_dist")
    for key, n in tr_launches.items():
        launches[key] += n

    # long4k over Ulysses, at phase 7's depth
    export = os.path.join(root, "long4k_ulysses_export")
    args = ["--preset", "long4k", "--num_layers", str(SP_LAYERS), "--attention_impl", "ulysses",
            "--sp", "4", "--epochs", "1", "--consistency_check",
            "--dataset_path", os.path.join(ROOT, "data"), "--tgt_vocab_file", tgt_vocab,
            "--export_path", export, "--ckpt_path", os.path.join(root, "long4k_ulysses"),
            "--device", "cuda"]
    layers = single["config"]["num_layers"]

    def long4k_want(rank, steps, evals):  # remat: each forward twice in a step
        return {"flash_fwd": layers * (2 * steps + evals), "flash_ring_step": 0,
                "flash_dq": layers * steps, "flash_dkdv": layers * steps}

    rec, counts = dist_fit("s2s_dist", "long4k_ulysses_sp4", args, long4k_want, export)
    for key, n in counts.items():
        launches[key] += n
    hold_to_single(rec, single)
    recs["long4k_ulysses_sp4"] = rec
    return launches, recs, tr_rec


# --------------------------------------------------------------------------
# phase 12: the grouped serving path, cli.generate, admission control


GROUPED_GREEDY, GROUPED_BEAM = 48, 16  # data/src-test.txt lines served raw / at beam 4
GEN_NEW = 32  # max_new of phase 12's LM runs
DEADLINE_MS = 120  # the mid-generation deadline (max_new 512 at ~1 ms a replayed step)


def grouped_translate_path(export, src_vocab, tgt_vocab):
    """Phase 12, the translator behind ``cli.serve``: phase 6's
    Transformer-base export (flash encoder, bf16) at ``--serve_batch 64``
    answers the first 48 lines of data/src-test.txt as raw lines (greedy),
    the next 16 as ``{"src": ..., "beam": 4}``, one malformed line and one
    ``prompt`` line. ``translate`` is wrapped to record every call (each
    signature group, and each member of a group retried alone); the flash
    counters are set to 0 just before serving and read just after: 6
    forward launches (the encoder) per call. Every answer must be what
    ``translate`` gives its sentence in the group the server formed (run
    again here), the two errors the lines JAX's ``serve_lines`` answers
    (no ``code``). Then ``cli.translate`` on the same 48 and 16 sentences
    (batch 64 rows each), the answers that differ counted (reported: the
    row padding differs). Returns the flash counters."""
    import torch

    from transformer_tpu_torch.cli import serve
    from transformer_tpu_torch.cli import translate as cli_translate
    from transformer_tpu_torch.convert import load_export, load_export_config
    from transformer_tpu_torch.data.tokenizer import SubwordTokenizer
    from transformer_tpu_torch.train import decode

    sentences = source_sentences(GROUPED_GREEDY + GROUPED_BEAM)
    greedy, beam = sentences[:GROUPED_GREEDY], sentences[GROUPED_GREEDY:]
    malformed = '{"src": "he goes'
    lines = [*greedy, *(json.dumps({"src": s, "beam": 4}) for s in beam), malformed,
             json.dumps({"prompt": greedy[0]})]
    try:
        json.loads(malformed)
        raise SystemExit("the malformed line parsed")
    except json.JSONDecodeError as e:
        want_errors = [{"error": f"JSONDecodeError: {e}"},
                       {"error": "seq2seq export serves 'src', not 'prompt'"}]
    calls = []
    real = decode.translate

    def recorded(params, cfg, src_tok, tgt_tok, sents, **kw):
        call = {"sentences": list(sents), "kw": kw}
        calls.append(call)
        t0 = time.perf_counter()
        call["out"] = real(params, cfg, src_tok, tgt_tok, sents, **kw)
        torch.cuda.synchronize()
        call["seconds"] = time.perf_counter() - t0
        return call["out"]

    argv = ["--export_path", export, "--src_vocab_file", src_vocab, "--tgt_vocab_file",
            tgt_vocab, "--max_len", str(S2S_LEN), "--serve_batch", "64", "--device", "cuda"]
    out = io.StringIO()
    decode.translate = recorded
    try:
        read_flash_counters(reset=True)
        t0 = time.perf_counter()
        batches = serve.main(argv, stdin=io.StringIO("".join(x + "\n" for x in lines)),
                             stdout=out)
        torch.cuda.synchronize()
        main_wall = time.perf_counter() - t0
        launches = read_flash_counters()
    finally:
        decode.translate = real
    answers = [json.loads(x) for x in out.getvalue().splitlines()]
    layers = load_export_config(export).num_layers
    want_launches = {"flash_fwd": layers * len(calls), "flash_dq": 0, "flash_dkdv": 0}
    # Each group the server formed, translated again: the answers must be
    # those of translate on the same sentences in the same groups.
    params, cfg = load_export(export, device="cuda")
    toks = (SubwordTokenizer.load(src_vocab), SubwordTokenizer.load(tgt_vocab))
    rerun = {}
    for call in calls:
        if "out" not in call:
            continue
        again = real(params, cfg, *toks, call["sentences"], **call["kw"])
        for s, text in zip(call["sentences"], again):
            rerun.setdefault((s, call["kw"]["beam_size"]), set()).add(text)
    wrong = [i for i, (s, b) in enumerate([(s, 1) for s in greedy] + [(s, 4) for s in beam])
             if answers[i].get("translation") not in rerun.get((s, b), set())]
    common = ["--export_path", export, "--src_vocab_file", src_vocab, "--tgt_vocab_file",
              tgt_vocab, "--max_len", str(S2S_LEN), "--device", "cuda"]
    direct = (
        cli_translate.main(common, stdin=io.StringIO("\n".join(greedy) + "\n"),
                           stdout=io.StringIO())
        + cli_translate.main(common + ["--beam", "4"], stdin=io.StringIO("\n".join(beam) + "\n"),
                             stdout=io.StringIO())
    )
    served_s = sum(b["seconds"] for b in batches)
    rec = {
        "phase": "serve_grouped", "step": "translator", "card": nvidia_smi_line(),
        "argv": argv, "requests": len(lines), "answers": len(answers),
        "batches": batches, "serve_s": served_s, "main_wall_s": main_wall,
        "requests_per_s": len(lines) / served_s,
        "translate_calls": [{"rows": len(c["sentences"]), "beam": c["kw"]["beam_size"],
                             "seconds": c.get("seconds")} for c in calls],
        "launches": launches, "expected_launches": want_launches,
        "error_answers": answers[-2:], "expected_errors": want_errors,
        "answers_not_translate": wrong,
        "differ_from_cli_translate": sum(
            1 for a, d in zip(answers, direct) if a.get("translation") != d),
    }
    emit(rec)
    if len(answers) != len(lines) or answers[-2:] != want_errors or wrong:
        raise SystemExit(f"grouped serving of the translator failed: {rec}")
    if any("code" in a for a in answers) or any("error" in a for a in answers[:-2]):
        raise SystemExit(f"grouped answers carry errors or codes: {answers}")
    if launches != want_launches or not calls:
        raise SystemExit(f"flash launches {launches}, expected {want_launches}")
    return launches


def generate_path(export, vocab_path, tok, reqs, plain_answers):
    """Phase 12, the LM over dense caches: ``cli.generate --max_new 32`` on
    phase 4's 14 prompts (one batch of 16 rows), then the same prompts as
    greedy ``{"prompt": ..., "max_new": 32}`` lines through ``cli.serve
    --serve_slots 0 --serve_batch 64`` (the grouped path); wall time and
    generated tokens a second of each (``lm_generate`` wrapped to count
    its tokens, ``transformer_decode_step`` to count the loop's ticks). For
    the 4 shortest prompts: ``speculative_generate`` at k 4 (n-gram
    drafter), its ``verify_forwards`` / ``drafted`` / ``accepted``, batch-1
    ``generate``, and a profiled window of their batch
    (``generate_window``). Counted, not gated (cached
    attention is plain, and bf16 rounds otherwise than kernels B and A):
    grouped answers that differ from ``cli.generate``'s; greedy answers
    that disagree with phase 4's paged-kernel answers over their common
    tokens; batched and speculative answers that differ from batch-1."""
    import torch

    from transformer_tpu_torch.cli import generate as cli_generate
    from transformer_tpu_torch.cli import serve
    from transformer_tpu_torch.config import PAD_ID
    from transformer_tpu_torch.convert import load_export
    from transformer_tpu_torch.kernels.paged_flash import paged_flash_attention
    from transformer_tpu_torch.ops.ffn import fused_ln_ffn
    from transformer_tpu_torch.serve.speculative import speculative_generate
    from transformer_tpu_torch.train import decode

    prompts = [r["prompt"] for r in reqs]
    runs = []
    ticks = [0]  # decode steps (one a tick of lm_generate's loop)
    real, real_step = decode.lm_generate, decode.transformer_decode_step

    def counted(params, ids, cfg, *a, **kw):
        torch.cuda.synchronize()
        t0, ticks0 = time.perf_counter(), ticks[0]
        out = real(params, ids, cfg, *a, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        runs.append({"rows": ids.shape[0], "width": ids.shape[1],
                     "tokens": int((out != PAD_ID).sum()), "seconds": seconds,
                     "ticks": ticks[0] - ticks0,
                     "ms_per_tick": seconds / max(1, ticks[0] - ticks0) * 1e3})
        return out

    def counted_step(*a, **kw):
        ticks[0] += 1
        return real_step(*a, **kw)

    paged_flash_attention.launches = 0
    fused_ln_ffn.launches = 0
    decode.lm_generate, decode.transformer_decode_step = counted, counted_step
    try:
        t0 = time.perf_counter()
        generated = cli_generate.main(
            ["--export_path", export, "--vocab_file", vocab_path, "--max_new", str(GEN_NEW),
             "--device", "cuda"], stdin=io.StringIO("\n".join(prompts) + "\n"),
            stdout=io.StringIO())
        gen_wall = time.perf_counter() - t0
        gen_runs = list(runs)
        lines = "".join(json.dumps({"prompt": p, "max_new": GEN_NEW}) + "\n" for p in prompts)
        out = io.StringIO()
        batches = serve.main(["--export_path", export, "--tgt_vocab_file", vocab_path,
                              "--serve_slots", "0", "--serve_batch", "64", "--device", "cuda"],
                             stdin=io.StringIO(lines), stdout=out)
        grouped = [json.loads(x).get("continuation") for x in out.getvalue().splitlines()]
        grouped_runs = runs[len(gen_runs):]
        params, cfg = load_export(export, device="cuda")
        short = sorted(range(len(prompts)), key=lambda i: len(prompts[i]))[:4]
        spec, single = [], []
        for i in short:
            ids = [tok.bos_id, *tok.encode(prompts[i])]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks, stats = speculative_generate(params, cfg, ids, GEN_NEW, tok.eos_id,
                                               speculate_k=SPEC_K)
            torch.cuda.synchronize()
            spec.append({"prompt": i, "prompt_tokens": len(ids), "tokens": len(toks),
                         "seconds": time.perf_counter() - t0, **stats,
                         "text": tok.decode([t for t in toks if t not in (PAD_ID, tok.eos_id)])})
            single.append(decode.generate(params, cfg, tok, [prompts[i]], max_new=GEN_NEW)[0])
        window = generate_window(lambda: decode.generate(
            params, cfg, tok, [prompts[i] for i in short], max_new=GEN_NEW), ticks)
    finally:
        decode.lm_generate, decode.transformer_decode_step = real, real_step
    ba_launches = {"paged_attention": paged_flash_attention.launches,
                   "fused_ln_ffn": fused_ln_ffn.launches}
    greedy = [i for i, r in enumerate(reqs) if "temperature" not in r]

    def disagree(a, b):  # over their common prefix: max_new differs
        return not (a.startswith(b) or b.startswith(a))

    gen_tokens = sum(r["tokens"] for r in gen_runs)
    gen_s = sum(r["seconds"] for r in gen_runs)
    grouped_tokens = sum(r["tokens"] for r in grouped_runs)
    grouped_s = sum(b["seconds"] for b in batches)
    rec = {
        "phase": "serve_grouped", "step": "generate", "card": nvidia_smi_line(),
        "prompts": len(prompts), "max_new": GEN_NEW,
        "generate": {"wall_s": gen_wall, "lm_generate_s": gen_s, "tokens": gen_tokens,
                     "tokens_per_s": gen_tokens / gen_s, "runs": gen_runs},
        "grouped_serve": {"serve_s": grouped_s, "tokens": grouped_tokens,
                          "tokens_per_s": grouped_tokens / grouped_s,
                          "requests_per_s": len(prompts) / grouped_s, "batches": batches,
                          "runs": grouped_runs},
        "grouped_differ_from_generate": [i for i in range(len(prompts))
                                         if grouped[i] != generated[i]],
        "greedy_disagree_with_phase4": [i for i in greedy if disagree(
            generated[i], plain_answers[i]["continuation"])],
        "speculative_k4": [{k: v for k, v in s.items() if k != "text"} for s in spec],
        "speculative_differ_from_batch1": [s["prompt"] for s, b in zip(spec, single)
                                           if s["text"] != b],
        "batched_differ_from_batch1": [i for i, b in zip(short, single) if generated[i] != b],
        "window_4_shortest": window,
        "paged_kernel_launches": ba_launches,
    }
    emit(rec)
    if len(generated) != len(prompts) or len(grouped) != len(prompts) or None in grouped:
        raise SystemExit(f"cli.generate / grouped LM serving failed: {rec}")
    if not any(generated) or not all(s["verify_forwards"] for s in spec):
        raise SystemExit(f"generation produced nothing: {rec}")
    if any(ba_launches.values()):
        raise SystemExit(f"the dense path launched the paged kernels: {ba_launches}")
    return rec


def generate_window(fn, ticks) -> dict:
    """Where a tick of ``lm_generate``'s eager loop goes: ``fn`` (one
    ``generate`` call) timed on the host clock, then again under
    ``torch.profiler``: device time and busy share per tick (summed
    kernel time over the unprofiled wall), the top kernels, and the host's
    launch and synchronize calls per tick. ``ticks`` counts decode steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0, ticks0 = time.perf_counter(), ticks[0]
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = max(1, ticks[0] - ticks0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    averages = prof.key_averages()
    events = [e for e in averages
              if str(getattr(e, "device_type", "")).endswith("CUDA") and dev_us(e) > 0]
    device_ms = sum(dev_us(e) for e in events) / n / 1e3
    return {
        "ticks": n, "wall_ms_per_tick": wall / n * 1e3,
        "device_ms_per_tick": device_ms if events else "not measured",
        "device_busy_share": device_ms / (wall / n * 1e3) if events else "not measured",
        "host_calls_per_tick": {e.key: e.count / n for e in averages
                                if e.key in ("cudaLaunchKernel", "cudaStreamSynchronize",
                                             "cudaMemcpyAsync", "cudaDeviceSynchronize")},
        "top_kernels": [{"name": e.key[:80], "ms_per_tick": dev_us(e) / n / 1e3,
                         "calls_per_tick": e.count / n}
                        for e in sorted(events, key=dev_us, reverse=True)[:6]],
    }


def admission_path(export, vocab_path, reqs, plain_answers):
    """Phase 12, admission control on the replayed scheduler: phase 4's
    export through ``cli.serve``'s scheduler with ``--max_backlog 4`` (4
    slots, every step a CUDA-graph replay). Phase 4's 14 requests at once
    (4 queue, 10 answer ``backpressure``); two with ``deadline_ms`` 0 and
    one more queued behind the full slots, which ``cancel()`` takes back
    (all three answered at the next step boundary); request 2 cancelled in
    flight once it has emitted tokens; then a request with ``max_new`` 512
    and a ``deadline_ms`` of 120 that expires mid-generation. Codes and
    counts must be the expected ones, aborted answers that emitted tokens
    must carry ``partial``, every answer that completes must be
    byte-identical to phase 4's, the pool's free blocks must be back at
    their starting count, and kernels B and A must have launched layers x
    decode forwards (counters set to 0 just before, read just after)."""
    import torch

    from transformer_tpu_torch.cli import serve
    from transformer_tpu_torch.kernels.paged_flash import paged_flash_attention
    from transformer_tpu_torch.ops.ffn import fused_ln_ffn

    argv = serve_argv(export, vocab_path, "--max_backlog", "4")
    sched = serve.build_scheduler(serve.build_parser().parse_args(argv))
    free0 = sched.alloc.free_blocks
    paged_flash_attention.launches = 0
    fused_ln_ffn.launches = 0
    t0 = time.perf_counter()
    orders = [sched.submit(dict(r)) for r in reqs]
    sched.admit()
    expired = [sched.submit({**reqs[1], "deadline_ms": 0}) for _ in range(2)]
    queued = sched.submit(dict(reqs[5]))
    cancels = [sched.cancel(queued)]
    sched.step()  # the sweep answers the deadline pair and the queued cancel
    in_flight = orders[2]
    while not any(st.order == in_flight and st.emitted for st in sched._active.values()):
        sched.admit()
        sched.step()
    cancels.append(sched.cancel(in_flight))
    sched.step()
    late = sched.submit({"prompt": reqs[4]["prompt"], "max_new": 512,
                         "deadline_ms": DEADLINE_MS})
    while sched.busy:
        sched.admit()
        sched.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    answers = sched.drain_ready()
    launches = {"paged_attention": paged_flash_attention.launches,
                "fused_ln_ffn": fused_ln_ffn.launches}
    want_launches = sched.cfg.num_layers * sched.stats["steps"]
    sched.alloc.check_consistency()
    codes = [a.get("code", "ok") for a in answers]
    want_codes = (["ok", "ok", "cancelled", "ok"] + ["backpressure"] * 10
                  + ["deadline", "deadline", "cancelled", "deadline"])
    completed = [o for o in orders[:4] if o != in_flight]
    rec = {
        "phase": "serve_grouped", "step": "admission", "card": nvidia_smi_line(), "argv": argv,
        "codes": codes, "expected_codes": want_codes, "cancel_accepted": cancels,
        "stats": {k: sched.stats[k] for k in ("deadline_expired", "cancelled", "backpressure",
                                              "admitted", "steps", "generated_tokens")},
        "in_flight_cancel": answers[in_flight], "late_deadline": answers[late],
        "queue_deadlines": [answers[o] for o in expired],
        "completed_identical_to_phase4": [answers[o] == plain_answers[o] for o in completed],
        "free_blocks": {"start": free0, "end": sched.alloc.free_blocks},
        "launches": launches, "expected_launches": want_launches,
        "wall_s": wall, "steps": sched.stats["steps"],
        "captures": [{"shape": list(sig), "seconds": sec} for sig, sec in sched.forward.captures],
    }
    emit(rec)
    late_msg = answers[late].get("error", "")
    ok = (
        codes == want_codes and all(cancels) and all(rec["completed_identical_to_phase4"])
        and "partial" in answers[in_flight] and "partial" in answers[late]
        and re.fullmatch(r"deadline_ms elapsed after \d+ of 512 tokens", late_msg)
        and all("in the admission queue" in answers[o]["error"] for o in expired)
        and sched.stats["backpressure"] == 10 and sched.stats["deadline_expired"] == 3
        and sched.stats["cancelled"] == 2 and sched.alloc.free_blocks == free0
    )
    if not ok:
        raise SystemExit(f"admission control failed: {rec}")
    for name, count in launches.items():
        if count <= 0 or count != want_launches:
            raise SystemExit(f"{name} launched {count} times, expected {want_launches}")
    return launches


# --------------------------------------------------------------------------
# phase 13: the JAX server's default layouts (dense; paged through gathered
# views), rolling-window caches for a windowed model, and the circuit
# breakers under injected faults

LAYOUT_FLAGS = {
    "dense": ("--kv_layout", "dense", "--decode_kernel", "xla"),
    "paged_xla": ("--kv_layout", "paged", "--decode_kernel", "xla"),
}
WINDOW = 1024  # --attention_window of phase 13's windowed long4k
WINDOW_CHUNK = 512  # its --prefill_chunk
WINDOW_PAIRS = 3000  # corpus pairs its training reads (a few steps)
WINDOW_LAYERS = 2  # its depth, cut: its batch-1 generate runs ~3,900 eager ticks a dtype


def replayed(sched, steps: int) -> dict:
    """How a run's steps reached the card: replays of a captured graph,
    and the captures (each shape's first step runs eagerly, then is
    captured). Every step goes through the graph: replays + captures ==
    steps."""
    graph = sched.forward
    return {"steps": steps, "replays": graph.replays,
            "captures": [{"shape": list(sig), "seconds": sec} for sig, sec in graph.captures],
            "every_step_through_the_graph": graph.replays + len(graph.captures) == steps}


def layout_profile(export, tok, reqs, layout, steps: int = 20) -> dict:
    """``decode_profile``'s replayed window on another layout: four slots
    on the longest prompts, 5 warm steps, then ``step_window``."""
    from transformer_tpu_torch.convert import load_export
    from transformer_tpu_torch.serve.scheduler import ContinuousScheduler

    params, cfg = load_export(export, device="cuda")
    kw = dict(zip(layout[::2], layout[1::2]))
    sched = ContinuousScheduler(
        params, cfg, tok, num_slots=4, prefill_chunk=64, kv_block=16, device="cuda",
        kv_layout=kw["--kv_layout"], decode_kernel=kw["--decode_kernel"],
    )
    for r in sorted(reqs, key=lambda r: -len(r["prompt"]))[:4]:
        sched.submit({"prompt": r["prompt"], "max_new": 64})
    sched.admit()
    for _ in range(5):
        sched.step()
    return step_window(sched, steps)


def layouts_path(export, vocab_path, tok, reqs, plain_answers, graph_rec, fp32_answers):
    """Phase 4's export and 14 requests under ``--kv_layout dense`` and
    ``--kv_layout paged --decode_kernel xla``, plain and at ``--speculate_k
    4`` (n-gram). Gates: the two layouts' answers byte-identical (the
    gathered views run the dense step at the dense shapes), kernels B and
    A launched 0 times, every step a replay of the run's one captured graph.
    Reported: answers that differ from phase 4's paged_flash answers (plain
    attention rounds otherwise than kernel B in bf16), and per layout a
    profiled window of four busy slots beside phase 10's replayed kernel
    step. Gate, in fp32: the dense layout's greedy answers equal phase
    10's fp32 answers on kernels B and A (``fp32_answers["plain"]``), the
    path that shares no code with the dense step's attention and FFN.
    Then phase 10's 16 shared-prefix requests on the dense layout,
    once without the cache and twice with ``--prefix_cache_mb 64``: the
    second pass must hit (the stacked host blocks restored into the
    slot); reported, the prefill tokens each forwards and the answers
    that differ from the run without the cache."""
    runs, differing = {}, {}
    for name, layout in LAYOUT_FLAGS.items():
        for k in (0, SPEC_K):
            extra = ("--speculate_k", str(k)) if k else ()
            argv = serve_argv(export, vocab_path, *extra, layout=layout)
            sched, [(answers, st, wall)], counts = serve_passes(argv, [reqs])
            label = f"{name} k={k}"
            runs[label] = {
                "answers": answers, "errors": [a for a in answers if "error" in a],
                "launches": counts, "wall_s": wall, **replayed(sched, st["steps"]),
                "step_ms": st["decode_s"] / max(1, st["steps"]) * 1e3,
                "prefill_ms": st["prefill_s"] * 1e3, "generated_tokens": st["generated_tokens"],
                "tokens_per_s": st["generated_tokens"] / wall,
                "drafted": st["drafted"], "accepted": st["accepted"],
            }
            differing[label] = [i for i, a in enumerate(answers) if a != plain_answers[i]]
            del sched
    same = {f"k={k}": runs[f"dense k={k}"]["answers"] == runs[f"paged_xla k={k}"]["answers"]
            for k in (0, SPEC_K)}
    greedy = [i for i, r in enumerate(reqs) if "temperature" not in r]
    _, [(answers32, st32, wall32)], counts32 = serve_passes(
        serve_argv(fp32_export(export), vocab_path, layout=LAYOUT_FLAGS["dense"]), [reqs])
    dense32 = {
        "wall_s": wall32, "steps": st32["steps"], "launches": counts32,
        "errors": [a for a in answers32 if "error" in a], "answers": len(answers32),
        "greedy_differing_from_fp32_paged_flash": [
            i for i in greedy if answers32[i] != fp32_answers["plain"][i]],
        "sampled_differing_from_fp32_paged_flash": [
            i for i in range(len(reqs))
            if i not in greedy and answers32[i] != fp32_answers["plain"][i]],
    }
    profiles = {name: layout_profile(export, tok, reqs, layout)
                for name, layout in LAYOUT_FLAGS.items()}
    profiles["paged_flash (phase 10)"] = graph_rec["decode"]["graph"]
    preqs = prefix_requests(tok)
    _, [(off_answers, off, _)], _ = serve_passes(
        serve_argv(export, vocab_path, layout=LAYOUT_FLAGS["dense"]), [preqs])
    argv = serve_argv(export, vocab_path, "--prefix_cache_mb", "64", layout=LAYOUT_FLAGS["dense"])
    sched, passes, counts = serve_passes(argv, [preqs, preqs])
    prefix = {
        "argv": argv, "launches": counts, "prefill_tokens_without_cache": off["prefill_tokens"],
        "answers_differing_from_without_cache": [
            i for i, (a, b) in enumerate(zip(passes[1][0], off_answers)) if a != b],
        "passes": [{"prefill_tokens": st["prefill_tokens"],
                    "prefix_hit_tokens": st["prefix_hit_tokens"],
                    "prefill_forwards": st["prefill_forwards"], "wall_s": wall,
                    "errors": [a for a in answers if "error" in a]}
                   for answers, st, wall in passes],
        "answers_equal_across_passes": passes[0][0] == passes[1][0],
        "cache_stats": dict(sched.prefix_cache.stats),
    }
    del sched
    rec = {
        "phase": "layouts", "step": "serve", "card": nvidia_smi_line(),
        **{label: {k: v for k, v in r.items() if k != "answers"} for label, r in runs.items()},
        "dense_equals_paged_xla": same, "differing_from_phase4_paged_flash": differing,
        "fp32_dense": dense32, "profiles": profiles, "prefix_dense": prefix,
        "timers": "step_ms: host clock per step of the run; profiles: step_window (wall: host "
                  "clock, device: torch.profiler kernel time)",
    }
    emit(rec)
    bad = [label for label, r in runs.items()
           if r["errors"] or len(r["answers"]) != len(reqs) or not r["every_step_through_the_graph"]
           or len(r["captures"]) != 1 or any(r["launches"].values())]
    if bad or not all(same.values()):
        raise SystemExit(f"layouts: {bad or 'dense and paged-xla answers differ'}: {rec}")
    if (dense32["errors"] or dense32["answers"] != len(reqs)
            or dense32["greedy_differing_from_fp32_paged_flash"]):
        raise SystemExit(f"layouts: fp32 dense answers differ from fp32 paged_flash's: {dense32}")
    if not prefix["passes"][1]["prefix_hit_tokens"] or any(p["errors"] for p in prefix["passes"]):
        raise SystemExit(f"layouts: no prefix hit on the dense layout: {prefix}")
    return rec, answers32


def prompt_of(tok, tokens: int, start: int) -> str:
    """A prompt of about ``tokens`` tokens: words of data/tgt-test.txt
    from word ``start`` on."""
    with open(os.path.join(ROOT, "data", "tgt-test.txt"), encoding="utf-8") as f:
        words = f.read().split()
    out = []
    while len(tok.encode(" ".join(out))) < tokens - 1:
        out.append(words[(start + len(out)) % len(words)])
    return " ".join(out)


def windowed_train(vocab_path):
    """``cli.train --preset long4k --num_layers 2 --attention_window 1024``
    for one epoch on the first ``WINDOW_PAIRS`` corpus lines: the flash
    kernels on their band path at full width, counted (set to 0 just
    before, read just after); the export."""
    import torch

    from transformer_tpu_torch.cli import train
    from transformer_tpu_torch.kernels.flash_attention import flash_dkdv, flash_dq, flash_fwd

    export = os.path.join(BUILD_DIR, "windowed_export")
    argv = ["--preset", "long4k", "--num_layers", str(WINDOW_LAYERS),
            "--attention_window", str(WINDOW), "--epochs", "1",
            "--dataset_path", cut_corpus(WINDOW_PAIRS), "--tgt_vocab_file", vocab_path,
            "--export_path", export, "--ckpt_path", fresh_dir("ckpt", "windowed"),
            "--device", "cuda"]
    flash_fwd.launches = flash_dq.launches = flash_dkdv.launches = 0
    t0 = time.perf_counter()
    trainer = train.main(argv, log_fn=lambda _: None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": flash_fwd.launches, "flash_dq": flash_dq.launches,
                "flash_dkdv": flash_dkdv.launches}
    cfg = trainer.model_cfg
    steps, evals = len(trainer.step_seconds), trainer.eval_batches
    want = {"flash_fwd": cfg.num_layers * ((2 if cfg.remat else 1) * steps + evals),
            "flash_dq": cfg.num_layers * steps, "flash_dkdv": cfg.num_layers * steps}
    rec = {"phase": "windowed", "step": "train", "card": nvidia_smi_line(), "argv": argv,
           "window": cfg.attention_window,
           "steps": steps, "eval_batches": evals, "wall_s": wall,
           "step_ms": [t * 1e3 for t in trainer.step_seconds],
           "train_loss": trainer.train_metrics.loss, "launches": launches,
           "expected_launches": want}
    emit(rec)
    del trainer
    torch.cuda.empty_cache()
    if cfg.attention_window != WINDOW or steps < 1 or not math.isfinite(rec["train_loss"]):
        raise SystemExit(f"windowed training failed: {rec}")
    if launches != want or not all(launches.values()):
        raise SystemExit(f"windowed training: flash launches {launches}, expected {want}")
    return export, launches


def windowed_path(vocab_path, tok, reqs):
    """The windowed long4k export served on the dense layout (rolling
    1024-row buffers) at ``--prefill_chunk 512``: phase 4's 14 requests
    and two of about 1,500 and 3,000 tokens, so buffers wrap in prefill
    and in decode. Gate, in fp32: the answers equal ``cli.generate``'s,
    each request alone (batch 1, its max_new and sampling flags). bf16:
    the answers that differ from batch-1 ``cli.generate`` are counted.
    Gate: ``--kv_layout paged``, ``--speculate_k`` and
    ``--prefix_cache_mb`` on this export each raise the JAX package's
    message. ``cli.generate``'s answers are its call, ``decode.generate``
    (prefill chunk 0), made here on params loaded and cast to the compute
    dtype once (the CLI loads the export per call)."""
    import torch

    from transformer_tpu_torch.cli import serve
    from transformer_tpu_torch.convert import load_export
    from transformer_tpu_torch.serve.scheduler import compute_params
    from transformer_tpu_torch.train import decode

    export, train_launches = windowed_train(vocab_path)
    wreqs = [dict(r) for r in reqs] + [
        {"prompt": prompt_of(tok, 1500, 2000), "max_new": 32},
        {"prompt": prompt_of(tok, 3000, 5000), "max_new": 32},
    ]
    lengths = [len(tok.encode(r["prompt"])) + 1 for r in wreqs]
    out = {}
    for dtype, path in (("float32", fp32_export(export, "windowed_export_fp32")),
                        ("bfloat16", export)):
        argv = serve_argv(path, vocab_path, "--prefill_chunk", str(WINDOW_CHUNK),
                          layout=LAYOUT_FLAGS["dense"])
        sched, [(answers, st, wall)], counts = serve_passes(argv, [wreqs])
        buf = sched.pools[0]["k"].shape[1]
        run = replayed(sched, st["steps"])
        del sched
        params, cfg = load_export(path, device="cuda")
        # Cast once to the compute dtype: the values every call's own cast
        # gives (the scheduler does the same), without the casts' launches.
        params = compute_params(params, cfg, torch.device("cuda"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        single = [
            decode.generate(params, cfg, tok, [r["prompt"]], max_new=r["max_new"],
                            temperature=r.get("temperature", 0.0), top_k=r.get("top_k", 0),
                            top_p=r.get("top_p", 1.0), seed=r.get("seed", 0))[0]
            for r in wreqs
        ]
        torch.cuda.synchronize()
        gen_wall = time.perf_counter() - t0
        del params
        out[dtype] = {
            "buffer_rows": buf, "wall_s": wall, "generate_wall_s": gen_wall,
            "steps": st["steps"], "prefill_tokens": st["prefill_tokens"],
            "generated_tokens": st["generated_tokens"], "launches": counts, **run,
            "errors": [a for a in answers if "error" in a],
            "differing_from_batch1_generate": [
                i for i, (a, g) in enumerate(zip(answers, single)) if a.get("continuation") != g],
        }
    refusals = {}
    params, cfg = load_export(export, device="cuda")
    loaded = (params, cfg, tok, torch.device("cuda"))
    for label, extra in (("kv_layout paged", ("--kv_layout", "paged")),
                         ("speculate_k", ("--speculate_k", str(SPEC_K))),
                         ("prefix_cache_mb", ("--prefix_cache_mb", "64"))):
        argv = serve_argv(export, vocab_path, layout=LAYOUT_FLAGS["dense"]) + list(extra)
        try:
            serve.build_scheduler(serve.build_parser().parse_args(argv), loaded)
            refusals[label] = None
        except ValueError as e:
            refusals[label] = str(e)
    expected = {
        "kv_layout paged": "kv_layout='paged' cannot serve a rolling-window cache",
        "speculate_k": "speculative decoding cannot roll back a rolling-window cache",
        "prefix_cache_mb": "prefix cache cannot serve a rolling-window cache",
    }
    rec = {"phase": "windowed", "step": "serve", "card": nvidia_smi_line(), "window": WINDOW,
           "prefill_chunk": WINDOW_CHUNK, "prompt_tokens": lengths, "requests": len(wreqs),
           "train_launches": train_launches, **out, "refusals": refusals}
    emit(rec)
    fp32 = out["float32"]
    if (fp32["errors"] or out["bfloat16"]["errors"] or fp32["differing_from_batch1_generate"]
            or fp32["buffer_rows"] != WINDOW or not fp32["every_step_through_the_graph"]
            or any(fp32["launches"].values())):
        raise SystemExit(f"windowed serving failed: {rec}")
    for label, prefix in expected.items():
        if not (refusals[label] or "").startswith(prefix):
            raise SystemExit(f"windowed: {label} not refused with the JAX message: {refusals}")
    return train_launches


# The drill's faults: the second admission fails (a retried transient);
# the third and fourth prefix matches fail (the prefix breaker opens at
# threshold 2); the first match that finds a host block finds it corrupt;
# the first two proposals fail (the speculative breaker opens: pass B
# sends the shortest prompts first, whose rows draft from the first step,
# so no slot still feeding a prompt tail records a success between them);
# the third proposal stalls.
BREAKER_SPEC = ("serve.prefill:at=2;prefix.match:at=3+4;prefix.corrupt:at=1;"
                "draft.propose:at=1+2;draft.slow:at=3,ms=5")
BREAKER_COOLDOWN = 10.0  # test-clock seconds; the drive loop adds 1 a step
BREAKER_CACHE_MB = 128  # the host tier's budget: in fp32, the blocks 64 MB hold in bf16


def breaker_path(export, vocab_path, tok, reqs, fp32_answers):
    """Phase 4's export served in fp32 (where a prefix hit never changes an
    answer, as phase 10's fp32 prefix gate holds) on ``--kv_layout paged --decode_kernel paged_flash
    --speculate_k 4 --prefix_cache_mb 128 --breaker_threshold 2`` over a
    pool of just the blocks four live slots need, with a test clock that
    the drive loop advances a second a step. Pass A (no faults) fills the
    prefix cache's device tier past the pool, which spills it to the host
    tier; passes B (shortest prompt first) and C (phase 4's order) replay
    phase 4's requests under ``BREAKER_SPEC`` (hits on spilled blocks
    restore from the host, one of them corrupt); then, the plane disarmed
    and both breakers closed, pass D sends them with ``cache_prefix``
    false and pass E with the cache, which serves E from what the fault
    passes left in it. Gates: every request answered once, in order, each
    failure with a JAX error code; each breaker went closed -> open ->
    half_open -> closed; a spill, a host-restored hit and the faults
    ``serve.prefill``, ``prefix.corrupt`` and ``draft.slow`` fired; pass
    D's greedy answers byte-identical to phase 4's requests served in fp32
    at k 4 (phase 10's fp32 n-gram run, ``fp32_answers["ngram"]``); pass E
    hits the cache and its greedy answers equal pass D's; free slots, the
    trie's pins and (with the device tier released) the pool's free blocks
    back at their start; kernels B and A launched layers x forwards (set
    to 0 before pass A, read after pass E). Reported: pass B and C's
    greedy answers that differ from the reference."""
    import torch

    from transformer_tpu_torch.cli import serve
    from transformer_tpu_torch.kernels.paged_flash import paged_flash_attention
    from transformer_tpu_torch.ops.ffn import fused_ln_ffn
    from transformer_tpu_torch.serve import resilience

    lengths = [len(tok.encode(r["prompt"])) + 1 for r in reqs]
    # The pool: the sink and the blocks the four largest requests need at
    # once (prompt, max_new and a verify row's slack), nothing for the
    # device tier, which must spill.
    need = sorted(-(-(L + r["max_new"] + SPEC_K + 1) // 16) for L, r in zip(lengths, reqs))
    pool = 1 + sum(need[-4:])
    clock = [0.0]
    argv = serve_argv(fp32_export(export), vocab_path, "--speculate_k", str(SPEC_K),
                      "--prefix_cache_mb", str(BREAKER_CACHE_MB),
                      "--kv_pool_blocks", str(pool), "--breaker_threshold", "2",
                      "--breaker_cooldown", str(BREAKER_COOLDOWN))
    sched = serve.build_scheduler(serve.build_parser().parse_args(argv),
                                  breaker_clock=lambda: clock[0])
    cache = sched.prefix_cache
    free0, slots0 = sched.alloc.free_blocks, sorted(sched._free)
    passes = {}

    def run(label, index, **extra):
        before = dict(sched.stats)
        orders = [sched.submit(dict(reqs[i], **extra)) for i in index]
        answers = []
        t0 = time.perf_counter()
        while sched.busy:
            sched.admit()
            sched.step()
            clock[0] += 1.0
            answers.extend(sched.drain_ready())
        answers.extend(sched.drain_ready())
        torch.cuda.synchronize()
        passes[label] = {
            "index": index, "orders": orders, "answers": answers,
            "wall_s": time.perf_counter() - t0,
            "stats": {k: sched.stats[k] - before[k] for k in sched.stats},
            "breakers": {name: b.state for name, b in sched.breakers.items()},
        }

    paged_flash_attention.launches = 0
    fused_ln_ffn.launches = 0
    in_order = list(range(len(reqs)))
    run("A", in_order)
    plane = resilience.FaultPlane.parse(BREAKER_SPEC)
    with resilience.active(plane):
        run("B", sorted(in_order, key=lambda i: lengths[i]))
        run("C", in_order)
    run("D", in_order, cache_prefix=False)
    run("E", in_order)
    launches = {"paged_attention": paged_flash_attention.launches,
                "fused_ln_ffn": fused_ln_ffn.launches}
    want_launches = sched.cfg.num_layers * sched.stats["steps"]
    greedy = [i for i, r in enumerate(reqs) if "temperature" not in r]
    reference = fp32_answers["ngram"]
    ladder = {}
    for name in sched.breakers:
        moves = [(old, new) for n, old, new in sched.breaker_log if n == name]
        steps = [("closed", "open"), ("open", "half_open"), ("half_open", "closed")]
        it = iter(moves)
        ladder[name] = {"transitions": moves, "full_ladder": all(m in it for m in steps)}
    sched.alloc.check_consistency()
    pins = cache.outstanding_refs()
    tier_holds_the_rest = sched.alloc.used_blocks == cache.stats["device_blocks"]
    cache.release_device_blocks(1 << 30, spill=False)
    in_order = all(
        p["orders"] == list(range(p["orders"][0], p["orders"][0] + len(reqs)))
        and len(p["answers"]) == len(reqs) for p in passes.values())
    codes_ok = all(("continuation" in a) or (a.get("code") in resilience.ERROR_CODES)
                   for p in passes.values() for a in p["answers"])
    fired = sorted({point for point, _ in plane.fired_log})
    spilled = sum(p["stats"]["kv_spilled_blocks"] for p in passes.values())
    host_restored = sum(passes[x]["stats"]["host_restored_tokens"] for x in ("B", "C"))
    rec = {
        "phase": "breakers", "step": "drill", "card": nvidia_smi_line(), "argv": argv,
        "fault_spec": BREAKER_SPEC, "pool_blocks": pool, "fired": plane.fired_log,
        "passes": {label: {
            "wall_s": p["wall_s"], "breakers_after": p["breakers"],
            "codes": [a.get("code", "ok") for a in p["answers"]],
            "greedy_differing_from_reference": [
                i for j, i in enumerate(p["index"])
                if i in greedy and p["answers"][j] != reference[i]],
            "stats": {k: p["stats"][k] for k in (
                "admitted", "steps", "retries", "prefix_hit_tokens", "prefix_alias_tokens",
                "host_restored_tokens", "kv_spilled_blocks", "kv_preempted", "drafted",
                "accepted", "spec_breaker_open_steps", "prefix_breaker_open_admissions")},
        } for label, p in passes.items()},
        "reference": "phase 4's requests in fp32 at k 4 (phase 10's fp32 n-gram run)",
        "greedy_E_differing_from_D": [
            i for i in greedy if passes["E"]["answers"][i] != passes["D"]["answers"][i]],
        "breaker_ladder": ladder,
        "breaker_stats": {name: dict(b.stats) for name, b in sched.breakers.items()},
        "corrupt_blocks": cache.stats["corrupt_blocks"],
        "answered_once_in_order": in_order, "codes_ok": codes_ok,
        "free_slots": {"start": slots0, "end": sorted(sched._free)},
        "free_blocks": {"start": free0, "end_tier_released": sched.alloc.free_blocks},
        "outstanding_refs": pins, "tier_holds_every_used_block": tier_holds_the_rest,
        "launches": launches, "expected_launches": want_launches,
    }
    emit(rec)
    ok = (
        in_order and codes_ok and all(r["full_ladder"] for r in ladder.values())
        and all(state == "closed" for state in passes["C"]["breakers"].values())
        and {"serve.prefill", "prefix.corrupt", "draft.slow"} <= set(fired)
        and spilled > 0 and host_restored > 0
        and not rec["passes"]["D"]["greedy_differing_from_reference"]
        and not rec["greedy_E_differing_from_D"]
        and passes["E"]["stats"]["prefix_hit_tokens"] > 0
        and sorted(sched._free) == slots0 and pins == 0 and tier_holds_the_rest
        and sched.alloc.free_blocks == free0
    )
    if not ok:
        raise SystemExit(f"breakers: the drill failed: {rec}")
    for name, count in launches.items():
        if count <= 0 or count != want_launches:
            raise SystemExit(f"{name} launched {count} times, expected {want_launches}")
    return launches


# --------------------------------------------------------------------------
# phase 14: the serving fleet (cli.router over replica worker processes)

# cli.router's flags on the fleet: 2 workers of 4 slots, the main path's
# 16-token blocks and 64-token prefill chunks, a 256 MB prefix cache;
# affinity hashed over 512-token blocks (phase 10's shared prefix, so its
# requests share one key whatever their tails) with a slack that keeps 16
# queued requests on their affine worker.
FLEET_FLAGS = ("--replicas", "2", "--serve_slots", "4", "--prefix_block", "16",
               "--prefill_chunk", "64", "--prefix_cache_mb", "256", "--affinity_block", "512",
               "--affinity_slack", "16", "--device", "cuda")
# The upgrade's canary: a 2 s window judged on availability (and on a TTFT
# bound loose enough that queueing on a shared card never reads as burn).
CANARY_FLAGS = ("--canary_window", "2",
                "--canary_slo", "availability:windows=5+30;ttft_p95:threshold=30,windows=5+30")


class FleetEvents:
    """The router's event sink: each event with its host-clock time."""

    def __init__(self):
        self.events = []

    def emit(self, kind, **fields):
        self.events.append({"kind": kind, "t": time.perf_counter(), **fields})

    def of(self, kind, **match):
        return [e for e in self.events if e["kind"] == kind
                and all(e.get(k) == v for k, v in match.items())]


def fleet(export, vocab_path, *extra):
    """``cli.router``'s fleet for ``export``: its flags parsed, its workers
    spawned (they start in parallel), its Router returned with an event
    sink."""
    from transformer_tpu_torch.cli import router as cli

    args = cli.build_parser().parse_args(
        ["--export_path", export, "--tgt_vocab_file", vocab_path, *FLEET_FLAGS, *extra])
    events = FleetEvents()
    router = cli.build_router(args, telemetry=events)
    return router, events, args


def route(router, reqs):
    """``reqs`` through ``cli.router``'s line loop (``route_lines``); the
    answers in order."""
    import queue

    from transformer_tpu_torch.cli.router import route_lines

    q: queue.Queue = queue.Queue()
    for r in reqs:
        q.put(r if isinstance(r, str) else json.dumps(r))
    q.put(None)
    out = io.StringIO()
    route_lines(q, router, out)
    return [json.loads(line) for line in out.getvalue().splitlines()]


def pump_until(router, cond, seconds, what, also=()):
    """Pump ``router`` (and, without waiting, the routers ``also``) until
    ``cond()``; returns the answers drained meanwhile."""
    deadline = time.perf_counter() + seconds
    answers = []
    while not cond():
        if time.perf_counter() > deadline:
            raise SystemExit(f"fleet: {what} did not happen within {seconds} s")
        router.pump()
        for other in also:
            other.pump(timeout=0)
        answers.extend(router.drain_ready())
    return answers


def serve_beside(router, reqs, also, seconds=120):
    """``reqs`` through ``router``'s ``submit`` / ``pump``, the routers
    ``also`` pumped beside it; the answers in order."""
    for r in reqs:
        router.submit(dict(r))
    return pump_until(router, lambda: not router.busy, seconds, "serving", also)


def serve_waves(router, reqs, until, seconds, what):
    """Submit ``reqs`` again and again (a wave once the last is answered)
    until ``until()``, pumping; returns [(order, answer)] of every wave."""
    deadline = time.perf_counter() + seconds
    got, orders = [], [router.submit(dict(r)) for r in reqs]
    while not (until() and not router.busy):
        if time.perf_counter() > deadline:
            up = router._upgrader
            raise SystemExit(f"fleet: {what} did not happen within {seconds} s: rollout "
                             f"{up.state} {up.stats}, router {router.stats}, "
                             f"{len(got)} answers: {got[-3:]}")
        if not router.busy:
            orders += [router.submit(dict(r)) for r in reqs]
        router.pump()
        got.extend(router.drain_ready())
    got.extend(router.drain_ready())
    return list(zip(orders, got))


def by_replica(events, orders):
    """The replica each order was last dispatched to."""
    last = {e["order"]: e["replica"] for e in events.of("route.dispatch")}
    return {o: last.get(o) for o in orders}


def single_scheduler(export_or_params, tok, reqs, cfg=None, cache_mb=0):
    """A single fp32 dense scheduler with the fleet's flags: the reference."""
    from transformer_tpu_torch.convert import load_export
    from transformer_tpu_torch.serve.prefix_cache import PrefixCache
    from transformer_tpu_torch.serve.scheduler import ContinuousScheduler

    if cfg is None:
        params, cfg = load_export(export_or_params, device="cuda")
    else:
        params = export_or_params
    cache = PrefixCache(cfg, block_tokens=16, budget_mb=cache_mb) if cache_mb else None
    sched = ContinuousScheduler(params, cfg, tok, num_slots=4, prefill_chunk=64, kv_block=16,
                                prefix_cache=cache, device="cuda")
    return sched.run([dict(r) for r in reqs])


def fleet_path(export, vocab_path, tok, reqs, dense32):
    """Phase 14, the serving fleet: ``cli.router``'s Router over two
    ``serve/replica.py`` worker processes sharing the card, on the dense
    layout, serving phase 4's export (fp32 unless said otherwise).

    Fleet A carries steps 1-3, fleet B (``--disaggregate``) step 4, and a
    bf16 fleet the reported bf16 traffic; the three spawn together, and
    fleets B and C serve while fleet A's supervisor respawns its victim
    (fleet A pumped beside them).
    1. phase 4's 14 requests, then phase 10's 16 shared-prefix requests:
       greedy answers byte-identical to phase 13's fp32 dense answers
       (``dense32``) and, for the shared-prefix ones, to a single fp32
       dense scheduler's; every shared-prefix request on one worker; the
       bf16 fleet's answers reported.
    2. phase 4's requests again, one worker SIGKILLed after its first
       answer: each answered once, as in step 1; the supervisor's respawn
       ready and admitted with warmed prefix tokens; its time to recover.
    3. the fault drills and the live upgrade to long4k's widths from seed
       1 (a params-only checkpoint through the port's CheckpointManager):
       a copy with one byte flipped in ``arrays.npz`` refused before any
       worker is touched; ``route.canary`` burning the first rollout's
       canary, rolled back, its answers old again; then the rollout at
       ``--canary_window 2`` reaching ``done`` under traffic (phase 4's
       requests with ``cache_prefix`` false): old-tagged answers equal
       ``dense32``, new-tagged ones a single fp32 scheduler's on the new
       weights; every worker's graph captures unchanged by the flips and
       no serving tensor moved; the flip's milliseconds.
    4. fleet B (one prefill and one decode worker, ``--fault_spec
       ckpt.swap:at=1``): phase 10's requests byte-identical to step 1's,
       the decode worker prefilling under a block + 1 tokens a request,
       the handoff's bytes and seconds; then an upgrade whose flip
       ``ckpt.swap`` aborts (``upgraded ok=false``, the rollout failed,
       the old weights serving)."""
    import signal

    import torch

    from transformer_tpu_torch.models.transformer import init_params
    from transformer_tpu_torch.serve import resilience
    from transformer_tpu_torch.serve.upgrade import verify_checkpoint
    from transformer_tpu_torch.train.checkpoint import CheckpointManager

    t_phase = time.perf_counter()
    export32 = fp32_export(export, name="fleet_export_fp32")
    preqs = prefix_requests(tok)
    greedy = [i for i, r in enumerate(reqs) if "temperature" not in r]
    t0 = time.perf_counter()
    fleet_a, ev_a, _ = fleet(export32, vocab_path, *CANARY_FLAGS)
    fleet_b, ev_b, _ = fleet(export32, vocab_path, "--disaggregate", "--fault_spec",
                             "ckpt.swap:at=1")
    fleet_c, ev_c, _ = fleet(export, vocab_path)
    # The references while the workers start: a single fp32 dense
    # scheduler on phase 10's traffic, and the upgrade target.
    pref_want = single_scheduler(export32, tok, preqs, cache_mb=256)
    bf16_want = single_scheduler(export, tok, reqs + preqs, cache_mb=256)
    from transformer_tpu_torch.convert import load_export_config

    cfg32 = load_export_config(export32)
    new_params = init_params(cfg32, torch.Generator().manual_seed(1), device="cuda")
    ckpt = CheckpointManager(fresh_dir("fleet_ckpt"), is_primary=True).save(new_params, step=1)
    new_version = verify_checkpoint(ckpt)[1]
    nocache = [{**r, "cache_prefix": False} for r in reqs]
    new_want = single_scheduler(new_params, tok, nocache, cfg=cfg32)
    del new_params
    corrupt = fresh_dir("fleet_ckpt_corrupt")
    shutil.copytree(ckpt, corrupt)
    flipped_at = flip_byte(os.path.join(corrupt, "arrays.npz"))
    ref_s = time.perf_counter() - t0
    sup_a = fleet_a._sup
    up_a = fleet_a._upgrader
    try:
        # ---- 1. serve -------------------------------------------------------
        t0 = time.perf_counter()
        ans1 = route(fleet_a, reqs)
        t_reqs = time.perf_counter() - t0
        order0 = len(reqs)
        t0 = time.perf_counter()
        pans1 = route(fleet_a, preqs)
        t_preqs = time.perf_counter() - t0
        pref_replicas = set(by_replica(ev_a, range(order0, order0 + len(preqs))).values())
        # ---- 2. failover ----------------------------------------------------
        base = fleet_a.stats["answered"]
        answered_before = [l.answered for l in fleet_a.links]
        # The respawn's stages on the host clock: the kill, the failover,
        # the supervisor's spawn call, the replacement's admission.
        spawn_calls, spawn0 = [], sup_a._spawn
        sup_a._spawn = lambda *a: (spawn_calls.append(time.perf_counter()), spawn0(*a))[1]
        # The warm-up's stages (the replacement's ready, the survivor's
        # prefix_state, the replacement's state_injected) and the oldest
        # heartbeat of a serving link that the liveness sweep saw meanwhile,
        # against the router's heartbeat timeout and the warm-up's.
        warm = {"t": {}, "payload_bytes": None, "hb_age_max_s": 0.0}

        def stamp(name, fn):
            def stamped(link, *msg):
                warm["t"].setdefault(name, time.perf_counter())
                if msg and "line" in msg[0]:
                    warm["payload_bytes"] = len(msg[0]["line"])
                return fn(link, *msg)
            return stamped

        sup_a.on_ready = stamp("ready", sup_a.on_ready)
        sup_a.on_prefix_state = stamp("prefix_state", sup_a.on_prefix_state)
        sup_a.on_state_injected = stamp("state_injected", sup_a.on_state_injected)
        sweep0 = fleet_a._sweep_liveness

        def sweep():
            if "ready" in warm["t"] and any(l.warming for l in fleet_a.links):
                now = time.monotonic()
                warm["hb_age_max_s"] = max([warm["hb_age_max_s"], *(
                    now - l.last_hb for l in fleet_a.links
                    if not (l.dead or l.warming or l.last_hb is None))])
            sweep0()

        fleet_a._sweep_liveness = sweep
        t_kill = None
        for r in reqs:
            fleet_a.submit(dict(r))
        got2, victim = [], None
        deadline = time.perf_counter() + 60
        while fleet_a.busy:
            if time.perf_counter() > deadline:
                raise SystemExit(f"fleet: the failover traffic was not answered: {fleet_a.stats}")
            fleet_a.pump()
            got2.extend(fleet_a.drain_ready())
            if victim is None:
                for link, before in zip(fleet_a.links, answered_before):
                    if link.answered > before and link.inflight > 0:
                        victim, t_kill = link, time.perf_counter()
                        os.kill(link.pid(), signal.SIGKILL)
                        break
        got2.extend(fleet_a.drain_ready())
        # While fleet A's supervisor brings the victim back, the bf16 fleet
        # serves and fleet B runs step 4; fleet A is pumped beside them.
        t0 = time.perf_counter()
        bf16 = serve_beside(fleet_c, reqs + preqs, (fleet_a,))
        t_bf16 = time.perf_counter() - t0
        with resilience.active(resilience.FaultPlane.parse("ckpt.swap:at=1")):
            t0 = time.perf_counter()
            pans5 = serve_beside(fleet_b, preqs, (fleet_a,))
            t_dis = time.perf_counter() - t0
            handoffs_done = fleet_b.stats["prefill_handoffs"]
            handoffs = []
            for order in range(len(preqs)):
                stamps = [e["t"] for e in ev_b.of("route.dispatch", order=order)]
                if len(stamps) == 2:
                    handoffs.append(stamps[1] - stamps[0])
            up_b = fleet_b._upgrader
            swap_start = fleet_b.start_upgrade(ckpt)
            pump_until(fleet_b, lambda: up_b.state in ("failed", "rolled_back", "done"), 60,
                       "the ckpt.swap abort", (fleet_a,))
            after_abort = serve_beside(fleet_b, preqs[:4], (fleet_a,))
        pump_until(fleet_a, lambda: sup_a.stats["respawns"] >= 1
                   and len(fleet_a.healthy_links) == 2, 120, "the respawn")
        t_failover = ev_a.of("route.failover")[-1]["t"] if victim else None
        t_admitted = ev_a.of("route.spawn")[-1]["t"] if victim else None
        serve = {
            "requests": len(reqs) + len(preqs), "wall_s": {"phase4": t_reqs, "prefix": t_preqs},
            "errors": [a for a in ans1 + pans1 if "error" in a],
            "greedy_differing_from_phase13_fp32_dense": [
                i for i in greedy if ans1[i] != dense32[i]],
            "sampled_differing_from_phase13_fp32_dense": [
                i for i in range(len(reqs)) if i not in greedy and ans1[i] != dense32[i]],
            "prefix_differing_from_single_scheduler": [
                i for i, (a, b) in enumerate(zip(pans1, pref_want)) if a != b],
            "prefix_replicas": sorted(pref_replicas),
            "bf16": {"wall_s": t_bf16, "errors": [a for a in bf16 if "error" in a],
                     "greedy_differing_from_single_bf16_scheduler": [
                         i for i, (a, b) in enumerate(zip(bf16, bf16_want))
                         if a != b and (i >= len(reqs) or i in greedy)],
                     "greedy_differing_from_fp32_fleet": [
                         i for i, (a, b) in enumerate(zip(bf16, ans1 + pans1))
                         if a != b and (i >= len(reqs) or i in greedy)]},
        }
        fleet_c.shutdown()
        failover = {
            "victim": victim.name if victim else None,
            "failed_over_orders": [e["orders"] for e in ev_a.of("route.failover")],
            "answers": len(got2), "answered_by_router": fleet_a.stats["answered"] - base,
            "duplicates": fleet_a.stats["duplicate_answers"],
            "redispatched": fleet_a.stats["redispatched"],
            "greedy_differing_from_step1": [i for i in greedy if got2[i] != ans1[i]],
            "sampled_differing_from_step1": [
                i for i in range(len(reqs)) if i not in greedy and got2[i] != ans1[i]],
            "errors": [a for a in got2 if "error" in a],
            "supervisor": dict(sup_a.stats), "time_to_recover_s": list(sup_a.heal_times),
            "recovery_stages_s": None if not (victim and spawn_calls) else {
                "kill_to_failover": t_failover - t_kill,
                "failover_to_spawn": spawn_calls[0] - t_failover,
                "spawn_to_admitted": t_admitted - spawn_calls[0],
                "kill_to_admitted": t_admitted - t_kill},
            "warm_up": {
                **{f"spawn_to_{k}_s": t - spawn_calls[0] for k, t in warm["t"].items()
                   if spawn_calls},
                "payload_bytes": warm["payload_bytes"],
                "serving_hb_age_max_s": warm["hb_age_max_s"],
                "heartbeat_timeout_s": fleet_a.heartbeat_timeout_s,
                "warm_timeout_s": sup_a.warm_timeout_s},
            "spawn_events": [{k: v for k, v in e.items() if k != "t"}
                             for e in ev_a.of("route.spawn")],
        }
        # ---- 3. the refusals and the live upgrade -----------------------------
        versions0 = [l.wv for l in fleet_a.links]
        refused = fleet_a.start_upgrade(corrupt)
        refusal = {"status": refused, "flipped_byte_at": flipped_at,
                   "versions_unchanged": [l.wv for l in fleet_a.links] == versions0,
                   "coordinator_state": up_a.state}
        with resilience.active(resilience.FaultPlane.parse("route.canary:at=1")):
            t0 = time.perf_counter()
            started = fleet_a.start_upgrade(ckpt)
            pump_until(fleet_a, lambda: up_a.state == "canary", 60, "the burn rollout's canary")
            canary = fleet_a.links[up_a._canary]
            waves_burn = serve_waves(
                fleet_a, nocache, lambda: up_a.state in ("rolled_back", "failed"), 60,
                "the canary's burn rollback")
            after_burn = serve_waves(fleet_a, nocache, lambda: True, 60, "the wave after it")
            t_burn = time.perf_counter() - t0
        who = by_replica(ev_a, [o for o, _ in after_burn])
        burn = {
            "started": started, "final_state": up_a.state, "stats": dict(up_a.stats),
            "canary": canary.name, "wall_s": t_burn,
            "new_tagged_during": sum(1 for _, a in waves_burn if "weight_version" in a),
            "after": {"answers": len(after_burn),
                      "tagged": [a.get("weight_version") for _, a in after_burn if
                                 "weight_version" in a],
                      "by_canary": sum(1 for o, _ in after_burn if who[o] == canary.name),
                      "greedy_differing_from_dense32": [
                          i for i, (_, a) in enumerate(after_burn)
                          if i % len(reqs) in greedy and a != dense32[i % len(reqs)]]},
            "during_greedy_differing": [
                i for i, (_, a) in enumerate(waves_burn) if i % len(reqs) in greedy and a != (
                    {**new_want[i % len(reqs)], "weight_version": new_version}
                    if "weight_version" in a else dense32[i % len(reqs)])],
        }
        t0 = time.perf_counter()
        started = fleet_a.start_upgrade(ckpt)
        waves = serve_waves(fleet_a, nocache, lambda: up_a.state in ("done", "failed",
                                                                     "rolled_back"), 90,
                            "the rollout")
        t_upgrade = time.perf_counter() - t0
        new_tagged = [(i, a) for i, (_, a) in enumerate(waves) if "weight_version" in a]
        old_tagged = [(i, a) for i, (_, a) in enumerate(waves) if "weight_version" not in a]
        upgrade = {
            "started": started, "final_state": up_a.state, "stats": dict(up_a.stats),
            "wall_s": t_upgrade, "answers": len(waves),
            "new_tagged": len(new_tagged), "old_tagged": len(old_tagged),
            "new_greedy_differing": [
                i for i, a in new_tagged if i % len(reqs) in greedy
                and a != {**new_want[i % len(reqs)], "weight_version": new_version}],
            "old_greedy_differing": [
                i for i, a in old_tagged if i % len(reqs) in greedy
                and a != dense32[i % len(reqs)]],
            "errors": [a for _, a in waves if "error" in a],
            "versions": [l.wv for l in fleet_a.links], "target_version": new_version,
            "events": [{k: v for k, v in e.items() if k not in ("t", "evidence", "replicas")}
                       for e in ev_a.events if e["kind"] in ("route.upgrade", "route.canary")],
        }
        # ---- 4. (run during step 2's respawn) ---------------------------------
        cfg = cfg32
        kv_token_bytes = cfg.num_layers * 2 * cfg.kv_heads * cfg.head_dim * 4
        handoff_tokens = [
            (len(tok.encode(r["prompt"])) + 1) // 16 * 16 for r in preqs]
        disagg = {
            "wall_s": t_dis, "answers": len(pans5),
            "differing_from_step1": [i for i, (a, b) in enumerate(zip(pans5, pans1)) if a != b],
            "errors": [a for a in pans5 if "error" in a],
            "prefill_handoffs": handoffs_done,
            "redispatched": fleet_b.stats["redispatched"],
            "handoff_s": {"median": sorted(handoffs)[len(handoffs) // 2] if handoffs else None,
                          "max": max(handoffs, default=None), "count": len(handoffs),
                          "timer": "host clock from the prefill dispatch to the decode "
                                   "dispatch (prefill, export, JSON, both pipes)"},
            "handoff_kv_bytes_per_request": [t * kv_token_bytes for t in handoff_tokens],
            "handoff_kv_bytes_note": "block-aligned prompt tokens x layers x K,V x heads x "
                                     "head_dim x 4 B (fp32); base64 on the wire adds 1/3",
            "swap_abort": {
                "start": swap_start, "final_state": up_b.state, "stats": dict(up_b.stats),
                "failed_events": [e.get("error") for e in ev_b.of("route.upgrade",
                                                                  phase="failed")],
                "versions": [l.wv for l in fleet_b.links],
                "after_differing": [i for i, a in enumerate(after_abort) if a != pans1[i]],
            },
        }
    finally:
        for r in (fleet_a, fleet_b, fleet_c):
            r.shutdown()
    finals = {f"A/{l.name}": l.final_stats for l in fleet_a.links}
    finals.update({f"B/{l.name}": l.final_stats for l in fleet_b.links})
    finals.update({f"C/{l.name}": l.final_stats for l in fleet_c.links})
    workers = {
        name: None if st is None else {
            k: st.get(k) for k in ("admitted", "steps", "prefill_tokens", "prefix_hit_tokens",
                                   "swaps", "swap_s", "graph_captures", "warm_captures",
                                   "params_moved", "generated_tokens", "decode_s")}
        for name, st in finals.items()
    }
    swaps = [st for st in workers.values() if st and st["swaps"]]
    flip_ms = [st["swap_s"] / st["swaps"] * 1e3 for st in swaps]
    decode_b = finals.get("B/replica1") or {}
    disagg["decode_worker_prefill_tokens"] = decode_b.get("prefill_tokens")
    disagg["decode_worker_admitted"] = decode_b.get("admitted")
    rec = {
        "phase": "fleet", "step": "serve", "card": nvidia_smi_line(), "flags": FLEET_FLAGS,
        "references_s": ref_s, "serve": serve, "failover": failover, "refusal": refusal,
        "canary_burn": burn, "upgrade": upgrade, "disaggregation": disagg, "workers": workers,
        "flip_ms": flip_ms, "seconds": time.perf_counter() - t_phase,
        "timers": "host clock (perf_counter) in this process; flip_ms: the worker's host clock "
                  "around the in-place copies, ending in a synchronize",
    }
    emit(rec)
    failed = []
    if serve["errors"] or len(ans1) != len(reqs) or len(pans1) != len(preqs):
        failed.append("step 1 errors")
    if serve["greedy_differing_from_phase13_fp32_dense"]:
        failed.append("step 1 greedy answers differ from phase 13's fp32 dense")
    if serve["prefix_differing_from_single_scheduler"]:
        failed.append("step 1 shared-prefix answers differ from a single scheduler's")
    if len(pref_replicas) != 1:
        failed.append("the shared-prefix requests rode more than one worker")
    if (victim is None or failover["errors"] or len(got2) != len(reqs)
            or failover["answered_by_router"] != len(reqs)
            or failover["greedy_differing_from_step1"]
            or sup_a.stats["respawns"] != 1 or sup_a.stats["warmed_tokens"] <= 0):
        failed.append("step 2 failover")
    if (refused.get("ok") is not False or not refusal["versions_unchanged"]
            or up_a.stats["rejected"] != 1):
        failed.append("the corrupt checkpoint was not refused before the workers")
    if (burn["final_state"] != "rolled_back" or burn["after"]["tagged"]
            or burn["after"]["greedy_differing_from_dense32"] or burn["during_greedy_differing"]
            or not burn["after"]["by_canary"] or not burn["new_tagged_during"]):
        failed.append("the route.canary burn rollback")
    if (upgrade["final_state"] != "done" or upgrade["errors"] or not upgrade["new_tagged"]
            or upgrade["new_greedy_differing"] or upgrade["old_greedy_differing"]
            or upgrade["versions"] != [new_version] * 2):
        failed.append("the live upgrade")
    if (disagg["errors"] or disagg["differing_from_step1"]
            or disagg["prefill_handoffs"] != len(preqs)
            or not disagg["decode_worker_admitted"]
            or disagg["decode_worker_prefill_tokens"] >= disagg["decode_worker_admitted"] * 17):
        failed.append("disaggregation")
    sa = disagg["swap_abort"]
    if (sa["final_state"] != "failed" or not sa["failed_events"]
            or "ckpt.swap" not in (sa["failed_events"][0] or "")
            or any(v is not None for v in sa["versions"]) or sa["after_differing"]):
        failed.append("the ckpt.swap abort")
    for name, st in workers.items():
        if st is None:
            if name != f"A/{failover['victim']}":
                failed.append(f"{name} sent no final stats")
            continue
        if st["graph_captures"] != st["warm_captures"] or st["params_moved"]:
            failed.append(f"{name} captured after warm-up or moved a serving tensor")
    if not swaps:
        failed.append("no worker flipped")
    if failed:
        raise SystemExit(f"fleet: {failed}: {rec}")
    return rec


# --------------------------------------------------------------------------
# phase 15: the encoder-only masked LM (BERT's recipe on the base width)

MLM_LEN = 128  # BERT pre-trains at S 128 for most of its steps
MLM_K = 8  # --steps_per_dispatch of the base MLM run
# Noam's warmup, cut from the CLI's 60,000 so that the loss moves within
# an epoch of ~24 steps (the flag exists in both packages).
MLM_WARMUP = "100"
MLM_ADAFACTOR_LAYERS = 2  # the Adafactor run's depth, cut: a second, shorter run
MLM_REQUESTS = 16


def mlm_lengths(b=64, s=MLM_LEN, seed=SEED):
    """Key lengths of a batch of B LM windows of S: full windows, except a
    ragged tail of 8 rows (the split's last window and padding rows), one
    of them PAD only."""
    import numpy as np

    lengths = np.full(b, s)
    lengths[-8:] = np.random.default_rng(seed + 15).integers(2, s, size=8)
    lengths[-1] = 0
    return lengths


def mlm_fwd_cold(rec) -> dict:
    """The bf16 MLM forward timed cold, as kernel A is: COLD_COPIES copies
    of q, k, v and the key mask (16 x 25 MB, more than the 50 MB L2), the
    graph's calls cycling through them, so each call reads its inputs from
    HBM; SDPA with the same key mask alike, and both warm on the same timer
    (one copy). Adds the readings to ``rec``."""
    import torch
    import torch.nn.functional as F

    from transformer_tpu_torch.kernels.flash_attention import flash_fwd

    copies = [flash_inputs(64, MLM_LEN, MLM_LEN, 8, 8, 64, torch.bfloat16, False,
                           seed=SEED + 100 + i, lengths=mlm_lengths())
              for i in range(COLD_COPIES)]
    fwd = [lambda c=c: flash_fwd(c[0], c[1], c[2], kv_mask=c[4], causal=False, band=None)
           for c in copies]
    transposed = [(*(x.transpose(1, 2).contiguous() for x in c[:3]), c[4][:, None, None, :])
                  for c in copies]
    sdpa = [lambda t=t: F.scaled_dot_product_attention(t[0], t[1], t[2], attn_mask=t[3])
            for t in transposed]
    iters = 3 * COLD_COPIES
    bound = rec["bound_ms"]["flash_fwd"]
    cold = {
        "device_ms_cold": cuda_graph_ms(cycling(fwd), iters=iters),
        "library_device_ms_cold": cuda_graph_ms(cycling(sdpa), iters=iters),
        "device_ms_warm_graph": cuda_graph_ms(fwd[0], iters=iters),
        "library_device_ms_warm_graph": cuda_graph_ms(sdpa[0], iters=iters),
    }
    cold["share_of_bound_cold"] = bound / cold["device_ms_cold"]
    emit({"phase": "mlm", "step": "flash_fwd_cold", "card": nvidia_smi_line(),
          "bound_ms": bound, **cold,
          "timer": f"cuda_graph_ms, {iters} calls cycling through {COLD_COPIES} input copies "
                   "(cold) or on one copy (warm_graph, L2-resident)"})
    rec.update(cold)
    return cold


def mlm_flash_checks():
    """The three flash kernels at the MLM's shape (B 64 x S 128, 8 heads of
    64, bidirectional, a ragged key tail) in bf16 and fp32 against their
    plain versions, with phase 3's limits and planted faults, timed (bf16
    and fp32): kernel time, the plain version's, SDPA's with the same key
    mask (forward; its backward for dQ and dK/dV), each kernel's device
    time by ``kernel_us`` and the bound from this run's inputs."""
    recs = {}
    for dtype in ("bfloat16", "float32"):
        rec = check_flash(f"mlm B 64 S {MLM_LEN} bidirectional ragged tail {dtype}", dtype, 64,
                          MLM_LEN, MLM_LEN, 8, 8, 64, False, None, False, timed=True,
                          lengths=mlm_lengths(), device_timed=True)
        recs[dtype] = rec
        emit({
            "phase": "mlm", "step": "flash_kernels", "dtype": dtype, "card": nvidia_smi_line(),
            "max_abs_err": rec["max_abs_err"], "readings": rec["readings"],
            "tolerance": rec["tolerance"], "kernel_ms": rec["ms"],
            "kernel_device_ms": rec.get("device_ms"), "plain_ms": rec["plain_ms"],
            "sdpa_ms": rec["library_ms"], "sdpa_device_ms": rec.get("library_device_ms"),
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "share_of_bound": rec["share_of_bound"],
            "share_of_bound_device": rec.get("share_of_bound_device"),
        })
    mlm_fwd_cold(recs["bfloat16"])
    return recs


def mlm_argv(vocab_path, name, *extra):
    """``cli.train --preset base --objective mlm --attention_impl flash
    --sequence_length 128 --batch_size 64 --steps_per_dispatch 8`` on the
    bundled German side, checkpointing to a fresh ``build/ckpt/<name>``."""
    return [
        "--preset", "base", "--objective", "mlm", "--attention_impl", "flash",
        "--sequence_length", str(MLM_LEN), "--batch_size", "64", "--epochs", "1",
        "--steps_per_dispatch", str(MLM_K), "--warmup_steps", MLM_WARMUP,
        "--dataset_path", os.path.join(ROOT, "data"), "--tgt_vocab_file", vocab_path,
        "--ckpt_path", fresh_dir("ckpt", name),
        "--export_path", os.path.join(BUILD_DIR, f"{name}_export"), "--device", "cuda", *extra,
    ]


def mlm_fit(argv, label):
    """One ``cli.train --objective mlm`` run in this process, the flash
    counters set to 0 just before and read just after: a launch of each
    kernel a layer a step and a forward launch a layer an eval batch (no
    epilogue decode). The loss of its last dispatch must be below its
    first's. Returns (trainer, record, the run's train split)."""
    import statistics

    import numpy as np
    import torch

    from transformer_tpu_torch.cli import train
    from transformer_tpu_torch.models.transformer import flatten

    logs: list[str] = []
    torch.cuda.reset_peak_memory_stats()
    read_flash_counters(reset=True)
    t0 = time.perf_counter()
    trainer = train.main(argv, log_fn=logs.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_flash_counters()
    cfg, tcfg = trainer.model_cfg, trainer.train_cfg
    steps, evals, layers = len(trainer.step_seconds), trainer.eval_batches, cfg.num_layers
    want = {"flash_fwd": layers * (steps + evals), "flash_dq": layers * steps,
            "flash_dkdv": layers * steps}
    ms = [t * 1e3 for t in trainer.step_seconds]
    later = ms[MLM_K:] or ms  # past the first dispatch (its warm-up step and capture)
    median_s = statistics.median(later) / 1e3
    flags = train.resolve_flags(argv)
    train_ds, _, _, _ = train.load_for_model(flags, train.train_config(flags), lambda *_: None)
    # Rates of a steady step: the last epoch's mean positions, real tokens
    # and masked tokens a step over the median step.
    last = [np.asarray(t) for _, t in train_ds.batches(tcfg.epochs - 1)]
    real = sum(int((t != 0).sum()) for t in last) / len(last)
    masked = trainer.train_metrics.weight / len(last)
    opt = trainer.state.opt_state
    rec = {
        "phase": "mlm", "step": "fit", "run": label, "card": nvidia_smi_line(), "argv": argv,
        "config": dataclasses.asdict(cfg), "optimizer": tcfg.optimizer,
        "train_windows": train_ds.num_examples, "steps": steps, "eval_batches": evals,
        "dispatches": [k for k, _ in trainer.dispatches],
        "captures": 0 if trainer.graph is None else len(trainer.graph.captures),
        "step_ms_first": ms[0], "step_ms_median": median_s * 1e3,
        "step_ms_mean": statistics.mean(later),
        "positions_per_s": last[0].size / median_s, "tokens_per_s": real / median_s,
        "masked_tokens_per_s": masked / median_s, "masked_share": masked / real,
        "rates": "the last epoch's mean a step over the median step past the first dispatch",
        "dispatch_losses": trainer.losses, "train_loss": trainer.train_metrics.loss,
        "train_acc": trainer.train_metrics.accuracy, "eval_loss": trainer.eval_metrics.loss,
        "param_elements": sum(p.numel() for p in flatten(trainer.state.params).values()),
        "optimizer_state_elements": sum(t.numel() for t in opt.tensors()),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "fit_wall_s": wall, "launches": launches, "expected_launches": want,
        "logs": logs[-6:],
    }
    emit(rec)
    losses = trainer.losses
    if not all(math.isfinite(x) for x in losses + [rec["eval_loss"]]):
        raise SystemExit(f"mlm {label}: non-finite loss: {rec}")
    if len(losses) < 2 or not losses[-1] < losses[0]:
        raise SystemExit(f"mlm {label}: the loss did not fall: {losses}")
    if launches != want or launches["flash_fwd"] <= 0:
        raise SystemExit(f"mlm {label}: flash launches {launches}, expected {want}")
    return trainer, rec, train_ds


def mlm_replay_check(trainer, train_ds):
    """The first ``MLM_K`` steps of the base run twice from the seed's
    init, on the epoch's first batches: eagerly (``step.core``) and
    through a ``graph.CapturedStep`` (the first step eager, then a capture
    and 7 replays, the masks drawn from the generators registered with the
    graph). The per-step losses and the parameters after the K steps must
    be bit-identical, and the K steps' dispatch loss must equal the
    ``cli.train`` run's first one bit for bit."""
    import itertools

    import numpy as np
    import torch

    from transformer_tpu_torch.convert import params_digest
    from transformer_tpu_torch.train.graph import CapturedStep
    from transformer_tpu_torch.train.state import create_train_state
    from transformer_tpu_torch.train.trainer import _dispatch_metrics, make_train_step, stage

    cfg, tcfg = trainer.model_cfg, trainer.train_cfg
    tgts = np.stack([t for _, t in itertools.islice(train_ds.batches(0), MLM_K)])
    device = torch.device("cuda")

    def run(captured):
        state = create_train_state(cfg, tcfg, device=device)
        step = make_train_step(cfg, tcfg)
        fn = CapturedStep(step.core, tcfg.seed, device) if captured else step.core
        staged_tgt, scalars = stage([tgts], step.scalars(state, MLM_K), device)
        losses, sums = [], None
        for i in range(MLM_K):
            state, m = fn(state, None, staged_tgt[i], scalars[i])
            losses.append(m["loss"].clone())
            sums = ({k: v.clone() for k, v in m.items()} if sums is None
                    else {k: sums[k] + m[k] for k in sums})
        torch.cuda.synchronize()
        dispatch = float(_dispatch_metrics(sums, MLM_K, tcfg.loss_normalization,
                                           tcfg.batch_size)["loss"])
        captures = len(fn.captures) if captured else 0
        return torch.stack(losses).cpu(), params_digest(state.params), dispatch, captures

    eager, replayed = run(False), run(True)
    rec = {
        "phase": "mlm", "step": "replay_vs_eager", "steps": MLM_K,
        "eager_losses": eager[0].tolist(), "replayed_losses": replayed[0].tolist(),
        "losses_bit_identical": bool(torch.equal(eager[0], replayed[0])),
        "params_bit_identical": eager[1] == replayed[1], "captures": replayed[3],
        "dispatch_loss": replayed[2], "cli_first_dispatch_loss": trainer.losses[0],
        "cli_first_dispatch_equal": replayed[2] == trainer.losses[0],
        "masks_differ_by_step": len(set(eager[0].tolist())) == MLM_K,
    }
    emit(rec)
    if not (rec["losses_bit_identical"] and rec["params_bit_identical"]
            and rec["cli_first_dispatch_equal"] and replayed[3] == 1):
        raise SystemExit(f"mlm: the replayed steps are not the eager ones: {rec}")


def mlm_adafactor_path(vocab_path):
    """``--optimizer adafactor`` on the same path, its depth cut to
    ``MLM_ADAFACTOR_LAYERS`` layers, two epochs: the loss must fall, the
    optimizer state must hold under half the parameter count (factored
    second moments; JAX's ``test_state_is_factored``), and the run's last
    checkpoint must restore bit for bit into a fresh state. Returns the
    run's flash launches."""
    import numpy as np

    from transformer_tpu_torch.train.checkpoint import CheckpointManager, snapshot
    from transformer_tpu_torch.train.state import create_train_state

    argv = mlm_argv(vocab_path, "mlm_adafactor", "--optimizer", "adafactor", "--num_layers",
                    str(MLM_ADAFACTOR_LAYERS), "--epochs", "2")
    trainer, rec, _ = mlm_fit(argv, "adafactor")
    t0 = time.perf_counter()
    template = create_train_state(trainer.model_cfg, trainer.train_cfg, device="cuda")
    restored = CheckpointManager(argv[argv.index("--ckpt_path") + 1]).restore_latest(template)
    got, want = snapshot(restored), snapshot(trainer.state)
    same = sorted(got) == sorted(want) and all(
        np.asarray(got[k]).tobytes() == np.asarray(want[k]).tobytes() for k in want)
    out = {
        "phase": "mlm", "step": "adafactor_state", "param_elements": rec["param_elements"],
        "optimizer_state_elements": rec["optimizer_state_elements"],
        "state_over_params": rec["optimizer_state_elements"] / rec["param_elements"],
        "checkpoint_round_trip_bit_identical": same, "restore_s": time.perf_counter() - t0,
        "restored_step": restored.step,
    }
    emit(out)
    if not same or not out["state_over_params"] < 0.5:
        raise SystemExit(f"mlm adafactor: {out}")
    return rec["launches"]


def mlm_requests(n=MLM_REQUESTS) -> list[str]:
    """``n`` fill lines: test-split German sentences of 6 to 20 words with
    one word (even lines) or two (odd lines) replaced by [MASK], ``top_k``
    5, and one malformed line last."""
    lines = []
    with open(os.path.join(ROOT, "data", "tgt-test.txt"), encoding="utf-8") as f:
        for text in f:
            words = text.split()
            if not 6 <= len(words) <= 20:  # well inside max_position 128
                continue
            i = len(lines)
            words[len(words) // 2] = "[MASK]"
            if i % 2:
                words[1] = "[MASK]"
            lines.append(json.dumps({"fill": " ".join(words), "top_k": 5}))
            if len(lines) == n:
                break
    return lines + ['{"fill": "der [MASK]']


def mlm_serve(export, vocab_path, lines):
    """``cli.serve`` on ``export`` (grouped: an encoder-only export) with
    every line queued, ``fill_mask`` wrapped to count its calls and the
    flash counters set to 0 just before and read just after. Returns
    (answers, record)."""
    import torch

    from transformer_tpu_torch.cli import serve
    from transformer_tpu_torch.train import decode

    calls = []
    real = decode.fill_mask

    def counted(params, cfg, tok, texts, **kw):
        calls.append(len(texts))
        return real(params, cfg, tok, texts, **kw)

    argv = ["--export_path", export, "--tgt_vocab_file", vocab_path, "--serve_batch",
            str(len(lines)), "--device", "cuda"]
    out = io.StringIO()
    decode.fill_mask = counted
    try:
        read_flash_counters(reset=True)
        batches = serve.main(argv, stdin=io.StringIO("".join(x + "\n" for x in lines)),
                             stdout=out)
        torch.cuda.synchronize()
        launches = read_flash_counters()
    finally:
        decode.fill_mask = real
    answers = out.getvalue().splitlines()
    served_s = sum(b["seconds"] for b in batches)
    return answers, {"answers": len(answers), "fill_mask_calls": calls, "launches": launches,
                     "serve_s": served_s, "requests_per_s": len(lines) / served_s}


def _without_probs(line: str):
    ans = json.loads(line)
    if "candidates" not in ans:
        return json.dumps(ans), []
    probs = [p for cands in ans["candidates"] for _, p in cands]
    bare = {**ans, "candidates": [[t for t, _ in cands] for cands in ans["candidates"]]}
    return json.dumps(bare), probs


def mlm_serve_path(export, vocab_path):
    """The trained base MLM's export behind ``cli.serve``: 16 fill lines
    and a malformed one, in bf16 and fp32, with the flash attention impl
    (the export's) and with xla. The flash runs must launch ``flash_fwd``
    a layer a ``fill_mask`` call, the xla runs none. Every fill line
    answers ``filled`` and one 5-candidate list a marker, the malformed
    line JAX's ``JSONDecodeError`` answer. fp32 (the gate): flash's and
    xla's lines with their probabilities taken out byte-identical, the
    probabilities within 1e-5 (the two attention impls sum in another
    order, so the last bits of a probability may differ); the lines that
    are byte-identical whole are counted. bf16: the argmax fills that
    differ between flash and xla are counted. Returns the flash launches
    of the bf16 flash run (the path's)."""
    from transformer_tpu_torch.convert import load_export_config

    lines = mlm_requests()
    layers = load_export_config(export).num_layers
    runs = {}
    for dtype in ("bfloat16", "float32"):
        for impl in ("flash", "xla"):
            path = export_variant(export, f"mlm_export_{dtype}_{impl}", dtype=dtype,
                                  attention_impl=impl)
            answers, rec = mlm_serve(path, vocab_path, lines)
            want = {"flash_fwd": layers * len(rec["fill_mask_calls"]) if impl == "flash" else 0,
                    "flash_dq": 0, "flash_dkdv": 0}
            parsed = [json.loads(a) for a in answers]
            well_formed = len(parsed) == len(lines) and all(
                "filled" in a and len(a["candidates"]) == json.loads(ln)["fill"].count("[MASK]")
                and all(len(c) == 5 for c in a["candidates"])
                for a, ln in zip(parsed[:-1], lines[:-1])
            ) and parsed[-1].get("error", "").startswith("JSONDecodeError")
            rec.update({"phase": "mlm", "step": "serve", "dtype": dtype, "impl": impl,
                        "card": nvidia_smi_line(), "expected_launches": want,
                        "well_formed": well_formed, "sample": parsed[:2]})
            emit(rec)
            if rec["launches"] != want or not well_formed:
                raise SystemExit(f"mlm serving {dtype} {impl}: {rec}")
            runs[dtype, impl] = (answers, rec)
    f32 = [_without_probs(a) for a in runs["float32", "flash"][0]]
    x32 = [_without_probs(a) for a in runs["float32", "xla"][0]]
    prob_err = max((abs(p - q) for (_, a), (_, b) in zip(f32, x32) for p, q in zip(a, b)),
                   default=0.0)
    bf = [json.loads(a).get("filled") for a in runs["bfloat16", "flash"][0]]
    bx = [json.loads(a).get("filled") for a in runs["bfloat16", "xla"][0]]
    rec = {
        "phase": "mlm", "step": "serve_flash_vs_xla", "requests": len(lines),
        "fp32_lines_equal_without_probs": all(a[0] == b[0] for a, b in zip(f32, x32)),
        "fp32_prob_max_abs_diff": prob_err,
        "fp32_lines_byte_identical": sum(a == b for a, b in zip(runs["float32", "flash"][0],
                                                                runs["float32", "xla"][0])),
        "bf16_argmax_fills_differ": sum(a != b for a, b in zip(bf, bx)),
    }
    emit(rec)
    if not (rec["fp32_lines_equal_without_probs"] and prob_err <= 1e-5):
        raise SystemExit(f"mlm serving: fp32 flash and xla answers differ: {rec}")
    return runs["bfloat16", "flash"][1]["launches"]


def mlm_path(vocab_path):
    """Phase 15: the flash kernels at the MLM's shape, the base MLM trained
    for an epoch (its replayed steps held to eager ones), a profiled
    window, Adafactor, and the export behind ``cli.serve``. Returns the
    flash launches by path."""
    import torch

    recs = mlm_flash_checks()
    argv = mlm_argv(vocab_path, "mlm")
    trainer, fit_rec, train_ds = mlm_fit(argv, "base")
    launches = {"mlm_train": fit_rec["launches"]}
    mlm_replay_check(trainer, train_ds)
    window_profile(trainer, batches_of_width(train_ds, MLM_LEN, 3 * MLM_K), MLM_K, "mlm base",
                   phase="mlm")
    export = argv[argv.index("--export_path") + 1]
    del trainer
    torch.cuda.empty_cache()
    launches["mlm_adafactor"] = mlm_adafactor_path(vocab_path)
    torch.cuda.empty_cache()
    launches["mlm_fill"] = mlm_serve_path(export, vocab_path)
    return launches, recs["bfloat16"]


# --------------------------------------------------------------------------
# phase 16: the trainer's command line (native data path, the paper's flags)

PAPER_LAYERS = 2  # depth of the paper's command-line run (step 3), cut
# The base run's noam warmup: the Transformer paper's 4,000 (at the CLI's
# 60,000 the learning rate stays under 5e-7 for the whole epoch, and the
# falling loss the phase gates on would be a few thousandths).
PAPER_WARMUP = "4000"
PAPER_BUFFER = 1000  # its --buffer_size
PAPER_TFDS_WORDS = 8000  # frequent tokens in the hand-built tfds vocabularies
ATTENTION_SENTENCES = 8


def native_build() -> dict:
    """Build the native library from the checkout's sources with g++ (any
    earlier build removed first) and load it."""
    from transformer_tpu_torch import native

    shutil.rmtree(native.library_path().parent, ignore_errors=True)
    t0 = time.perf_counter()
    path = native._build()
    seconds = time.perf_counter() - t0
    native._lib = None
    rec = {"phase": "paper", "step": "native_build", "seconds": seconds,
           "library": str(path), "loaded": native.get_lib() is not None,
           "cxx": os.environ.get("CXX", "g++")}
    emit(rec)
    if path is None or not rec["loaded"]:
        raise SystemExit("the native library did not build or load from the checkout")
    return rec


def native_vocabs(paths: dict) -> dict:
    """Both 2^15 vocabularies built by the native BPE trainer, each held to
    the Python-built one at ``paths[side]`` piece for piece."""
    from transformer_tpu_torch.data.tokenizer import SubwordTokenizer, iter_lines

    out = {}
    for side, path in paths.items():
        want = SubwordTokenizer.load(path)
        t0 = time.perf_counter()
        got = SubwordTokenizer.build_from_corpus(
            iter_lines(os.path.join(ROOT, "data", f"{side}-train.txt")), target_vocab_size=2**15)
        out[side] = {"native_seconds": time.perf_counter() - t0, "pieces": len(got.subwords),
                     "equal": got.subwords == want.subwords}
    emit({"phase": "paper", "step": "native_vocabs", **out,
          "python_seconds": "the vocab lines' seconds (built=true)"})
    for side, rec in out.items():
        if not rec["equal"]:
            raise SystemExit(f"the native BPE trainer's {side} vocabulary differs from the "
                             "Python trainer's")
    return out


def example_rows(batches):
    """The multiset of (src, tgt) rows of some batches, fill rows left out."""
    from collections import Counter

    rows = Counter()
    for src, tgt in batches:
        for s, t in zip(src, tgt):
            if s.any() or t.any():
                rows[(s.tobytes(), t.tobytes())] += 1
    return rows


def loader_checks(train_ds, steps: int) -> dict:
    """The native loader ran the fit (one epoch, ``steps`` batches), its
    epoch holds corpus examples once each, and a whole epoch (remainder
    kept) holds the numpy path's multiset of rows; then each loader's epoch
    iterated alone, timed (the host's wait for a batch)."""
    from transformer_tpu_torch.data.pipeline import Seq2SeqDataset

    loader = train_ds.native_loader() if train_ds.prefetch else None
    if loader is None:
        raise SystemExit("cli.train's defaults did not batch through the native loader")
    counts = {"epochs": loader.epochs, "batches": loader.batches}
    if counts != {"epochs": 1, "batches": steps} or steps != len(train_ds):
        raise SystemExit(f"the native loader ran {counts}, the fit {steps} steps of "
                         f"{len(train_ds)}")
    kw = dict(batch_size=train_ds.batch_size, src_len=train_ds.src_len,
              tgt_len=train_ds.tgt_len, seed=train_ds.seed, drop_remainder=False)
    whole_native = Seq2SeqDataset(train_ds.src, train_ds.tgt, prefetch=True, **kw)
    whole_python = Seq2SeqDataset(train_ds.src, train_ds.tgt, **kw)
    every = example_rows(whole_python.batches(0))
    trained = example_rows(train_ds.batches(0))
    same_multiset = example_rows(whole_native.batches(0)) == every
    within = all(n <= every[row] for row, n in trained.items())
    waits = {}
    for name, ds in (("native", whole_native), ("python", whole_python)):
        t0 = time.perf_counter()
        n = sum(1 for _ in ds.batches(1))
        waits[name] = (time.perf_counter() - t0) / n * 1e3
    rec = {"phase": "paper", "step": "loader", **counts,
           "trained_rows": sum(trained.values()), "corpus_rows": sum(every.values()),
           "trained_rows_are_corpus_examples": within,
           "whole_epoch_same_multiset_as_numpy": same_multiset,
           "host_ms_per_batch_alone": waits,
           "timer": "host clock over a whole epoch (remainder kept) iterated with no step"}
    emit(rec)
    if not (same_multiset and within and sum(trained.values()) == steps * train_ds.batch_size):
        raise SystemExit(f"the native loader's rows are not the corpus's: {rec}")
    return rec


def falls(losses, n: int = 10) -> tuple[float, float]:
    """Mean of the first and the last ``n`` losses; raises unless it fell."""
    first, last = sum(losses[:n]) / len(losses[:n]), sum(losses[-n:]) / len(losses[-n:])
    if not (math.isfinite(last) and last < first):
        raise SystemExit(f"the loss did not fall: {first} -> {last}")
    return first, last


def paper_base_path(src_vocab, tgt_vocab):
    """Step 2: ``cli.train --preset base --attention_impl flash
    --sequence_length 64 --epochs 1`` at full depth on the defaults, so
    through the native loader, with its gates; returns (export, flash
    launches, record)."""
    import statistics

    import torch

    from transformer_tpu_torch.cli import train

    data = os.path.join(ROOT, "data")
    export = os.path.join(BUILD_DIR, "paper_base_export")
    argv = [
        "--preset", "base", "--attention_impl", "flash", "--sequence_length", str(S2S_LEN),
        "--warmup_steps", PAPER_WARMUP,
        "--epochs", "1", "--dataset_path", data, "--src_vocab_file", src_vocab,
        "--tgt_vocab_file", tgt_vocab, "--export_path", export,
        "--ckpt_path", fresh_dir("ckpt", "paper_base"),
    ]
    logs: list[str] = []
    read_flash_counters(reset=True)
    t0 = time.perf_counter()
    trainer = train.main(argv, log_fn=logs.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_flash_counters()
    cfg, steps, evals = trainer.model_cfg, len(trainer.step_seconds), trainer.eval_batches
    match = re.match(r"test BLEU ([-0-9.naif]+) on (\d+) pairs",
                     next((ln for ln in logs if ln.startswith("test BLEU")), ""))
    bleu_pairs = int(match.group(2)) if match else 0
    translate_calls = 1 + -(-bleu_pairs // trainer.train_cfg.batch_size)
    layers = 2 * cfg.num_layers
    want = {"flash_fwd": layers * (steps + evals) + cfg.num_layers * translate_calls,
            "flash_dq": layers * steps, "flash_dkdv": layers * steps}
    ms = [t * 1e3 for t in trainer.step_seconds]
    first, last = falls(trainer.losses)
    rec = {
        "phase": "paper", "step": "base_fit", "argv": argv, "card": nvidia_smi_line(),
        "layers": [cfg.num_layers, cfg.num_layers], "d_model": cfg.d_model,
        "steps": steps, "eval_batches": evals, "step_ms_first": ms[0],
        "step_ms_median": statistics.median(ms[1:]), "step_ms_mean": statistics.mean(ms[1:]),
        "target_tokens_per_s": trainer.train_metrics.weight / sum(trainer.step_seconds),
        "loss_first_10": first, "loss_last_10": last,
        "eval_loss": trainer.eval_metrics.loss,
        "bleu": float(match.group(1)) if match else float("nan"), "bleu_pairs": bleu_pairs,
        "fit_and_epilogue_wall_s": wall, "launches": launches, "expected_launches": want,
        "data_log": next((ln for ln in logs if ln.startswith("data:")), ""),
    }
    emit(rec)
    if bleu_pairs != 200 or not math.isfinite(rec["bleu"]):
        raise SystemExit(f"paper base: BLEU {rec['bleu']} on {bleu_pairs} pairs")
    for name, count in launches.items():
        if count <= 0 or count != want[name]:
            raise SystemExit(f"{name} launched {count} times on the base path, expected "
                             f"{want[name]}")
    rec["loader"] = loader_checks(trainer.train_ds, steps)
    rec["profile"] = train_profile(trainer, trainer.train_ds, phase="paper")
    del trainer
    torch.cuda.empty_cache()
    return export, launches, rec


def tfds_vocab(side: str) -> str:
    """A tfds ``SubwordTextEncoder`` file for one side of the corpus, built
    by hand as the JAX package's test builds its own: the corpus's
    ``PAPER_TFDS_WORDS`` most frequent tfds tokens with the word-end ``_``,
    then every character of the corpus and the escape characters; written
    with ``TfdsSubwordTokenizer.save``."""
    from collections import Counter

    from transformer_tpu_torch.data.tfds_compat import TfdsSubwordTokenizer, _tokenize

    with open(os.path.join(ROOT, "data", f"{side}-train.txt"), encoding="utf-8") as f:
        lines = [line.rstrip("\n") for line in f]
    counts = Counter(token for line in lines for token in _tokenize(line))
    pieces = [w.replace("\\", "\\\\").replace("_", "\\u") + "_"
              for w, _ in counts.most_common(PAPER_TFDS_WORDS)]
    seen = set(pieces)
    pieces += sorted(({c for line in lines for c in line} | set("\\_u;0123456789")) - seen)
    path = os.path.join(BUILD_DIR, "vocab", f"tfds-{side}-train.subwords")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    TfdsSubwordTokenizer(pieces).save(path)
    return path


def paper_streaming_path():
    """Step 3: the source paper's command line at ``PAPER_LAYERS`` +
    ``PAPER_LAYERS`` layers, streaming over tfds vocab files; returns
    (export, its vocab files, record)."""
    import torch

    from transformer_tpu_torch.cli import train
    from transformer_tpu_torch.data.tfds_compat import TfdsSubwordTokenizer
    from transformer_tpu_torch.data.tokenizer import SubwordTokenizer

    vocabs = {side: tfds_vocab(side) for side in ("src", "tgt")}
    src_tok = SubwordTokenizer.load(vocabs["src"])
    lines = source_sentences(500)
    round_trips = sum(src_tok.decode(src_tok.encode(line)) == line for line in lines)
    export = os.path.join(BUILD_DIR, "paper_stream_export")
    argv = [
        "--preset", "base", "--num_layers", str(PAPER_LAYERS), "--enable_function=true",
        "--per_replica_batch_size", "64", "--streaming", "--buffer_size", str(PAPER_BUFFER),
        "--epochs", "1", "--dataset_path", os.path.join(ROOT, "data"),
        "--src_vocab_file", vocabs["src"], "--tgt_vocab_file", vocabs["tgt"],
        "--export_path", export, "--ckpt_path", fresh_dir("ckpt", "paper_stream"),
    ]
    logs: list[str] = []
    read_flash_counters(reset=True)
    t0 = time.perf_counter()
    trainer = train.main(argv, log_fn=logs.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ds = trainer.train_ds
    first, last = falls(trainer.losses)
    ms = sorted(t * 1e3 for t in trainer.step_seconds)
    rec = {
        "phase": "paper", "step": "streaming_fit", "argv": argv,
        "tfds_vocab_sizes": {side: SubwordTokenizer.load(p).vocab_size
                             for side, p in vocabs.items()},
        "tfds": isinstance(src_tok, TfdsSubwordTokenizer),
        "test_lines_round_tripped": round_trips, "test_lines": len(lines),
        "attention_impl": trainer.model_cfg.attention_impl, "steps": len(ms),
        "step_ms_median": ms[len(ms) // 2], "peak_buffer_examples": ds.peak_buffer_examples,
        "peak_resident_examples": ds.peak_resident_examples, "buffer_size": PAPER_BUFFER,
        "loss_first_10": first, "loss_last_10": last, "wall_s": wall,
        "flash_launches": read_flash_counters(),
        "data_log": next((ln for ln in logs if ln.startswith("data:")), ""),
        "bleu_log": next((ln for ln in logs if ln.startswith("test BLEU")), ""),
    }
    emit(rec)
    if not (rec["tfds"] and round_trips == len(lines)):
        raise SystemExit(f"tfds tokenizer: {round_trips} of {len(lines)} lines round-trip")
    if not (0 < ds.peak_buffer_examples <= PAPER_BUFFER
            and ds.peak_resident_examples <= PAPER_BUFFER + trainer.train_cfg.batch_size):
        raise SystemExit(f"streaming buffer peaked at {ds.peak_buffer_examples} examples "
                         f"({ds.peak_resident_examples} resident) of {PAPER_BUFFER}")
    if not rec["data_log"].startswith(f"data: streaming corpus (buffer {PAPER_BUFFER})"):
        raise SystemExit(f"cli.train did not stream: {rec['data_log']}")
    del trainer
    torch.cuda.empty_cache()
    return export, vocabs, rec


def attention_maps(export, src_vocab, tgt_vocab, name) -> tuple[dict, list]:
    """``cli.translate --attention_out`` on ``ATTENTION_SENTENCES`` test
    sentences (stdin); returns the .npz's arrays and the translations."""
    import numpy as np

    from transformer_tpu_torch.cli import translate

    out_path = os.path.join(BUILD_DIR, f"{name}_maps.npz")
    sentences = source_sentences(ATTENTION_SENTENCES)
    outputs = translate.main(
        ["--export_path", export, "--src_vocab_file", src_vocab, "--tgt_vocab_file", tgt_vocab,
         "--attention_out", out_path],
        stdin=io.StringIO("\n".join(sentences) + "\n"), stdout=io.StringIO())
    with np.load(out_path) as f:
        return {k: f[k] for k in f.files}, outputs


def map_keys(n: int, layers: int, blocks: tuple, encoder: bool) -> list[str]:
    """The keys of the JAX package's dump: ids, then the maps it keeps."""
    keys = []
    for i in range(n):
        keys += [f"s{i}/src_ids", f"s{i}/tgt_ids"]
        keys += [f"s{i}/encoder_layer{L}" for L in range(1, layers + 1) if encoder]
        keys += [f"s{i}/decoder_layer{L}_block{b}" for L in range(1, layers + 1) for b in blocks]
    return sorted(keys)


def attention_maps_path(stream_export, stream_vocabs, base_export, src_vocab, tgt_vocab):
    """Step 4: the maps of the streaming (xla) export and of the base flash
    export; returns the flash launches of the flash export's run."""
    import numpy as np

    n = ATTENTION_SENTENCES
    xla, _ = attention_maps(stream_export, stream_vocabs["src"], stream_vocabs["tgt"],
                            "paper_stream")
    want_keys = map_keys(n, PAPER_LAYERS, (1, 2), encoder=True)
    sums = max(float(np.abs(v.sum(-1) - 1.0).max()) for k, v in xla.items()
               if not k.endswith("_ids"))
    above = max(float(np.abs(np.triu(v, k=1)).max()) for k, v in xla.items()
                if k.endswith("block1"))
    read_flash_counters(reset=True)
    flash, _ = attention_maps(base_export, src_vocab, tgt_vocab, "paper_base")
    launches = read_flash_counters()
    layers = 6
    want_launches = {"flash_fwd": layers + n * 2 * layers, "flash_dq": 0, "flash_dkdv": 0}
    rec = {
        "phase": "paper", "step": "attention_out", "sentences": n,
        "xla_keys_are_jax": sorted(xla) == want_keys, "xla_maps": len(xla) - 2 * n,
        "xla_worst_row_sum_error": sums, "xla_block1_worst_above_diagonal": above,
        "flash_keys": sorted({k.split("/", 1)[1] for k in flash}),
        "flash_keys_are_jax": sorted(flash) == map_keys(n, layers, (2,), encoder=False),
        "launches": launches, "expected_launches": want_launches,
    }
    emit(rec)
    if not (rec["xla_keys_are_jax"] and sums <= 1e-2 and above == 0.0):
        raise SystemExit(f"the streaming export's attention maps fail: {rec}")
    if not rec["flash_keys_are_jax"]:
        raise SystemExit(f"the flash export's dump holds {rec['flash_keys']}")
    if launches != want_launches:
        raise SystemExit(f"--attention_out on the flash export launched {launches}, expected "
                         f"{want_launches}")
    return launches


def paper_path(vocab_paths: dict) -> tuple[dict, dict]:
    """Phase 16: the native build and vocabularies, base 6 + 6 through the
    native loader, the paper's streaming command line over tfds vocab
    files, and ``--attention_out``. Returns the flash launches by path and
    the records."""
    recs = {"build": native_build(), "vocabs": native_vocabs(vocab_paths)}
    base_export, base_launches, recs["base"] = paper_base_path(vocab_paths["src"],
                                                               vocab_paths["tgt"])
    stream_export, stream_vocabs, recs["streaming"] = paper_streaming_path()
    map_launches = attention_maps_path(stream_export, stream_vocabs, base_export,
                                       vocab_paths["src"], vocab_paths["tgt"])
    return {"paper_train": base_launches, "paper_attention_out": map_launches}, recs


# --------------------------------------------------------------------------
# phase 17: telemetry on the serving, training and fleet paths


def obs_cli(*args) -> str:
    """``python -m transformer_tpu_torch.obs`` (host only, no card): its
    standard output; a failure fails the phase."""
    proc = subprocess.run([sys.executable, "-m", "transformer_tpu_torch.obs", *args], cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": ROOT}, capture_output=True,
                          text=True, timeout=120)
    if proc.returncode != 0:
        raise SystemExit(f"telemetry: obs {args[0]} failed ({proc.returncode}): "
                         f"{proc.stderr[-2000:]}")
    return proc.stdout


def last_snapshot(events) -> dict:
    snaps = [e["metrics"] for e in events if e["kind"] == "metrics.snapshot"]
    return snaps[-1] if snaps else {}


def telemetry_serve(export, vocab_path, reqs, plain_answers, serve_rec, graph_rec, root):
    """(a) phase 4's requests through ``cli.serve`` with telemetry and
    tracing on: the same answers, steps, captures, replays and B/A
    launches as phase 4's; what ``obs`` renders from the log."""
    import torch

    from transformer_tpu_torch.cli import serve
    from transformer_tpu_torch.kernels.paged_flash import paged_flash_attention
    from transformer_tpu_torch.obs import read_events
    from transformer_tpu_torch.ops.ffn import fused_ln_ffn

    path = os.path.join(root, "serve.jsonl")
    argv = serve_argv(export, vocab_path, "--metrics_jsonl", path, "--trace")
    lines = "".join(json.dumps(r) + "\n" for r in reqs)
    out = io.StringIO()
    paged_flash_attention.launches = fused_ln_ffn.launches = 0
    t0 = time.perf_counter()
    sched = serve.main(argv, stdin=io.StringIO(lines), stdout=out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_attention": paged_flash_attention.launches,
                "fused_ln_ffn": fused_ln_ffn.launches}
    st = sched.stats
    events = read_events(path)
    snap = last_snapshot(events)
    perf = snap.get("perf_seconds_serve_pool_step_paged_flash", {})
    summary = obs_cli("summarize", path)
    slo_report = obs_cli("slo", path)
    trace_path = os.path.join(root, "serve_trace.json")
    obs_cli("trace", path, "--out", trace_path)
    with open(trace_path) as f:
        spans = json.load(f)["traceEvents"]
    roots = [e for e in spans if e.get("name") == "serve.request"
             and "parent" not in e.get("args", {})]
    step_ms = st["decode_s"] / max(1, st["steps"]) * 1e3
    rec = {
        "phase": "telemetry", "step": "serve", "card": nvidia_smi_line(), "argv": argv,
        "answers_identical": out.getvalue() == "".join(
            json.dumps(a) + "\n" for a in plain_answers),
        "steps": st["steps"], "steps_phase4": serve_rec["decode_forwards"],
        "captures": len(sched.forward.captures), "captures_phase4": len(serve_rec["captures"]),
        "replays": sched.forward.replays, "replays_phase4": serve_rec["replays"],
        "launches": launches, "launches_phase4": serve_rec["launches"],
        "events": len(events), "serve_requests": sum(e["kind"] == "serve.request" for e in events),
        "trace_roots": len(roots), "trace_spans": sum(e.get("ph") == "X" for e in spans),
        "serve_steps_total": snap.get("serve_steps_total"),
        "profiler_pool_step_dispatches": perf.get("count"),
        "profiler_pool_step_p50_ms": (perf.get("p50") or 0) * 1e3 or "not measured",
        "phase10_replayed_step_wall_ms": (graph_rec or {}).get("decode", {}).get(
            "graph", {}).get("wall_ms_per_step", "not measured"),
        "slo_gauges": sorted(k for k in snap if k.startswith("serve_slo_burn_")),
        "step_ms_on": step_ms, "step_ms_off": serve_rec["decode_step_ms"],
        "overhead_step_ms": step_ms - serve_rec["decode_step_ms"],
        "serve_wall_s_on": wall, "serve_wall_s_off": serve_rec["serve_wall_s"],
        "summarize": summary.splitlines()[:40], "slo": slo_report.splitlines(),
        "timers": "step_ms: the scheduler's decode seconds over its steps (host clock, each "
                  "step ending in the picks' readback); profiler p50: obs/profile.py's "
                  "samples of the same steps",
    }
    emit(rec)
    checks = {
        "answers byte-identical to phase 4's": rec["answers_identical"],
        "steps, captures, replays and launches equal phase 4's": (
            rec["steps"] == rec["steps_phase4"] and rec["captures"] == rec["captures_phase4"]
            and rec["replays"] == rec["replays_phase4"] and launches == serve_rec["launches"]),
        "one profiler sample and one serve_steps_total a step": (
            rec["profiler_pool_step_dispatches"] == rec["steps"] == rec["serve_steps_total"]),
        "a serve.request event and a trace root a request": (
            rec["serve_requests"] == rec["trace_roots"] == len(reqs)),
        "summarize renders perf: and the pool step": (
            "perf:" in summary and "serve.pool_step_paged_flash" in summary),
        "obs slo renders the default objectives": all(
            name in slo_report for name in ("availability", "ttft_p95", "deadline_miss",
                                            "acceptance_rate")),
        "the SLO engine's gauges": bool(rec["slo_gauges"]),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"telemetry (serve): {failed}: {rec}")
    return launches


def telemetry_train(src_vocab, tgt_vocab, d_rec, root):
    """(b) phase 9's D run again, with ``--metrics_jsonl --trace
    --profile_dir --tb_log_dir``: bit-identical losses, the same captures
    and flash counters; the counters, memory, profile window and
    TensorBoard files telemetry wrote."""
    import statistics

    import torch

    from transformer_tpu_torch.obs import read_events

    data = cut_corpus(CKPT_PAIRS)
    path = os.path.join(root, "train.jsonl")
    prof_dir, tb_dir = os.path.join(root, "profile"), os.path.join(root, "tb")
    window = (8, 8)  # the profile window's first step and length
    argv = dispatch_argv(data, src_vocab, tgt_vocab, fresh_dir("ckpt", "telemetry"), "d_tel", 2,
                         8, "--metrics_jsonl", path, "--trace", "--profile_dir", prof_dir,
                         "--profile_start_step", str(window[0]),
                         "--profile_num_steps", str(window[1]), "--tb_log_dir", tb_dir)

    def median_outside_window(run):
        """The step median with the dispatches that start inside the
        profile window left out (a dispatch's time split over its steps)."""
        per_step, at = [], 0
        for k, ms in zip(run["dispatches"], run["dispatch_ms"]):
            if not window[0] <= at < sum(window):
                per_step += [ms / k] * k
            at += k
        return statistics.median(per_step)

    launches = {fn.__name__: 0 for fn in flash_counters()}
    trainer, _, rec = dispatch_fit(argv, launches, d_rec["steps"] // d_rec["epochs"])
    peak = torch.cuda.max_memory_allocated()
    events = read_events(path)
    snap = last_snapshot(events)
    memory = [e for e in events if e["kind"] == "train.memory"]
    mem_peak = max(s["peak_bytes_in_use"] for e in memory for s in e["devices"].values())
    profile_files = os.listdir(prof_dir)
    with open(os.path.join(prof_dir, profile_files[0])) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"}
    flash_in_window = {k: sorted(n for n in names if k in n)[:3]
                       for k in ("flash_fwd", "flash_dq", "flash_dkdv")}
    stamp = os.listdir(tb_dir)
    summary = obs_cli("summarize", path)
    out = {
        "phase": "telemetry", "step": "train", "card": nvidia_smi_line(), "argv": argv,
        "losses_identical": rec["losses"] == d_rec["losses"], "steps": trainer.state.step,
        "captures": rec["captures"], "captures_d": d_rec["captures"],
        "launches": rec["launches"], "launches_d": d_rec["launches"],
        "train_steps_total": snap.get("train_steps_total"),
        "train_step_seconds_count": (snap.get("train_step_seconds") or {}).get("count"),
        "perf_train_step_dispatches": (snap.get("perf_seconds_train_step") or {}).get("count"),
        "train_compiled_programs": snap.get("train_compiled_programs"),
        "memory_peak_bytes": mem_peak, "max_memory_allocated": peak,
        "profile_kernels": flash_in_window, "profile_files": profile_files,
        "tensorboard": {s_: sorted(os.listdir(os.path.join(tb_dir, s_))) for s_ in stamp},
        "event_kinds": sorted({e["kind"] for e in events}),
        "step_ms_median_on": rec["step_ms_median"], "step_ms_median_off": d_rec["step_ms_median"],
        "overhead_step_ms": rec["step_ms_median"] - d_rec["step_ms_median"],
        "step_ms_median_on_outside_profile": median_outside_window(rec),
        "step_ms_median_off_same_dispatches": median_outside_window(d_rec),
        "overhead_step_ms_outside_profile": (
            median_outside_window(rec) - median_outside_window(d_rec)),
        "step_ms_p50_stepTimer": statistics.median(t * 1e3 for t in trainer.step_seconds),
        "summarize": summary.splitlines()[:20],
        "timers": "step_ms: host clock per dispatch up to its device synchronize, over its "
                  "steps; *_outside_profile: without the dispatches that start in the "
                  "profile window, in both runs",
    }
    emit(out)
    steps = trainer.state.step
    checks = {
        "losses bit-identical to phase 9's D": out["losses_identical"],
        "captures and flash counters equal D's": (
            rec["captures"] == d_rec["captures"] and rec["launches"] == d_rec["launches"]),
        "train_steps_total and the step histogram count the steps": (
            out["train_steps_total"] == steps == out["train_step_seconds_count"]),
        "one train.step sample a dispatch": out["perf_train_step_dispatches"] == len(
            rec["dispatches"]),
        "train.memory's peak is torch.cuda.max_memory_allocated": mem_peak == peak,
        "the profile window names the flash kernels": all(flash_in_window.values()),
        "TensorBoard files for train and test": any(
            v == ["test", "train"] for v in out["tensorboard"].values()),
        "summarize renders the train run": f"train: {steps} steps" in summary,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"telemetry (train): {failed}: {out}")
    del trainer
    torch.cuda.empty_cache()
    return launches


# An idle drain right after the traffic (route.scale, route.retire: the
# summary's fleet line), under a TTFT objective no shared-card prompt
# misses (a burn would hold the drain back).
TEL_FLEET_FLAGS = ("--max_replicas", "2", "--min_replicas", "1", "--scale_idle", "1",
                   "--scale_cooldown", "0.5", "--slo_spec", "ttft_p95:threshold=60",
                   "--trace")


def telemetry_fleet(export, vocab_path, tok, reqs, root):
    """(c) two fp32 workers behind ``cli.router`` with ``--metrics_jsonl
    --trace``: 8 greedy requests answered as a single scheduler answers
    them, a log a process, the workers' spans under the router's, and the
    idle drain's ``route.scale`` / ``route.retire`` rendering the
    ``fleet:`` line."""
    from transformer_tpu_torch.cli import router as cli
    from transformer_tpu_torch.cli.train import flags_to_telemetry
    from transformer_tpu_torch.obs import merge_events

    export32 = fp32_export(export, name="fleet_export_fp32")
    greedy = [r for r in reqs if "temperature" not in r][:8]
    path = os.path.join(root, "router.jsonl")
    args = cli.build_parser().parse_args(["--export_path", export32, "--tgt_vocab_file",
                                          vocab_path, *FLEET_FLAGS, *TEL_FLEET_FLAGS,
                                          "--metrics_jsonl", path])
    telemetry = flags_to_telemetry(args)
    t0 = time.perf_counter()
    router = cli.build_router(args, telemetry)
    want = single_scheduler(export32, tok, greedy, cache_mb=256)
    try:
        got = route(router, greedy)
        serve_s = time.perf_counter() - t0
        pump_until(router, lambda: any(l.retired for l in router.links), 60, "the idle drain")
    finally:
        router.shutdown()
        telemetry.close()
    logs = [path, f"{path}.r0", f"{path}.r1"]
    events, _ = merge_events(logs)
    spans = {e["span"]: e for e in events if e["kind"] == "trace.span"}
    roots = [e for e in spans.values() if e["name"] == "serve.request"]
    summary = obs_cli("summarize", *logs)
    rec = {
        "phase": "telemetry", "step": "fleet", "card": nvidia_smi_line(),
        "answers_equal_single": got == want, "answers": len(got),
        "logs_exist": [os.path.exists(p) for p in logs],
        "worker_spans_under_router": sum(
            spans.get(e.get("parent"), {}).get("name") == "route.request" for e in roots),
        "route_kinds": sorted({e["kind"] for e in events if e["kind"].startswith("route.")}),
        "perf_by_worker": [l.final_perf for l in router.links],
        "serve_s_with_startup": serve_s, "summarize": summary.splitlines(),
    }
    emit(rec)
    checks = {
        "answers equal a single scheduler's": rec["answers_equal_single"],
        "a log a process": all(rec["logs_exist"]),
        "every worker request span under a route.request": (
            rec["worker_spans_under_router"] == len(roots) == len(greedy)),
        "summarize renders the router: and fleet: lines": (
            "router:" in summary and "fleet:" in summary),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"telemetry (fleet): {failed}: {rec}")


def telemetry_path(export, vocab_path, tok, reqs, plain_answers, serve_rec, graph_rec,
                   src_vocab, d_rec):
    """Phase 17: (a) serving, (b) training, (c) the fleet with telemetry
    on. Returns the B/A and the flash launches of its main-path runs."""
    root = fresh_dir("telemetry")
    os.makedirs(root)
    serve_launches = telemetry_serve(export, vocab_path, reqs, plain_answers, serve_rec,
                                     graph_rec, root)
    train_launches = telemetry_train(src_vocab, vocab_path, d_rec, root)
    telemetry_fleet(export, vocab_path, tok, reqs, root)
    return serve_launches, train_launches


def telemetry_only() -> None:
    """Phase 17 alone (``python3 chip_smoke.py --only telemetry``): phase
    4's serving and phase 9's D run first, as its references."""
    tok, vocab_path = vocab()
    _, src_vocab = vocab(side="src")
    _, export, reqs, _, plain_answers, serve_rec = main_path(tok, vocab_path)
    data = cut_corpus(CKPT_PAIRS)
    launches = {fn.__name__: 0 for fn in flash_counters()}
    trainer, _, d_rec = dispatch_fit(dispatch_argv(data, src_vocab, vocab_path,
                                                   fresh_dir("ckpt", "dispatch"), "d", 2, 8),
                                     launches, 20)
    del trainer
    serve_launches, train_launches = telemetry_path(
        export, vocab_path, tok, reqs, plain_answers, serve_rec, None, src_vocab, d_rec)
    emit({"phase": "telemetry", "launches_by_path": {"serve": serve_launches,
                                                     "train": train_launches}})


def paper_only() -> None:
    """Phase 16 alone (``python3 chip_smoke.py --only paper``): the Python
    vocabularies built here when build/vocab/ lacks them."""
    launches, _ = paper_path({side: vocab(side=side)[1] for side in ("src", "tgt")})
    emit({"phase": "paper", "launches_by_path": launches})


def mlm_only() -> None:
    """Phase 15 alone (``python3 chip_smoke.py --only mlm``)."""
    _, vocab_path = vocab()
    launches, _ = mlm_path(vocab_path)
    emit({"phase": "mlm", "launches_by_path": launches})


def fleet_only() -> None:
    """Phase 14 alone (``python3 chip_smoke.py --only fleet``): phase 4's
    export written from the seed (no serving through the kernels) and the
    fp32 dense reference computed here instead of taken from phase 13."""
    import torch

    from transformer_tpu_torch.convert import export_params
    from transformer_tpu_torch.models.transformer import init_params

    tok, vocab_path = vocab()
    cfg = long4k_config(tok.model_vocab_size)
    export = os.path.join(BUILD_DIR, "smoke_export")
    export_params(init_params(cfg, torch.Generator().manual_seed(SEED), device="cuda"), cfg,
                  export)
    reqs = make_requests(tok)
    fleet_path(export, vocab_path, tok, reqs, single_scheduler(fp32_export(export), tok, reqs))


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
    if sys.argv[1:] == ["--only", "fleet"]:
        fleet_only()
        return 0
    if sys.argv[1:] == ["--only", "mlm"]:
        mlm_only()
        return 0
    if sys.argv[1:] == ["--only", "paper"]:
        paper_only()
        return 0
    if sys.argv[1:] == ["--only", "telemetry"]:
        telemetry_only()
        return 0

    # Each phase's seconds on the host clock, emitted as it ends.
    started = [time.perf_counter()] * 2

    def lap(name):
        now = time.perf_counter()
        emit({"phase": "clock", "done": name, "seconds": now - started[1],
              "elapsed_s": now - started[0]})
        started[1] = now

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
    lap("1-2 device, build")

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
        # phase 13's windowed training: long4k's shape, causal, band 1024
        check_flash(f"bf16 causal band={WINDOW} (windowed)", "bfloat16", 4, 4095, 4095, 8, 8, 64,
                    True, WINDOW, False),
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
    # ... and at phase 11's shapes (B 16, 2 heads a process, chunks of 16)
    d_flash, d_ring = dist_kernel_checks()
    f_recs += d_flash
    r_recs += d_ring
    lap("3 kernels")

    # 4. serving
    tok, vocab_path = vocab()
    cfg, export, reqs, launches, plain_answers, serve_rec = main_path(tok, vocab_path)
    fp32_decode_check(cfg, export, tok, reqs)
    decode_profile(export, tok, reqs)
    lap("4 serving")

    # 10. speculative decoding, the prefix cache and the replayed decode
    # and verify forwards (on phase 4's export, while it is at hand)
    vb_recs, va_rec = verify_kernel_checks()
    row_invariance()
    spec_launches = speculative_path(export, vocab_path, reqs, plain_answers, serve_rec)
    fp32_launches, fp32_answers = fp32_speculative_check(export, vocab_path, reqs)
    spec_launches.update(fp32_launches)
    prefix_launches = prefix_path(export, vocab_path, tok)
    graph_rec = graph_path(export, tok, reqs)
    serve_launches = {
        "serve": launches,
        **{f"speculative {k}": v for k, v in spec_launches.items()},
        **{f"prefix {k}": v for k, v in prefix_launches.items()},
    }
    lap("10 speculation, prefix cache, graphs")

    # 5. training on one card
    trainer, train_ds, train_launches, single = train_path(vocab_path)
    fp32_train_check(tok, train_ds)
    train_profile(trainer, train_ds)
    del trainer
    torch.cuda.empty_cache()
    lap("5 training")

    # 6. seq2seq: the flash kernels at its shapes, Transformer-base trained
    # for an epoch and scored, fp32 checks, translation, the other presets
    s2s_recs, s2s_timed = seq2seq_flash_checks()
    src_tok, src_vocab = vocab(side="src")
    s2s_trainer, s2s_train_ds, s2s_export, s2s_launches, _ = seq2seq_train_path(
        src_vocab, vocab_path
    )
    train_profile(s2s_trainer, s2s_train_ds, phase="seq2seq")
    s2s_batch = next(iter(s2s_train_ds.batches(0)))
    s2s_cfg = s2s_trainer.model_cfg
    seq2seq_fp32_check(s2s_trainer, s2s_batch)
    tr_launches, _ = translate_path(s2s_export, src_vocab, vocab_path)
    fp32_decode_tokens_check(s2s_trainer, src_tok, tok)
    del s2s_trainer
    torch.cuda.empty_cache()
    _, joint_vocab = vocab(side="joint")
    presets_path(src_vocab, vocab_path, joint_vocab)
    lap("6 seq2seq")

    # 7. sequence-parallel training over four processes on this card, at
    # long4k's width and 2 layers, against a single-card run of those flags
    sp_trainer, _, sp_single_launches, sp_single = train_path(
        vocab_path, "--num_layers", str(SP_LAYERS), name="sp_single")
    del sp_trainer
    torch.cuda.empty_cache()
    sp = sp_train_path(vocab_path, sp_single)
    fresh_dir("ckpt")  # the earlier runs' checkpoints
    lap("7 sequence parallel")

    # 8. checkpoints, resume, preemption and export on the base path
    ckpt_launches = checkpoints_path(src_vocab, vocab_path)
    lap("8 checkpoints")

    # 9. steps_per_dispatch as CUDA-graph replays, buckets, dots
    disp_launches, e_rec, d_rec = dispatch_path(src_vocab, vocab_path,
                                                os.path.join(BUILD_DIR, "train_export"))
    lap("9 dispatch")

    # 11. seq2seq over four processes on this card: dp 4, ring sp 4,
    # Ulysses sp 4; long4k over Ulysses held to phase 7's single card; and
    # the fp32 step under each mesh
    dist_launches, _, _ = s2s_dist_path(src_vocab, vocab_path, e_rec, sp_single)
    # ... and phase 7's fp32 ring step, in the same four processes
    s2s_fp32_mesh_check(s2s_cfg, s2s_batch, tok, next(iter(train_ds.batches(0)))[1])
    fresh_dir("ckpt", "s2s_dist")
    lap("11 seq2seq over processes")

    # 12. the translator behind cli.serve (phase 6's export, the grouped
    # path), cli.generate and speculative_generate over dense caches and
    # admission control on the replayed scheduler (phase 4's export)
    grouped_launches = grouped_translate_path(s2s_export, src_vocab, vocab_path)
    generate_path(export, vocab_path, tok, reqs, plain_answers)
    serve_launches["admission"] = admission_path(export, vocab_path, reqs, plain_answers)
    lap("12 grouped, generate, admission")

    # 13. the JAX server's default layouts (dense; paged through gathered
    # views), long4k with a 1024 window trained and served on rolling
    # caches, and the circuit breakers under injected faults
    _, dense32 = layouts_path(export, vocab_path, tok, reqs, plain_answers, graph_rec,
                              fp32_answers)
    lap("13 layouts")
    windowed_launches = windowed_path(vocab_path, tok, reqs)
    lap("13 windowed")
    serve_launches["breakers"] = breaker_path(export, vocab_path, tok, reqs, fp32_answers)
    lap("13 breakers")

    # 14. the serving fleet: cli.router over replica worker processes on
    # this card (phase 4's export; no kernel launches: the dense layout)
    fleet_path(export, vocab_path, tok, reqs, dense32)
    lap("14 fleet")

    # 15. the encoder-only masked LM: the flash kernels at its shape, the
    # base MLM trained (replayed steps held to eager ones), Adafactor, and
    # fill requests through cli.serve
    mlm_launches, mlm_timed = mlm_path(vocab_path)
    lap("15 mlm")

    # 16. the trainer's command line: the native library and BPE trainer,
    # base 6 + 6 through the native loader, the paper's flags streaming
    # over tfds vocab files, and --attention_out
    paper_launches, _ = paper_path({"src": src_vocab, "tgt": vocab_path})
    lap("16 paper")

    # 17. telemetry on phase 4's serving, phase 9's D run and a fleet of two
    serve_launches["telemetry"], tel_train_launches = telemetry_path(
        export, vocab_path, tok, reqs, plain_answers, serve_rec, graph_rec, src_vocab, d_rec)
    lap("17 telemetry")

    def summary(name, main_rec, recs, replaces, verify_rec):
        cold = {k: main_rec[k] for k in ("device_ms_cold", "library_device_ms_cold",
                                         "share_of_bound_warm") if k in main_rec}
        by_path = {path: counts[name] for path, counts in serve_launches.items()}
        return {
            "name": name, "route": "cuda",
            "source": f"transformer_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "verify_shape": {key: verify_rec[key] for key in (
                "case", "ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
                "bound_ms", "bound_by", "share_of_bound")},
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
        by_path = {"train": train_launches[name], "sp_single": sp_single_launches[name],
                   "sp_train": sp["launches"][name],
                   "seq2seq_train": s2s_launches[name], "translate": tr_launches[name],
                   "ckpt": ckpt_launches[name], "dispatch": disp_launches[name],
                   "s2s_dist": dist_launches[name], "serve_grouped": grouped_launches[name],
                   "windowed_train": windowed_launches[name],
                   **{path: counts[name] for path, counts in mlm_launches.items()},
                   **{path: counts[name] for path, counts in paper_launches.items()},
                   "telemetry": tel_train_launches[name]}
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
            "mlm": {key: pick(mlm_timed, key) for key in (
                "ms", "device_ms", "plain_ms", "library_ms", "library_device_ms", "bound_ms",
                "bound_by", "share_of_bound", "share_of_bound_device",
                *(("device_ms_cold", "library_device_ms_cold", "share_of_bound_cold")
                  if name == "flash_fwd" else ()))},
            "timers": {"ms": "cuda_ms (device-bound at the main shape)", "library_ms": "cuda_ms",
                       "seq2seq": "ms, plain_ms, library_ms: cuda_ms (the host's time per call "
                                  "at B 64, S 64); device_ms, library_device_ms: kernel_us "
                                  "(profiler device time per call)",
                       "mlm": "as seq2seq, at B 64, S 128, bidirectional, bf16; the "
                              "forward's *_cold: cuda_graph_ms over 16 input copies"},
        }

    print(smi, flush=True)
    emit({"kernels": [
        summary("paged_attention", b_main, b_recs + vb_recs,
                "transformer_tpu/kernels/paged_flash.py:62 _paged_kernel", vb_recs[0]),
        summary("fused_ln_ffn", a_main, a_recs + [va_rec],
                "transformer_tpu/ops/ffn.py:112 _fused_kernel", va_rec),
        flash_summary("flash_fwd", ("out",)),
        flash_summary("flash_dq", ("dq",)),
        flash_summary("flash_dkdv", ("dk", "dv")),
        {
            "name": "flash_ring_step", "route": "cuda",
            "source": "transformer_tpu_torch/csrc/flash_attention.cu",
            "replaces": FLASH_REPLACES["flash_ring_step"],
            "launches": sp["launches"]["flash_ring_step"] + dist_launches["flash_ring_step"],
            "launches_by_path": {"sp_train": sp["launches"]["flash_ring_step"],
                                 "s2s_dist": dist_launches["flash_ring_step"]},
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
