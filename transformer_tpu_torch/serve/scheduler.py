"""Continuous (in-flight) batching for decoder-only LM serving.

A port of ``transformer_tpu/serve/scheduler.py`` ``ContinuousScheduler``
with its three KV layouts (``kv_layout`` / ``decode_kernel``, the JAX
CLI's flags and defaults):

- ``kv_layout="dense"`` (the default): every slot owns a
  ``max_total + speculate_k`` row buffer per layer, stacked on a leading
  slot axis, or a rolling ``min(window, ...)`` row buffer for an
  ``attention_window`` model (the only layout that serves one). Each step
  is ONE batched forward of plain torch ops over every slot
  (``_pool_step``): each slot writes its rows at its own position (modulo
  the buffer when rolling) in one scatter and attends under its own mask
  row. This is the JAX package's reference layout;
- ``kv_layout="paged", decode_kernel="xla"``: every slot's KV lives in ONE
  block pool per layer, addressed through per-slot block tables
  (``kernels/kv_pool.KVPool``, block 0 the sink). Each step gathers
  dense-ordered views of the slots' blocks, sliced to the dense buffer
  length, runs the dense step over them and scatters the new rows back
  (``_pool_step_paged``): the forward sees the dense layout's shapes and
  values, so its answers are the dense layout's bit for bit;
- ``kv_layout="paged", decode_kernel="paged_flash"``: the same pool read
  in place by the two CUDA kernels (``models/paged_decode.py``: kernel B
  attends through the table, kernel A is the fused LayerNorm + FFN).

On the card every step forward is replayed from a CUDA graph
(``serve/graph.py``, one per slots × S_q × table width); on the CPU it
runs eagerly, with the kernels' plain versions on the paged_flash path.
Serving each layout (``cli.serve``'s flags, the JAX CLI's)::

    --kv_layout dense                                 # the default
    --kv_layout paged [--decode_kernel xla]           # gathered views
    --kv_layout paged --decode_kernel paged_flash     # kernels B and A

(add ``--device cpu`` on a machine without a card).

The rest is the JAX scheduler's:

- admission at step boundaries: a queued request takes a free slot, the
  longest block-aligned prefix of its prompt that the prefix cache holds
  is restored (dense: the hit's host blocks stacked to a power-of-two
  width and written into the slot, ``_slot_restore``; paged: device-tier
  blocks aliased into the table, host-tier blocks written into fresh
  ones), and the rest is chunk-prefilled (dense: into the slot's rows,
  ``_slot_prefill``; paged: through a gathered view whose written rows
  are scattered back, ``_slot_prefill_paged``); a prompt longer than its
  power-of-two prefill bucket feeds its tail through the steps;
- with ``speculate_k`` each step is a verify step that feeds each slot's
  pending token plus up to k lookahead tokens (prompt tail, then drafts)
  and keeps the longest accepted prefix (``serve/speculative.py``). Slot
  positions are host-authoritative on every layout (packed into each
  step's input), so the rollback of a rejected tail is position
  arithmetic (the JAX dense ``_pool_rollback``), plus table truncation on
  the paged layouts;
- a slot retires on EOS or when its ``max_new`` budget is spent, feeds its
  prompt blocks to the prefix cache (dense: host copies of the blocks the
  trie lacks, ``_slot_read_blocks``; paged: its blocks donated to the
  device tier by reference) and is recycled at the next step boundary.
  Paged pool exhaustion spills the device tier to the host tier first; at
  admission it then becomes a ``TransientError``, retried
  ``admission_retries`` times after a jittered ``backoff_ms`` each, before
  it answers ``transient``; during a step it preempts the slot;
- circuit breakers (``serve/resilience.py``): ``breaker_threshold``
  consecutive faults of the drafter (a raise, or a proposal slower than
  ``drafter_slow_ms``) or of the prefix cache (match, restore, insert)
  fail that subsystem OPEN to the plain path: verify rows carry no
  drafts, on the same verify forward; admissions neither match nor feed
  the cache. After ``breaker_cooldown_s`` one half-open probe decides.
  Greedy answers are the same either way. ``scheduler.breakers`` holds
  both, ``breaker_log`` their transitions, and the stats count the steps
  and admissions served while open. The fault plane's ``serve.prefill``
  point fires at the top of each admission;
- the request lifecycle: ``deadline_ms``, ``cancel(order)`` from any
  thread (executed at the next step boundary), ``max_backlog``
  (``backpressure``), and ``shutdown()`` (a later ``submit`` answers
  ``routing`` at its reserved order). An aborted slot donates nothing and
  its answer carries the tokens emitted so far as ``partial``. Client
  threads and the scheduler loop share the queue under one intake lock.

- live weights (the JAX two-version param slot): ``stage_params`` checks
  a new weight set against the serving one (same flat names, per-leaf
  shapes and stored dtypes) and casts it to the compute dtype on the
  device; admission pauses while a stage is pending, and at the first
  drained step boundary ``_maybe_swap`` copies the serving values into a
  resident second buffer and the staged values into the serving tensors,
  in place. The captured graphs read the serving tensors' addresses, so a
  flip re-captures nothing and no step can mix versions.
  ``stage_rollback`` stages the resident previous set; ``ckpt.swap`` (the
  fault plane) aborts a flip with the old weights serving. Every answer
  carries its admission-time ``weight_version`` (when the scheduler has
  one), and ``span_tap`` receives each answer's span dict (``order``,
  ``prompt_tokens``, ``new_tokens``, ``queue_s``, ``total_s``, ``ttft_s``,
  ``prefill_s``, ``forwards``, ``prefix_hit_tokens``, ``weight_version``).

- telemetry (``telemetry=``, an ``obs.Telemetry``; the JAX scheduler's
  hooks): ``serve_*`` gauges, counters and histograms, a ``serve.request``
  event per answer (the span dict above; errors too), ``serve.retry`` per
  admission retry and ``serve.breaker`` per breaker transition. With its
  tracer every request is a span tree: ``serve.request`` (under the
  request's ``traceparent`` when it has one) with ``serve.queue``,
  ``serve.admit`` (``prefix.match``), ``serve.prefill``
  (``prefix.restore``), ``serve.decode`` and ``prefix.insert``, and every
  step a ``scheduler.step`` (verify: ``spec.draft``, ``spec.verify``,
  ``spec.rollback``). With its profiler each pool step, verify step and
  slot prefill is recorded under the JAX program names
  (``serve.pool_step_paged_flash``, ...), timed up to the device
  synchronize the step already has (the picks' readback; the prefill's
  synchronize). ``slos`` (specs or a ``--slo_spec`` string) feeds the
  answers to an ``obs.slo.SLOEngine``: ``serve_slo_burn_*`` gauges and
  ``slo.burn`` events. Nothing of it runs inside a captured graph, so
  answers, captures, replays and kernel launches are the same with it on
  and off.

Greedy answers equal ``serve_batch=1`` sequential serving (each request
alone through ``train.decode.generate``), as in the JAX package. A MoE
model serves on every layout: its MoE layers take the plain sublayer
(``ops/moe.py``; on the paged_flash layout the dense layers keep the fused
FFN kernel), and each forward routes every row of its batch as its own
group with that forward's capacity, as in the JAX package (so a chunked
prefill or a verify step may route a token otherwise than a whole-prompt
forward would). Left out here (a later slice): the sharded replica.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import zlib
from collections import deque

import numpy as np
import torch

from transformer_tpu_torch.config import PAD_ID, ModelConfig
from transformer_tpu_torch.data.seeding import keyed_rng
from transformer_tpu_torch.device import resolve_device, synchronize
from transformer_tpu_torch.kernels.kv_pool import (
    KVPool,
    KVPoolExhausted,
    block_row_ids,
    gather_block_views,
    host_to_tensor,
    pool_copy_blocks,
    pool_read_block,
    pool_write_blocks,
    scatter_rows,
    to_host,
)
from transformer_tpu_torch.models.decoder import init_decoder_caches
from transformer_tpu_torch.models.paged_decode import check_paged_flash_config
from transformer_tpu_torch.models.transformer import (
    flatten,
    transformer_prefill,
    transformer_verify,
    unflatten,
)
from transformer_tpu_torch.ops.attention import (
    init_block_pool,
    insert_kv_blocks,
    kv_buffer_keys,
    slice_kv_blocks,
)
from transformer_tpu_torch.serve.graph import CapturedForward
from transformer_tpu_torch.serve.resilience import (
    BREAKER_STATE_VALUE,
    CircuitBreaker,
    TransientError,
    backoff_ms,
    classify_error,
    error_answer,
    maybe_fail,
)
from transformer_tpu_torch.serve.speculative import (
    NgramDrafter,
    build_verify_row,
    filtered_probs,
    judge_row,
    sampled_accept,
    verify_row_picks,
)
from transformer_tpu_torch.train.decode import (
    _detokenize_rows,
    prefill_len_for,
    sample_token,
)


def compute_params(params, cfg: ModelConfig, device: torch.device, own: bool = False):
    """The params as serving reads them: every kernel, bias and embedding
    cast once to the compute dtype (every use casts it there anyway, so the
    values are the same ones a per-call cast gives), LayerNorm parameters
    and a MoE router's kernel kept as stored (``layernorm_apply`` and the
    router read them in fp32). With ``own``
    no leaf is one of the caller's tensors (a weight flip writes into
    them)."""
    dtype = cfg.compute_dtype

    def walk(node, is_ln=False):
        if isinstance(node, dict):
            return {
                k: walk(v, is_ln or k.startswith("ln") or k in ("final_ln", "router"))
                for k, v in node.items()
            }
        if isinstance(node, list):
            return [walk(v, is_ln) for v in node]
        t = node.to(device)
        t = t if is_ln else t.to(dtype)
        return t.clone() if own and t is node else t

    return walk(params)


def dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype under its numpy name (``float32``, ``bfloat16``)."""
    return str(dtype).removeprefix("torch.")


def as_tensor(leaf) -> torch.Tensor:
    """A staged leaf as a tensor: tensors as they are, numpy arrays without
    a copy (bf16 from its 2-byte words, as checkpoints store it)."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    a = np.ascontiguousarray(leaf)
    if not a.flags.writeable:
        a = a.copy()
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


# --------------------------------------------------------------------------
# the dense layout's programs: per-layer buffers (N, buf_len, H, D) (int8:
# codes with their (N, buf_len, H, 1) fp32 scales), plus ``rolling`` for a
# windowed model; a slot's position is passed in, never stored


def _slot_view(layer: dict, slot: int) -> dict:
    """One slot's rows of a dense layer as a batch-1 cache (views: writes
    land in the pool)."""
    return {k: v[slot : slot + 1] if isinstance(v, torch.Tensor) else v for k, v in layer.items()}


def _pool_step(params, pools: list[dict], toks: torch.Tensor, index: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """One step of every slot: (N, S_q) tokens, slot s at position
    ``index[s]`` -> (N, S_q, V) logits, the K/V written in place. S_q 1 is
    the plain step; S_q k + 1 the verify step (the JAX ``_pool_verify``),
    for which the buffers keep k rows of slack. Free slots feed PAD at
    position 0 of their own rows, which admission overwrites."""
    caches = [dict(layer, index=index) for layer in pools]
    logits, _ = transformer_verify(params, toks, caches, index, cfg)
    return logits


def _slot_prefill(params, pools: list[dict], slot: int, prompt: torch.Tensor, start: int,
                  cfg: ModelConfig, chunk: int) -> torch.Tensor:
    """Chunked prefill of a (1, n) prompt suffix into dense slot ``slot``
    at positions ``start ..``, the slot's position reset to ``start``
    (stale rows of the previous occupant sit behind the mask until
    overwritten). Returns the (1, V) next-token logits. A failure leaves
    the other slots' rows untouched: it answers one admission alone."""
    caches = [dict(_slot_view(layer, slot), index=start) for layer in pools]
    logits, _ = transformer_prefill(params, prompt, caches, start, cfg, chunk=chunk)
    return logits


def _slot_restore(pools: list[dict], slot: int, blocks: list[dict[str, np.ndarray]]) -> None:
    """Write a prefix hit's stacked host blocks (``PrefixHit.stacked``:
    per layer (1, width, H, D), width a power-of-two block count) into
    dense slot ``slot`` at rows ``[0, width)``: no forward. Zero pad rows
    land past the hit, behind the mask until the suffix prefill writes
    them."""
    for layer, b in zip(pools, blocks):
        rows = {key: host_to_tensor(b[key], layer[key].dtype, layer[key].device)
                for key in kv_buffer_keys(layer)}
        insert_kv_blocks(_slot_view(layer, slot), rows, 0)


def _slot_read_blocks(pools: list[dict], slot: int, start: int, n: int):
    """Rows ``[start, start + n)`` of dense slot ``slot`` in the host block
    format (the prefix cache's insert at retirement)."""
    return [
        {key: to_host(rows)
         for key, rows in slice_kv_blocks(_slot_view(layer, slot), start, n).items()}
        for layer in pools
    ]


# --------------------------------------------------------------------------
# the paged layout's gathered-view programs (decode_kernel "xla")


def _paged_views(pools: list[dict], table: torch.Tensor, index: torch.Tensor,
                 buf_len: int) -> list[dict]:
    """Per-layer dense-ordered views of every slot's blocks, shaped as the
    dense layout's buffers: gathered at nmax * B rows and sliced to
    ``buf_len``, the dense buffer length, so every attention reduction
    runs at the dense shape (the precondition of bit-identical answers).
    Stale and sink rows sit where the offset causal mask hides them."""
    return [
        {**{key: gather_block_views(pool[key], table, buf_len).contiguous()
            for key in kv_buffer_keys(pool)}, "index": index}
        for pool in pools
    ]


def _paged_scatter(pools: list[dict], views: list[dict], table: torch.Tensor,
                   index: torch.Tensor, s_q: int, block_tokens: int) -> None:
    """Write each slot's new view rows ``[index, index + s_q)`` back into
    its blocks, in storage layout (free slots land in the sink)."""
    n = table.shape[0]
    rids = block_row_ids(table, index, s_q, block_tokens).reshape(-1)
    pos = index.long()[:, None] + torch.arange(s_q, device=index.device)[None, :]
    batch = torch.arange(n, device=index.device)[:, None].expand_as(pos)
    for pool, view in zip(pools, views):
        for key in kv_buffer_keys(pool):
            rows = view[key][batch, pos]
            scatter_rows(pool[key], rids, rows.reshape(n * s_q, *rows.shape[2:]))


def _pool_step_paged(params, pools: list[dict], toks: torch.Tensor, table: torch.Tensor,
                     index: torch.Tensor, cfg: ModelConfig, block_tokens: int,
                     buf_len: int) -> torch.Tensor:
    """``_pool_step`` over the paged pool (the JAX ``_pool_step_paged`` and
    ``_pool_verify_paged``): gather views, the same dense step, scatter
    the new rows back. A rejected verify tail rolls back by table
    truncation on the host."""
    views = _paged_views(pools, table, index, buf_len)
    logits = _pool_step(params, views, toks, index, cfg)
    _paged_scatter(pools, views, table, index, toks.shape[1], block_tokens)
    return logits


def _slot_prefill_paged(params, pools: list[dict], row: torch.Tensor, prompt: torch.Tensor,
                        start: int, cfg: ModelConfig, chunk: int, block_tokens: int,
                        buf_len: int) -> torch.Tensor:
    """Chunked prefill of a (1, n) prompt suffix at positions ``start ..``
    into the slot whose (1, nmax) table ``row`` is given: gather the
    slot's blocks (a restored prefix included) into a dense view, run the
    cached prefill over it, scatter the written rows back. Returns the
    (1, V) next-token logits (both paged kernels' layouts)."""
    caches = [
        {**{key: gather_block_views(pool[key], row, buf_len) for key in kv_buffer_keys(pool)},
         "index": start}
        for pool in pools
    ]
    logits, caches = transformer_prefill(params, prompt, caches, start, cfg, chunk=chunk)
    n = prompt.shape[1]
    at = torch.full((1,), start, dtype=torch.long, device=row.device)
    rids = block_row_ids(row, at, n, block_tokens).reshape(-1)
    for pool, cache in zip(pools, caches):
        for key in kv_buffer_keys(pool):
            scatter_rows(pool[key], rids, cache[key][0, start : start + n])
    return logits


def version_value(tag: str | None) -> float:
    """The ``serve_weight_version`` gauge's number for a weight_version tag:
    its crc32 (exact in a float64, the same in every process), 0.0 when
    untagged."""
    return float(zlib.crc32(str(tag).encode())) if tag else 0.0


@dataclasses.dataclass
class _Pending:
    order: int
    req: dict
    attempts: int = 0          # admission retries taken
    not_before: float = 0.0    # perf_counter time before which admit() skips it
    t_enqueue: float = 0.0     # perf_counter time of submission
    deadline: float | None = None  # perf_counter time past which it expires
    # Tracing (None without a tracer): the request's root span and its open
    # lifecycle children; admit and prefill ride here only during an
    # admission attempt, so a retry or an admission error can close them.
    span_root: object = None
    span_queue: object = None
    span_admit: object = None
    span_prefill: object = None


@dataclasses.dataclass
class _Active:
    """Host-side state of one occupied slot."""

    order: int
    ids: list[int]             # BOS-led prompt token ids
    prompt_len: int
    pos: int                   # next position to consume (== written rows)
    cur: int                   # token to feed at the next step
    emitted: list[int]
    max_new: int
    sample: bool
    temperature: float
    top_k: int
    top_p: float
    seed: int
    spec: bool = False         # drafts for this request (speculate_k > 0)
    dstate: object = None      # the drafter's per-request state
    use_prefix: bool = False   # reads and feeds the prefix cache
    deadline: float | None = None  # perf_counter time past which it aborts
    prefix_hit: int = 0        # prompt positions restored from the cache
    wv: str | None = None      # the weight_version it was admitted under
    forwards: int = 0          # decode forwards it rode (prefill excluded)
    drafted: int = 0
    accepted: int = 0
    # The span clock (perf_counter): enqueue, admit, prefill done, first token.
    t_enqueue: float = 0.0
    t_admit: float = 0.0
    t_prefill: float | None = None
    t_first: float | None = None
    # Tracing spans (None without a tracer), taken over from the _Pending:
    # prefill closes when the last prompt token is in (the t_prefill edge),
    # decode opens there.
    span_root: object = None
    span_prefill: object = None
    span_decode: object = None

    @property
    def trace_id(self) -> str | None:
        return None if self.span_root is None else self.span_root.ctx.trace_id


class ContinuousScheduler:
    """Step-level continuous batching over ``num_slots`` KV slots.

    ``submit`` queues LM requests (dicts with ``prompt`` and optional
    ``max_new`` / ``temperature`` / ``top_k`` / ``top_p`` / ``seed`` /
    ``deadline_ms``, and ``cache_prefix`` / ``speculate``, which opt a
    request out of the prefix cache or out of drafting) and returns the
    request's order; ``cancel(order)`` asks for its cancellation;
    ``submit_done`` reserves an output position for an already-answered
    response; ``shutdown`` refuses later submissions. ``admit`` / ``step``
    / ``drain_ready`` are the streaming API the serve CLI drives; ``run``
    serves a fixed list to completion. Answers come back in submission
    order.

    ``pools`` is the per-layer KV storage: (num_slots, buf_len, H_kv, D)
    buffers on the dense layout, (num_blocks, block_tokens, H_kv, D) block
    pools on the paged ones (with ``alloc``, their ``KVPool``; None on the
    dense layout). ``forward`` is the step forward (``CapturedForward``).
    """

    def __init__(
        self,
        params,
        cfg: ModelConfig,
        tokenizer,
        *,
        num_slots: int = 8,
        max_total: int | None = None,
        prefill_chunk: int = 0,
        default_max_new: int = 64,
        speculate_k: int = 0,
        drafter=None,
        prefix_cache=None,
        max_backlog: int = 0,
        admission_retries: int = 2,
        retry_backoff_ms: float = 20.0,
        drafter_slow_ms: float = 0.0,
        breaker_threshold: int = 3,
        breaker_cooldown_s: float = 30.0,
        breaker_clock=time.monotonic,
        kv_layout: str = "dense",
        kv_block: int = 16,
        kv_pool_blocks: int = 0,
        decode_kernel: str = "xla",
        weight_version: str | None = None,
        span_tap=None,
        telemetry=None,
        slos=None,
        device="cuda",
    ):
        # The JAX scheduler's checks, in its order and with its messages.
        if not cfg.decoder_only:
            raise ValueError(
                "continuous batching serves decoder-only LM exports; seq2seq "
                "and fill-mask requests go through the grouped path"
            )
        if speculate_k < 0:
            raise ValueError(f"speculate_k must be >= 0, got {speculate_k}")
        if speculate_k and cfg.attention_window:
            raise ValueError(
                "speculative decoding cannot roll back a rolling-window "
                "cache (attention_window evicts slots that stay in-window "
                "after rollback); serve this config with speculate_k=0"
            )
        if prefix_cache is not None and cfg.attention_window:
            raise ValueError(
                "prefix cache cannot serve a rolling-window cache "
                "(attention_window evicts absolute-position rows on wrap); "
                "serve this config without --prefix_cache_mb"
            )
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout must be 'dense' or 'paged', got {kv_layout!r}")
        self.paged = kv_layout == "paged"
        if self.paged and cfg.attention_window:
            raise ValueError(
                "kv_layout='paged' cannot serve a rolling-window cache "
                "(attention_window evicts absolute-position rows on "
                "wrap); serve this config with kv_layout='dense'"
            )
        if self.paged and prefix_cache is not None:
            # Pool blocks and prefix-cache blocks are one unit: a
            # device-tier hit aliases trie-held pool blocks into a table.
            kv_block = prefix_cache.block_tokens
        if self.paged and kv_block < 1:
            raise ValueError(f"kv_block must be >= 1, got {kv_block}")
        if decode_kernel not in ("xla", "paged_flash"):
            raise ValueError(
                f"decode_kernel must be 'xla' or 'paged_flash', got {decode_kernel!r}"
            )
        if decode_kernel == "paged_flash":
            if not self.paged:
                raise ValueError(
                    "decode_kernel='paged_flash' reads the block-pool "
                    "buffers in place and needs kv_layout='paged'"
                )
            check_paged_flash_config(cfg)
        self.kv_layout, self.decode_kernel = kv_layout, decode_kernel
        self.device = resolve_device(device)
        self.cfg, self.tok = cfg, tokenizer
        # The stored form of every leaf (what a staged set must match) and
        # the serving tensors by flat name (what a flip writes into).
        self._stored = {k: (tuple(v.shape), v.dtype) for k, v in flatten(params).items()}
        self.params = compute_params(params, cfg, self.device, own=True)
        self._serving = flatten(self.params)
        self.weight_version = weight_version
        self._staged: tuple[dict | None, str] | None = None  # (set, or None = the previous; version)
        self._prev: dict[str, torch.Tensor] | None = None  # the resident previous set
        self._prev_version: str | None = None
        self._swap_events: deque[dict] = deque()
        self._span_tap = span_tap
        self.num_slots = num_slots
        self.prefill_chunk = prefill_chunk
        self.default_max_new = default_max_new
        self.max_total = max_total or cfg.max_position + 1
        self.speculate_k = speculate_k
        self.admission_retries = max(0, admission_retries)
        self.retry_backoff_ms = retry_backoff_ms
        self.drafter_slow_ms = drafter_slow_ms
        self.max_backlog = max(0, max_backlog)
        # k > 0 with no drafter given: the model-free n-gram drafter.
        self.drafter = drafter if drafter is not None or not speculate_k else NgramDrafter()
        self.prefix_cache = prefix_cache
        # speculate_k rows of slack: a verify step writes k + 1 positions
        # even from the slot's last budgeted position. Admission budgets
        # use max_total.
        self.buf_len = self.max_total + speculate_k
        self.alloc = None
        if self.paged:
            self.block_tokens = kv_block
            self.slot_blocks = -(-self.buf_len // kv_block)
            num_blocks = kv_pool_blocks or (1 + num_slots * self.slot_blocks)
            self.alloc = KVPool(num_blocks, kv_block, num_slots, self.slot_blocks)
            self.pools = [
                init_block_pool(
                    num_blocks, kv_block, cfg.kv_heads, cfg.head_dim,
                    cfg.compute_dtype, quantize=cfg.kv_cache_int8, device=self.device,
                )
                for _ in range(cfg.num_layers)
            ]
        else:
            self.block_tokens = prefix_cache.block_tokens if prefix_cache is not None else kv_block
            self.pools = [
                {k: v for k, v in layer.items() if k != "index"}
                for layer in init_decoder_caches(cfg, num_slots, self.buf_len, device=self.device)
            ]
        self.forward = CapturedForward(
            self.params, self.pools, cfg, self.block_tokens, self.device,
            program=self._step_program(),
        )
        if self.paged and prefix_cache is not None:
            # The device tier: retiring slots donate their prompt blocks by
            # reference, hits alias them back, and pool pressure spills the
            # least recently used ones to the host tier.
            prefix_cache.attach_device_pool(
                self.alloc, lambda bid: pool_read_block(self.pools, bid)
            )
        self._free = list(range(num_slots))
        self._active: dict[int, _Active] = {}
        self._queue: deque[_Pending] = deque()
        self._done: dict[int, dict] = {}
        self._next_order = 0
        self._emit_next = 0
        # Client threads (submit, cancel, shutdown) and the scheduler loop
        # share the queue, the order counter, the done map, the
        # cancellations and the closed flag under this lock; iterating a
        # deque is not atomic.
        self._intake_lock = threading.Lock()
        self._closed = False
        self._cancel_pending: dict[int, str] = {}
        # Queued requests that carry a deadline: 0 keeps the expiry scan
        # off the step path.
        self._queued_deadlines = 0
        # The breakers: K consecutive faults fail speculation / prefix
        # reuse open to the plain path; one half-open probe per cooldown.
        self.breaker_log: list[tuple[str, str, str]] = []
        self._brk_spec = CircuitBreaker(
            "speculative", threshold=breaker_threshold, cooldown_s=breaker_cooldown_s,
            clock=breaker_clock, on_transition=self._on_breaker_transition,
        )
        self._brk_prefix = CircuitBreaker(
            "prefix_cache", threshold=breaker_threshold, cooldown_s=breaker_cooldown_s,
            clock=breaker_clock, on_transition=self._on_breaker_transition,
        )
        self.breakers = {b.name: b for b in (self._brk_spec, self._brk_prefix)}
        self.stats = {
            "admitted": 0, "steps": 0, "max_active": 0, "kv_preempted": 0, "retries": 0,
            "deadline_expired": 0, "cancelled": 0, "backpressure": 0,
            "prompt_tokens": 0, "prefill_tokens": 0, "prefill_forwards": 0,
            "prefill_s": 0.0, "decode_s": 0.0, "generated_tokens": 0,
            # speculation: draft tokens fed to verify steps, and those kept
            "drafted": 0, "accepted": 0,
            # the prefix cache: prompt tokens restored (no forward), of
            # them aliased from the device tier, the rest written from the
            # host tier; pool blocks freed by spilling the device tier
            "prefix_hit_tokens": 0, "prefix_alias_tokens": 0,
            "host_restored_tokens": 0, "kv_spilled_blocks": 0,
            # the plain path an open breaker selects: verify steps that ran
            # with no drafter, admissions that skipped the prefix cache
            "spec_breaker_open_steps": 0, "prefix_breaker_open_admissions": 0,
            # live weights: flips landed, and their seconds on the host clock
            "swaps": 0, "swap_s": 0.0,
        }
        self._init_telemetry(telemetry, slos)

    def _init_telemetry(self, telemetry, slos) -> None:
        """The JAX scheduler's telemetry: host-side records at the step and
        admission boundaries the loop already has."""
        self._tel = telemetry
        self._tracer = getattr(telemetry, "tracer", None)
        self._profiler = getattr(telemetry, "profiler", None)
        # The programs this scheduler runs, under the JAX package's names.
        kind = ("_paged_flash" if self.decode_kernel == "paged_flash"
                else "_paged" if self.paged else "")
        self._prog_step = "serve.pool_step" + kind
        self._prog_verify = "serve.pool_verify" + kind
        self._prog_prefill = "serve.slot_prefill" + ("_paged" if self.paged else "")
        # The trace id of the request whose fault a breaker is recording,
        # set around admission, drafting and retirement on the scheduler
        # thread: serve.breaker events carry it.
        self._breaker_trace: str | None = None
        self._slo = None
        if telemetry is not None and slos:
            from transformer_tpu_torch.obs.slo import SLOEngine, parse_slo_spec

            specs = parse_slo_spec(slos) if isinstance(slos, str) else tuple(slos)
            if specs:
                self._slo = SLOEngine(specs, registry=telemetry.registry, emit=telemetry.emit)
        if telemetry is None:
            return
        reg = telemetry.registry
        self._m_slots_total = reg.gauge("serve_slots_total", "configured KV-cache slots")
        self._m_slots_total.set(self.num_slots)
        self._m_weight_version = reg.gauge(
            "serve_weight_version",
            "crc32 of the serving weight_version tag (0 = untagged); flips exactly at the "
            "step-boundary weight swap")
        self._m_weight_version.set(version_value(self.weight_version))
        self._m_active = reg.gauge("serve_slots_active", "slots occupied by in-flight requests")
        self._m_backlog = reg.gauge("serve_backlog", "submitted-but-not-admitted requests")
        self._m_ready = reg.gauge("serve_ready", "completed responses awaiting drain")
        self._m_requests = reg.counter("serve_requests_total", "requests submitted (incl. errors)")
        self._m_admissions = reg.counter("serve_admissions_total", "requests admitted into a slot")
        self._m_retirements = reg.counter("serve_retirements_total",
                                          "requests finished and retired")
        self._m_errors = reg.counter("serve_errors_total", "requests answered with an error")
        self._m_steps = reg.counter("serve_steps_total", "pool decode steps executed")
        self._m_tokens = reg.counter("serve_generated_tokens_total", "tokens emitted to clients")
        self._m_queue_s = reg.histogram("serve_queue_seconds", "submit -> slot admission")
        self._m_prefill_s = reg.histogram("serve_prefill_seconds",
                                          "admission -> prompt ingested")
        self._m_ttft_s = reg.histogram("serve_ttft_seconds", "submit -> first generated token")
        self._m_total_s = reg.histogram("serve_request_seconds", "submit -> response complete")
        self._m_step_s = reg.histogram(
            "serve_step_seconds",
            "one pool step (all slots): row building, the forward and the picks' readback "
            "(its device synchronize)")
        if self.speculate_k:
            self._m_spec_drafted = reg.counter("serve_spec_drafted_total",
                                               "draft tokens proposed to verify steps")
            self._m_spec_accepted = reg.counter("serve_spec_accepted_total",
                                                "draft tokens the target model accepted")
            self._m_spec_rejected = reg.counter(
                "serve_spec_rejected_total", "draft tokens rejected or wasted past a mismatch")
        if self.prefix_cache is not None:
            self._m_prefix_hit = reg.counter(
                "serve_prefix_hit_tokens_total",
                "prompt tokens restored from the prefix cache (no model forward)")
            self._m_prefix_evicted = reg.counter(
                "serve_prefix_evicted_blocks_total",
                "prefix-cache KV blocks evicted under the byte budget")
        if self.paged:
            self._m_pool_used = reg.gauge(
                "serve_kv_pool_used_blocks",
                "paged KV pool blocks referenced by live slots or the device-resident "
                "prefix tier")
            self._m_pool_free = reg.gauge("serve_kv_pool_free_blocks",
                                          "paged KV pool blocks on the free list")
            self._m_pool_used.set(self.alloc.used_blocks)
            self._m_pool_free.set(self.alloc.free_blocks)
            if self.prefix_cache is not None:
                self._m_alias_tokens = reg.counter(
                    "serve_prefix_alias_tokens_total",
                    "prompt tokens served by device-side block-table aliasing (no copy); "
                    "a subset of serve_prefix_hit_tokens_total")
        self._m_deadline = reg.counter("serve_deadline_expired_total",
                                       "requests answered with a deadline error")
        self._m_cancelled = reg.counter("serve_cancelled_total",
                                        "requests cancelled by the client")
        self._m_backpressure = reg.counter("serve_backpressure_total",
                                           "requests refused at submit (max_backlog)")
        self._m_retries = reg.counter("serve_admission_retries_total",
                                      "transient admission faults retried with backoff")

    def _step_program(self):
        """The layout's step forward on device tensors, ``(toks, table,
        index) -> (N, S_q, V)`` logits (table None on the dense layout);
        None selects ``CapturedForward``'s default, the kernels."""
        if self.decode_kernel == "paged_flash":
            return None
        if self.paged:
            return lambda toks, table, index: _pool_step_paged(
                self.params, self.pools, toks, table, index, self.cfg,
                self.block_tokens, self.buf_len,
            )
        return lambda toks, table, index: _pool_step(self.params, self.pools, toks, index, self.cfg)

    def _on_breaker_transition(self, name: str, old: str, new: str) -> None:
        """Log the transition; with telemetry, a gauge (0 closed, 1
        half-open, 2 open) and a ``serve.breaker`` event carrying the trace
        id of the request whose fault moved it (when tracing)."""
        self.breaker_log.append((name, old, new))
        if self._tel is None:
            return
        self._tel.registry.gauge(
            f"serve_breaker_state_{name}", "circuit-breaker state: 0 closed, 1 half-open, 2 open",
        ).set(BREAKER_STATE_VALUE[new])
        extra = {} if self._breaker_trace is None else {"trace": self._breaker_trace}
        self._tel.emit("serve.breaker", name=name, state=new, previous=old, **extra)

    # ---- tracing and the answer funnel ---------------------------------------

    def _traced(self, name: str, parent, **attrs):
        """A span with an explicit parent (a request's spans join its own
        tree, never the current step's), or a no-op without a tracer."""
        if self._tracer is None:
            return contextlib.nullcontext()
        return self._tracer.span(name, parent=parent, **attrs)

    def _record_request(self, span: dict, root=None) -> None:
        """The one answer-boundary funnel: the span dict goes to the SLO
        engine, the span tap and the ``serve.request`` event alike, stamped
        with the request's trace id."""
        if root is not None:
            span.setdefault("trace", root.ctx.trace_id)
        if self._slo is not None:
            self._slo.record(dict(span))
        if self._span_tap is not None:
            self._span_tap(dict(span))
        if self._tel is not None:
            self._tel.emit("serve.request", **span)

    @staticmethod
    def _end_spans(obj, attrs: tuple[str, ...], **fields) -> None:
        """Close the still-open spans named by ``attrs`` on a _Pending or an
        _Active."""
        for attr in attrs:
            sp = getattr(obj, attr, None)
            if sp is not None:
                sp.end(**fields)
                setattr(obj, attr, None)

    def _trace_prefill_done(self, st: _Active) -> None:
        """The whole prompt is in: close the prefill span, open decode."""
        if st.span_prefill is not None:
            st.span_prefill.end(prompt_tokens=st.prompt_len, prefix_hit_tokens=st.prefix_hit)
            st.span_prefill = None
            st.span_decode = self._tracer.start_span(
                "serve.decode", parent=st.span_root, lane=st.span_root.lane
            )

    def _gauges(self) -> None:
        """The step boundary's gauges and periodic sinks (telemetry only)."""
        self._m_active.set(len(self._active))
        self._m_backlog.set(len(self._queue))
        self._m_ready.set(len(self._done))
        if self.paged:
            self._m_pool_used.set(self.alloc.used_blocks)
            self._m_pool_free.set(self.alloc.free_blocks)
        self._tel.maybe_flush()
        if self._slo is not None:
            self._slo.maybe_evaluate()

    def warm_up(self) -> None:
        """Run the step forward once with every slot free, so that on the
        card its graph is captured before traffic (the fleet's replica
        does this before it reports ready). Free slots write PAD at
        position 0 of their own rows (dense) or into the sink block
        (paged), which admission overwrites."""
        if self._active:
            raise RuntimeError("warm_up runs before any request is admitted")
        width = self.speculate_k + 1
        self.forward(
            np.full((self.num_slots, width), PAD_ID, np.int64), self._table(),
            np.zeros((self.num_slots,), np.int32),
        )

    # ---- live weights: the two-version param slot ---------------------------

    def stored_template(self):
        """The serving tree in its stored form, as shape-and-dtype-only
        (``meta``) tensors: what a checkpoint must match to be staged."""
        return unflatten({
            k: torch.empty(shape, dtype=dtype, device="meta")
            for k, (shape, dtype) in self._stored.items()
        })

    def stage_params(self, params, version: str) -> None:
        """Stage a new weight set for the next drained step boundary. It
        must be a twin of the serving one: the same flat names, per-leaf
        shapes and stored dtypes. Any mismatch raises here, before
        anything is scheduled, and serving is untouched. The set is cast
        to the compute dtype on the device now, on this thread's stream
        (the one the step graphs replay on), off the serving tensors.
        While a stage is pending, admission pauses: requests in flight
        finish on their admission-time weights."""
        new = {k: as_tensor(v) for k, v in flatten(params).items()}
        if sorted(new) != sorted(self._stored):
            raise ValueError(
                f"staged weights for version {version!r} have a different "
                "pytree structure than the serving params — a swap would "
                "recompile (or crash) every program; refuse it"
            )
        mismatched = []
        for key, (shape, dtype) in self._stored.items():
            t = new[key]
            if tuple(t.shape) != shape or t.dtype != dtype:
                mismatched.append(
                    f"{key}: {tuple(t.shape)}/{dtype_name(t.dtype)} != "
                    f"{shape}/{dtype_name(dtype)}"
                )
        if mismatched:
            raise ValueError(
                f"staged weights for version {version!r} mismatch the "
                f"serving spec on {len(mismatched)} leaf/leaves "
                f"({'; '.join(mismatched[:3])}) — refused before any swap "
                "was scheduled"
            )
        staged = flatten(compute_params(unflatten(new), self.cfg, self.device))
        self._staged = (staged, str(version))

    def stage_rollback(self) -> str:
        """Stage the resident previous weights (the second buffer a flip
        left behind); the flip then exchanges the two sets in place.
        Returns the version being rolled back to; raises when no flip
        ever landed."""
        if self._prev is None:
            raise ValueError(
                "no resident previous weights to roll back to (no swap has "
                "completed on this scheduler)"
            )
        self._staged = (None, self._prev_version)
        return self._prev_version

    @property
    def swap_pending(self) -> bool:
        return self._staged is not None

    def consume_swap_events(self) -> list[dict]:
        """Drain the flips landed or aborted since the last call (the
        replica worker forwards them to the router as ``upgraded``)."""
        out = list(self._swap_events)
        self._swap_events.clear()
        return out

    def _maybe_swap(self) -> None:
        """The step-boundary flip, once no slot is occupied: the serving
        values go to the resident previous buffer and the staged values
        into the serving tensors, by ``copy_`` (a rollback exchanges the
        two sets leaf by leaf). Every tensor keeps its storage, so the
        captured graphs replay the new weights. The ``ckpt.swap`` fault
        point aborts the flip with the old weights still serving."""
        if self._staged is None or self._active:
            return
        staged, version = self._staged
        self._staged = None
        try:
            maybe_fail("ckpt.swap")
        except OSError as e:
            self._swap_events.append({
                "ok": False, "version": version, "error": f"{type(e).__name__}: {e}",
            })
            return
        t0 = time.perf_counter()
        with torch.no_grad():
            if self._prev is None:
                self._prev = {k: torch.empty_like(t) for k, t in self._serving.items()}
            for key, t in self._serving.items():
                prev = self._prev[key]
                if staged is None:
                    held = t.clone()
                    t.copy_(prev)
                    prev.copy_(held)
                else:
                    prev.copy_(t)
                    t.copy_(staged[key])
        synchronize(self.device)
        self.stats["swaps"] += 1
        self.stats["swap_s"] += time.perf_counter() - t0
        self._prev_version, self.weight_version = self.weight_version, version
        self._swap_events.append({"ok": True, "version": version})
        if self._tel is not None:
            self._m_weight_version.set(version_value(version))

    # ---- intake ------------------------------------------------------------

    def submit(self, req: dict) -> int:
        """Queue ``req``; returns its order (its answer's output position).
        Past ``max_backlog`` queued requests it answers ``backpressure`` at
        once instead, and after ``shutdown`` it answers ``routing``. A
        ``deadline_ms`` that does not parse is left to admission, which
        answers it as a validation error."""
        now = time.perf_counter()
        # The root span, under an incoming W3C "traceparent" when the
        # request has one (the fleet's router sends it); a malformed header
        # starts a fresh trace.
        root = queue_span = None
        if self._tracer is not None:
            from transformer_tpu_torch.obs.trace import SpanContext

            root = self._tracer.start_span(
                "serve.request", lane="intake",
                parent=SpanContext.from_traceparent(req.get("traceparent")),
            )
            queue_span = self._tracer.start_span("serve.queue", parent=root, lane="intake")
        refused, refused_code = None, "backpressure"
        with self._intake_lock:
            order = self._next_order
            self._next_order += 1
            if self._closed:
                refused = ("scheduler is shut down and accepts no new requests; "
                           "resubmit to a live replica")
                refused_code = "routing"
                self._done[order] = error_answer(refused_code, refused)
            elif self.max_backlog and len(self._queue) >= self.max_backlog:
                self.stats["backpressure"] += 1
                refused = (f"admission queue is full ({self.max_backlog} requests); "
                           "retry after a backoff")
                self._done[order] = error_answer("backpressure", refused)
            else:
                deadline = None
                try:
                    d = req.get("deadline_ms")
                    if d is not None:
                        deadline = now + float(d) / 1e3
                except (TypeError, ValueError):
                    pass  # _start parses it again and answers the validation error
                self._queue.append(_Pending(order=order, req=req, t_enqueue=now,
                                            deadline=deadline, span_root=root,
                                            span_queue=queue_span))
                if deadline is not None:
                    self._queued_deadlines += 1
        if refused is not None and root is not None:
            queue_span.end(error=refused)
            root.end(order=order, error=refused, code=refused_code)
        if self._tel is not None:
            self._m_requests.inc()
            if refused is not None:
                if refused_code == "backpressure":
                    self._m_backpressure.inc()
                self._m_errors.inc()
                self._record_request({"order": order, "total_s": 0.0, "error": refused,
                                      "code": refused_code}, root=root)
        return order

    def submit_done(self, resp: dict) -> int:
        root = None
        if self._tracer is not None:
            # A pre-answered line still gets a (leaf) span: every output
            # order is accounted for in the trace.
            root = self._tracer.start_span("serve.request", lane="intake")
        with self._intake_lock:
            order = self._next_order
            self._next_order += 1
            self._done[order] = resp
        extra = {}
        if "error" in resp:
            extra["error"] = resp["error"]
            if "code" in resp:
                extra["code"] = resp["code"]
        if root is not None:
            root.end(order=order, **extra)
        if self._tel is not None:
            self._m_requests.inc()
            if "error" in resp:
                self._m_errors.inc()
            self._record_request({"order": order, "total_s": 0.0, **extra}, root=root)
        return order

    def shutdown(self) -> None:
        """Accept no new work: a later ``submit`` answers ``routing`` at its
        reserved order instead of queueing into a loop nobody drives.
        Everything already queued or in flight is served as before."""
        with self._intake_lock:
            self._closed = True

    def cancel(self, order: int, message: str = "cancelled by client") -> bool:
        """Ask for the cancellation of a queued or in-flight request (any
        thread). It is executed by the scheduler loop at the next step
        boundary: the queue entry is dropped or the slot freed, and a
        ``cancelled`` error answers at the request's position. Returns
        False when ``order`` is unknown, already answered or already being
        cancelled; a request that completes first answers normally."""
        with self._intake_lock:
            if (
                order in self._done
                or order >= self._next_order
                or order < self._emit_next
                or order in self._cancel_pending
            ):
                return False
            self._cancel_pending[order] = message
        return True

    def _answer_cancelled(self, p: _Pending, message: str) -> None:
        """Answer a cancellation caught before admission."""
        self.stats["cancelled"] += 1
        self._done[p.order] = error_answer("cancelled", message)
        root = p.span_root
        self._end_spans(p, ("span_queue", "span_admit", "span_prefill"))
        self._end_spans(p, ("span_root",), order=p.order, error=message, code="cancelled")
        if self._tel is not None:
            now = time.perf_counter()
            self._m_cancelled.inc()
            self._m_errors.inc()
            span = {"order": p.order, "error": message, "code": "cancelled"}
            if p.t_enqueue:
                span["queue_s"] = round(now - p.t_enqueue, 6)
                span["total_s"] = round(now - p.t_enqueue, 6)
            self._record_request(span, root=root)

    def _answer_expired(self, p: _Pending, now: float) -> None:
        """A queued request's deadline passed before a slot freed."""
        self.stats["deadline_expired"] += 1
        self._done[p.order] = error_answer(
            "deadline",
            f"deadline_ms elapsed after {round((now - p.t_enqueue) * 1e3)}ms "
            "in the admission queue",
        )
        root = p.span_root
        self._end_spans(p, ("span_queue", "span_admit", "span_prefill"))
        self._end_spans(p, ("span_root",), order=p.order, error=self._done[p.order]["error"],
                        code="deadline")
        if self._tel is not None:
            self._m_deadline.inc()
            self._m_errors.inc()
            self._record_request({
                "order": p.order, "queue_s": round(now - p.t_enqueue, 6),
                "total_s": round(now - p.t_enqueue, 6),
                "error": self._done[p.order]["error"], "code": "deadline",
            }, root=root)

    def _answer_admission_error(self, p: _Pending, e: BaseException, now: float,
                                code: str | None = None) -> None:
        """An admission that failed for good answers its error alone."""
        code = code or classify_error(e)
        self._done[p.order] = error_answer(code, f"{type(e).__name__}: {e}")
        root = p.span_root
        self._end_spans(p, ("span_queue", "span_admit", "span_prefill"), error=type(e).__name__)
        self._end_spans(p, ("span_root",), order=p.order, error=self._done[p.order]["error"],
                        code=code)
        if self._tel is not None:
            t_enq = p.t_enqueue
            self._m_errors.inc()
            self._record_request({
                "order": p.order,
                "queue_s": round(now - t_enq, 6) if t_enq else 0.0,
                "total_s": round(now - t_enq, 6) if t_enq else 0.0,
                "error": self._done[p.order]["error"], "code": code,
            }, root=root)

    def _expire(self, now: float) -> None:
        """The sweep at a step boundary: queued requests past their
        deadline answer without a slot, registered cancellations of queued
        requests answer, and in-flight ones (cancelled or past their
        deadline) are aborted."""
        expired_q: list[_Pending] = []
        if self._queued_deadlines:
            with self._intake_lock:
                expired_q = [p for p in self._queue
                             if p.deadline is not None and now >= p.deadline]
                for p in expired_q:
                    self._queue.remove(p)
                    self._queued_deadlines -= 1
        for p in expired_q:
            self._answer_expired(p, now)
        pending: dict[int, str] = {}
        cancelled_q: list[_Pending] = []
        if self._cancel_pending:
            with self._intake_lock:
                pending = dict(self._cancel_pending)
                cancelled_q = [p for p in self._queue if p.order in pending]
                for p in cancelled_q:
                    self._queue.remove(p)
                    if p.deadline is not None:
                        self._queued_deadlines -= 1
        for p in cancelled_q:
            self._answer_cancelled(p, pending[p.order])
        for slot, st in list(self._active.items()):
            if st.order in pending:
                self._abort(slot, st, "cancelled", pending[st.order])
            elif st.deadline is not None and now >= st.deadline:
                self._abort(
                    slot, st, "deadline",
                    f"deadline_ms elapsed after {len(st.emitted)} of {st.max_new} tokens",
                )
        if pending:
            # Drop the registrations that are answered (here, or normally
            # before the sweep: the benign race cancel() describes).
            with self._intake_lock:
                for order in pending:
                    if order in self._done or order < self._emit_next:
                        self._cancel_pending.pop(order, None)

    def _abort(self, slot: int, st: _Active, code: str, message: str) -> None:
        """Free an occupied slot without retiring it normally (deadline,
        cancellation, or the paged pool's ``resource`` preemption): its
        blocks go back to the pool and its table row to the sink, so later
        steps write nothing of it; nothing is donated to the prefix cache
        (admission released its hit already); the answer is a ``code``
        error carrying the emitted tokens as ``partial``."""
        if code == "deadline":
            self.stats["deadline_expired"] += 1
        elif code == "cancelled":
            self.stats["cancelled"] += 1
        self._retire(slot, st, error_answer(code, message))
        root = st.span_root
        self._end_spans(st, ("span_prefill", "span_decode"))
        self._end_spans(st, ("span_root",), order=st.order, error=message, code=code,
                        new_tokens=len(st.emitted))
        if self._tel is not None:
            now = time.perf_counter()
            if code == "deadline":
                self._m_deadline.inc()
            elif code == "cancelled":
                self._m_cancelled.inc()
            self._m_errors.inc()
            span = {
                "order": st.order, "prompt_tokens": st.prompt_len,
                "new_tokens": len(st.emitted),
                "queue_s": round(st.t_admit - st.t_enqueue, 6),
                "total_s": round(now - st.t_enqueue, 6),
                "error": message, "code": code,
            }
            if st.wv is not None:
                span["weight_version"] = st.wv
            self._record_request(span, root=root)

    @property
    def busy(self) -> bool:
        return bool(self._queue or self._active)

    @property
    def backlog(self) -> int:
        return len(self._queue)

    @property
    def active_count(self) -> int:
        return len(self._active)

    @property
    def ready_count(self) -> int:
        return len(self._done)

    @property
    def has_ready(self) -> bool:
        return self._emit_next in self._done

    # ---- admission ---------------------------------------------------------

    def admit(self) -> None:
        """Fill free slots from the queue. A request that fails validation,
        encoding or allocation answers with its error alone; it never
        enters the pool. A ``TransientError`` (the paged pool exhausted
        after the spill, an injected fault) is retried up to
        ``admission_retries`` times, each after a jittered ``backoff_ms``;
        entries still waiting out their backoff are skipped this tick and
        go back to the front of the queue. With no slot occupied and every
        queued request waiting, it sleeps until the first is due (at most
        50 ms), so that drive loops do not spin. While a weight stage is pending
        nothing is admitted (the quiesce before the flip)."""
        if self._staged is not None:
            return
        now = time.perf_counter()
        deferred: list[_Pending] = []
        while self._free:
            with self._intake_lock:
                if not self._queue:
                    break
                p = self._queue.popleft()
                if p.deadline is not None:
                    self._queued_deadlines -= 1
            if p.not_before > now:
                deferred.append(p)
                continue
            if p.deadline is not None and now >= p.deadline:
                self._answer_expired(p, now)
                continue
            with self._intake_lock:
                cancel_msg = self._cancel_pending.pop(p.order, None)
            if cancel_msg is not None:
                # Cancelled before admission: no prefill, no slot.
                self._answer_cancelled(p, cancel_msg)
                continue
            try:
                self._start(p)
            except TransientError as e:
                if p.attempts < self.admission_retries:
                    p.attempts += 1
                    wait = backoff_ms(self.retry_backoff_ms, p.attempts - 1, p.order)
                    p.not_before = now + wait / 1e3
                    deferred.append(p)
                    self.stats["retries"] += 1
                    # The failed attempt's spans close with the fault; a
                    # fresh queue span covers the backoff wait.
                    self._end_spans(p, ("span_admit", "span_prefill"),
                                    error=f"{type(e).__name__}: {e}", retried=True)
                    if self._tracer is not None and p.span_queue is None:
                        p.span_queue = self._tracer.start_span(
                            "serve.queue", parent=p.span_root, lane="intake", attempt=p.attempts,
                        )
                    if self._tel is not None:
                        self._m_retries.inc()
                        retry_ev = {"order": p.order, "attempt": p.attempts,
                                    "backoff_ms": round(wait, 3),
                                    "error": f"{type(e).__name__}: {e}"}
                        if p.span_root is not None:
                            retry_ev["trace"] = p.span_root.ctx.trace_id
                        self._tel.emit("serve.retry", **retry_ev)
                    continue
                self._answer_admission_error(p, e, now, "transient")
            except Exception as e:  # noqa: BLE001 — per-request isolation: any admission failure answers this request alone
                self._answer_admission_error(p, e, now)
        with self._intake_lock:
            self._queue.extendleft(reversed(deferred))
            self._queued_deadlines += sum(1 for p in deferred if p.deadline is not None)
            idle = not self._active and deferred and len(deferred) == len(self._queue)
        if idle:
            time.sleep(min(min(p.not_before for p in deferred) - now, 0.05))

    def _start(self, p: _Pending) -> None:
        """Admit ``p`` (``_start_inner``); the breaker's fault attribution
        ends with the admission."""
        try:
            self._start_inner(p)
        finally:
            self._breaker_trace = None

    def _start_inner(self, p: _Pending) -> None:
        maybe_fail("serve.prefill")  # the fault plane's admission point
        if self._tracer is not None:
            # The queue phase ends here (a retry opens it again); from
            # validation to the first pick is the admit span, and a fault
            # from here on feeds the breakers under this request's name.
            self._end_spans(p, ("span_queue",))
            p.span_admit = self._tracer.start_span("serve.admit", parent=p.span_root,
                                                   lane="intake")
            self._breaker_trace = p.span_root.ctx.trace_id
        req, cfg = p.req, self.cfg
        ids = [self.tok.bos_id, *self.tok.encode(str(req["prompt"]))]
        L = len(ids)
        if L >= cfg.max_position:
            raise ValueError(
                f"a prompt encodes to {L} tokens but the model's "
                f"max_position is {cfg.max_position}; shorten the prompt"
            )
        max_new = int(req.get("max_new", self.default_max_new))
        max_new = min(max_new, cfg.max_position - L)
        if L + 1 >= self.max_total:
            raise ValueError(
                f"a prompt encodes to {L} tokens but the slot budget "
                f"(serve_max_total) is {self.max_total}; shorten the prompt "
                "or raise --serve_max_total"
            )
        max_new = min(max_new, self.max_total - 1 - L)
        deadline = None
        if req.get("deadline_ms") is not None:
            # float() raising ("soon") answers a validation error for this
            # request alone.
            deadline = p.t_enqueue + float(req["deadline_ms"]) / 1e3
        temperature = float(req.get("temperature", 0.0))
        sample = temperature > 0.0
        top_k = int(req.get("top_k", 0)) if sample else 0
        top_p = float(req.get("top_p", 1.0)) if sample else 1.0
        seed = int(req.get("seed", 0)) if sample else 0
        if sample and top_k > cfg.target_vocab_size:
            raise ValueError(
                f"top_k={top_k} exceeds the vocab size {cfg.target_vocab_size}"
            )
        if req.get("cache_prefix") and cfg.attention_window:
            raise ValueError(
                "cache_prefix=true cannot be honored: this server runs a "
                "rolling-window cache (attention_window), which the prefix "
                "cache refuses — resend with cache_prefix=false or serve "
                "without attention_window"
            )
        wants_prefix = self.prefix_cache is not None and bool(req.get("cache_prefix", True))
        # While the prefix breaker is open, opted-in requests neither read
        # nor feed the cache: the plain full prefill (same answers).
        use_prefix = wants_prefix and self._brk_prefix.allow()
        if wants_prefix and not use_prefix:
            self.stats["prefix_breaker_open_admissions"] += 1
        hit, m = None, 0
        prefix_ok = True  # no cache fault during this admission
        if use_prefix:
            # Match the prompt less its last token: at least one token goes
            # through the forward, whose logits make the first pick.
            try:
                with self._traced("prefix.match", p.span_admit, lane="intake") as msp:
                    hit = self.prefix_cache.match(ids[: L - 1])
                    m = hit.tokens
                    if msp is not None:
                        msp.set(hit_tokens=m)
            except Exception:  # noqa: BLE001 — any cache failure (corrupt block, injected fault) feeds the breaker; this admission prefills in full
                self._brk_prefix.record_failure()
                prefix_ok = False
                hit, m = None, 0
        n_suffix = prefill_len_for(L - m, self.prefill_chunk)
        n = m + n_suffix
        slot = self._free.pop()
        t_admit = time.perf_counter()
        if self._tracer is not None:
            # The slot is known: the rest of the request renders on its lane.
            p.span_root.lane = f"slot{slot}"
            p.span_prefill = self._tracer.start_span("serve.prefill", parent=p.span_root,
                                                     lane=f"slot{slot}")
        aliased = 0
        try:
            if m:
                try:
                    with self._traced("prefix.restore", p.span_prefill, lane=f"slot{slot}",
                                      tokens=m):
                        if self.paged:
                            aliased = self._restore(slot, hit)
                        else:
                            _slot_restore(self.pools, slot, hit.stacked(self.buf_len))
                except TransientError:
                    raise
                except Exception as e:  # noqa: BLE001 — a failed restore falls back to full prefill (the prefill resets the slot's position), feeding the breaker
                    if isinstance(e, KVPoolExhausted):
                        raise TransientError(str(e)) from e  # pool pressure: retryable
                    self._brk_prefix.record_failure()
                    prefix_ok = False
                    hit.release()
                    hit, m, aliased = None, 0, 0
                    if self.paged:
                        self.alloc.free_slot(slot)  # drop partially aliased entries
                    n_suffix = prefill_len_for(L, self.prefill_chunk)
                    n = n_suffix
            if self.paged:
                try:
                    self._alloc_call(lambda: self.alloc.ensure(slot, n))
                    self._cow(slot, m, n)
                except KVPoolExhausted as e:  # pool pressure: retryable
                    raise TransientError(str(e)) from e
            t0 = time.perf_counter()
            logits = self._prefill(slot, ids[m:n], m)
            synchronize(self.device)
            prefill_s = time.perf_counter() - t0
            self.stats["prefill_s"] += prefill_s
        except BaseException:
            if self.paged:
                self.alloc.free_slot(slot)
            self._free.append(slot)
            raise
        finally:
            if hit is not None:
                hit.release()
        if self._profiler is not None:
            # The prefill up to its synchronize; tokens = the suffix fed
            # through the forward (the restored prefix excluded).
            self._profiler.record(self._prog_prefill, prefill_s, tokens=n_suffix)
        if use_prefix and prefix_ok:
            # The cache served this admission (hit or clean miss): a
            # half-open probe closes the breaker here.
            self._brk_prefix.record_success()
        chunk = self.prefill_chunk
        self.stats["prompt_tokens"] += L
        self.stats["prefill_tokens"] += n - m
        self.stats["prefill_forwards"] += -(-n_suffix // chunk) if chunk > 0 else 1
        self.stats["prefix_hit_tokens"] += m
        if self.paged:
            self.stats["prefix_alias_tokens"] += aliased
            self.stats["host_restored_tokens"] += m - aliased
        if m and self._tel is not None and self.prefix_cache is not None:
            self._m_prefix_hit.inc(m)
            if aliased:
                self._m_alias_tokens.inc(aliased)
        spec = bool(self.speculate_k) and bool(req.get("speculate", True))
        st = _Active(
            order=p.order, ids=ids, prompt_len=L, pos=n, cur=PAD_ID,
            emitted=[], max_new=max_new, sample=sample,
            temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
            spec=spec, dstate=self.drafter.start(ids) if spec else None,
            use_prefix=use_prefix, deadline=deadline, prefix_hit=m, wv=self.weight_version,
            t_enqueue=p.t_enqueue or t_admit, t_admit=t_admit, t_prefill=time.perf_counter(),
            # The spans pass from the _Pending to the slot's state.
            span_root=p.span_root, span_prefill=p.span_prefill,
        )
        p.span_root = p.span_prefill = None
        self._active[slot] = st
        self.stats["admitted"] += 1
        self.stats["max_active"] = max(self.stats["max_active"], len(self._active))
        self._end_spans(p, ("span_admit",), slot=slot, prefix_hit_tokens=st.prefix_hit)
        if deadline is not None and time.perf_counter() >= deadline:
            # The prefill alone spent the budget: answer now rather than
            # decode tokens the client has given up on.
            if self._tel is not None:
                self._m_admissions.inc()
            self._abort(slot, st, "deadline", "deadline_ms elapsed during prefill")
            return
        if n < L:
            st.cur = ids[n]  # the prompt tail feeds through the steps
        else:
            tokv = self._pick(logits, [st], [n - 1])[0]
            if self._tracer is not None:
                self._trace_prefill_done(st)  # the whole prompt is in
            self._consume_pick(slot, st, tokv)
        if self._tel is not None:
            self._m_admissions.inc()

    def _prefill(self, slot: int, prompt: list[int], start: int) -> torch.Tensor:
        """Chunked prefill of ``prompt`` at positions ``start ..`` into
        ``slot`` (the layout's program). Returns the (1, V) logits."""
        toks = torch.tensor([prompt], dtype=torch.long, device=self.device)
        with torch.no_grad():
            if not self.paged:
                return _slot_prefill(self.params, self.pools, slot, toks, start, self.cfg,
                                     self.prefill_chunk)
            row = self.alloc.table_device(self.device)[slot : slot + 1]
            return _slot_prefill_paged(self.params, self.pools, row, toks, start, self.cfg,
                                       self.prefill_chunk, self.block_tokens, self.buf_len)

    # ---- paged KV and the prefix cache --------------------------------------

    def _alloc_call(self, fn):
        """Run an allocator mutation with one spill-and-retry rung: on pool
        exhaustion the prefix cache's device tier releases its least
        recently used blocks (spilling their data to the host tier), then
        ``fn`` runs again. Re-raises ``KVPoolExhausted`` when live slots
        hold the whole pool."""
        try:
            return fn()
        except KVPoolExhausted:
            if self.prefix_cache is None:
                raise
            freed = self.prefix_cache.release_device_blocks(max(1, self.slot_blocks))
            self.stats["kv_spilled_blocks"] += freed
            if not freed:
                raise
            return fn()

    def _cow(self, slot: int, start: int, end: int) -> None:
        """Copy-on-write before writing positions ``[start, end)``: a table
        block shared with the device tier or another slot is split (a
        fresh block takes its entry, its contents copied on the device)."""
        pairs = self._alloc_call(lambda: self.alloc.make_writable(slot, start, end))
        pool_copy_blocks(self.pools, [s for s, _ in pairs], [d for _, d in pairs])

    def _restore(self, slot: int, hit) -> int:
        """Restore a matched prefix into ``slot``'s table: device-tier
        nodes alias their pool block (no copy, no forward); host-tier nodes
        take a fresh block, all written in one batch, which the device tier
        then adopts so the next hit aliases. Returns the aliased tokens."""
        aliased = 0
        host_bids, host_payload, adopt = [], [], []
        for node, bid, blocks in hit.paged_plan():
            if bid is not None:
                self._alloc_call(lambda b=bid: self.alloc.extend(slot, bid=b))
                aliased += self.block_tokens
            else:
                _, new_bid = self._alloc_call(lambda: self.alloc.extend(slot))
                host_bids.append(new_bid)
                host_payload.append(blocks)
                adopt.append((node, new_bid))
        pool_write_blocks(self.pools, host_bids, host_payload)
        for node, bid in adopt:
            self.prefix_cache.adopt_device(node, bid)
        return aliased

    def _prepare(self, width: int) -> None:
        """Before a paged step: blocks covering every occupied slot's
        writes ``[pos, pos + width)``, split where shared. Exhaustion
        (after the spill) preempts the slot with a ``resource`` answer
        carrying its partial continuation."""
        for slot, st in list(self._active.items()):
            try:
                self._alloc_call(lambda: self.alloc.ensure(slot, st.pos + width))
                self._cow(slot, st.pos, st.pos + width)
            except KVPoolExhausted as e:
                self.stats["kv_preempted"] += 1
                self._abort(
                    slot, st, "resource",
                    f"kv pool exhausted after {len(st.emitted)} of {st.max_new} tokens: {e}",
                )

    # ---- stepping ----------------------------------------------------------

    def _pick(self, logits: torch.Tensor, states: list[_Active], positions: list[int]):
        """Next tokens for ``logits`` rows (one per state): greedy rows in one
        argmax; each sampled row with a generator keyed (seed, position),
        so a request's draws do not depend on its neighbours."""
        picks = sample_token(logits).tolist()
        for i, (st, position) in enumerate(zip(states, positions)):
            if st.sample:
                picks[i] = verify_row_picks(
                    logits[i : i + 1], st.seed, position, st.temperature,
                    sample=True, top_k=st.top_k, top_p=st.top_p,
                )[0]
        return picks

    def step(self) -> None:
        """Advance every occupied slot with ONE pooled forward: one token
        on the plain path, up to ``speculate_k + 1`` on the verify path.
        Retires finished slots; no-op when the pool is idle. The deadline
        and cancellation sweep runs first."""
        self._expire(time.perf_counter())
        self._maybe_swap()  # a no-op unless a stage waits and no slot is occupied
        if self._active and self.paged:
            self._prepare(self.speculate_k + 1)
        if not self._active:
            if self._tel is not None:
                self._gauges()
            return
        if self.speculate_k:
            self._step_verify()
        else:
            self._step_plain()

    def _table(self):
        return self.alloc.table if self.paged else None

    def _step_plain(self) -> None:
        t0 = time.perf_counter()
        step_span = None
        if self._tracer is not None:
            step_span = self._tracer.start_span(
                "scheduler.step", lane="scheduler", active=len(self._active),
                backlog=len(self._queue),
            )
        N = self.num_slots
        toks = np.full((N, 1), PAD_ID, np.int64)
        positions = np.zeros((N,), np.int32)
        for slot, st in self._active.items():
            toks[slot, 0] = st.cur
            positions[slot] = st.pos
        logits = self.forward(toks, self._table(), positions)
        slots = list(self._active)
        states = [self._active[s] for s in slots]
        rows = torch.tensor(slots, device=self.device)
        picks = self._pick(logits[rows, 0], states, [st.pos for st in states])
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["steps"] += 1
        for slot, st, tokv in zip(slots, states, picks):
            st.pos += 1
            st.forwards += 1
            if st.pos < st.prompt_len:
                st.cur = st.ids[st.pos]  # still consuming the prompt tail
                continue
            if st.pos == st.prompt_len and not st.emitted:
                st.t_prefill = time.perf_counter()  # the tail's last token went in
                if self._tracer is not None:
                    self._trace_prefill_done(st)
            self._consume_pick(slot, st, tokv)
        if step_span is not None:
            step_span.end()
        if self._tel is not None:
            # The picks' readback above was the step's device synchronize,
            # so this is the step's time, not its launch's.
            dt_step = time.perf_counter() - t0
            self._m_step_s.observe(dt_step)
            self._m_steps.inc()
            if self._profiler is not None:
                # One token per slot that picked this step.
                self._profiler.record(self._prog_step, dt_step, tokens=len(picks))
            self._gauges()

    def _step_verify(self) -> None:
        """One speculative verify step: every occupied slot feeds its
        pending token plus up to ``speculate_k`` lookahead tokens (the
        prompt tail first, then drafts) through ONE forward of static
        width W = k + 1 (rows padded, free slots riding along). The longest
        accepted prefix is kept and the rejected tail rolled back (host
        positions; table truncation on the paged layouts); stale rows past
        a slot's position stay masked until a later write covers them.
        While the speculative breaker is open no slot drafts: the rows
        carry the pending token and any prompt tail through the same
        W-wide forward. A drafter that raises, or runs past
        ``drafter_slow_ms``, feeds the breaker, and its row goes
        undrafted. Greedy answers equal the plain path's."""
        t0 = time.perf_counter()
        n_rows = len(self._active)  # rows fed (before any retires)
        step_span = draft_span = None
        if self._tracer is not None:
            step_span = self._tracer.start_span(
                "scheduler.step", lane="scheduler", active=len(self._active),
                backlog=len(self._queue),
            )
            draft_span = self._tracer.start_span("spec.draft", parent=step_span,
                                                 lane="scheduler")
        N, W = self.num_slots, self.speculate_k + 1
        toks = np.full((N, W), PAD_ID, np.int64)
        positions = np.zeros((N,), np.int32)
        rows: dict[int, tuple[list[int], int]] = {}
        spec_allowed = self.drafter is not None and self._brk_spec.allow()
        if self.drafter is not None and not spec_allowed:
            self.stats["spec_breaker_open_steps"] += 1
        for slot, st in self._active.items():
            drafter = self.drafter if (st.spec and spec_allowed) else None
            self._breaker_trace = st.trace_id  # a drafter fault is this request's
            t_draft = time.perf_counter()
            try:
                row, n_drafted = build_verify_row(
                    st.ids + st.emitted, st.pos, self.speculate_k, drafter, st.dstate,
                )
            except Exception:  # noqa: BLE001 — drafting is an optional accelerator: a drafter failure feeds the breaker and this row goes undrafted
                self._brk_spec.record_failure()
                row, n_drafted = build_verify_row(
                    st.ids + st.emitted, st.pos, self.speculate_k, None, None,
                )
            else:
                if drafter is not None:
                    draft_ms = (time.perf_counter() - t_draft) * 1e3
                    if self.drafter_slow_ms and draft_ms > self.drafter_slow_ms:
                        self._brk_spec.record_failure()
                    else:
                        self._brk_spec.record_success()
            rows[slot] = (row, n_drafted)
            toks[slot, : len(row)] = row
            positions[slot] = st.pos
        self._breaker_trace = None
        verify_span = None
        if draft_span is not None:
            draft_span.end(drafted=sum(n for _, n in rows.values()))
            verify_span = self._tracer.start_span("spec.verify", parent=step_span,
                                                  lane="scheduler", width=W)
        logits = self.forward(toks, self._table(), positions)
        greedy = torch.argmax(logits, dim=-1).tolist()  # (N, W)
        drafted = accepted = 0
        for slot, st in list(self._active.items()):
            row, n_drafted = rows[slot]
            pos0 = st.pos
            if st.sample:
                def pick(j, _st=st, _slot=slot, _p=pos0):
                    return verify_row_picks(
                        logits[_slot, j : j + 1], _st.seed, _p + j, _st.temperature,
                        sample=True, top_k=_st.top_k, top_p=_st.top_p,
                    )[0]
            else:
                def pick(j, _row=greedy[slot]):
                    return _row[j]
            if st.sample and n_drafted:
                # Rejection sampling needs the target's probabilities: only
                # this slot's (W, V) rows come back to the host.
                slot_logits = logits[slot].float().cpu().numpy()

                def accept(j, draft, _l=slot_logits, _st=st, _p=pos0):
                    probs = filtered_probs(_l[j], _st.temperature, _st.top_k, _st.top_p)
                    return sampled_accept(probs, draft, keyed_rng(_st.seed, _p + j))
            else:
                def accept(j, draft, _pick=pick):
                    tok = _pick(j)
                    return tok == draft, tok
            emitted, keep, n_accepted = judge_row(row, pos0, st.prompt_len, accept, pick)
            # Only drafts whose emissions are consumed count as accepted.
            n_accepted = min(n_accepted, self._consumable(st, emitted))
            drafted += n_drafted
            accepted += n_accepted
            st.forwards += 1
            st.drafted += n_drafted
            st.accepted += n_accepted
            st.pos += keep  # the rollback: the rejected tail's rows stay masked
            if not emitted:
                st.cur = st.ids[st.pos]  # every fed position was prompt
                continue
            if not st.emitted:
                st.t_prefill = time.perf_counter()  # a tail-fed prompt's first pick
                if self._tracer is not None:
                    self._trace_prefill_done(st)
            for tok in emitted:
                self._consume_pick(slot, st, tok)
                if slot not in self._active:
                    break  # retired (EOS / budget): the row's tail is dropped
        rollback_span = None
        if verify_span is not None:
            verify_span.end(drafted=drafted, accepted=accepted)
            rollback_span = self._tracer.start_span("spec.rollback", parent=step_span,
                                                    lane="scheduler")
        if self.paged:
            for slot, st in self._active.items():
                self.alloc.truncate(slot, st.pos)
        if rollback_span is not None:
            rollback_span.end()
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["steps"] += 1
        self.stats["drafted"] += drafted
        self.stats["accepted"] += accepted
        if step_span is not None:
            step_span.end(drafted=drafted, accepted=accepted)
        if self._tel is not None:
            dt_step = time.perf_counter() - t0
            self._m_step_s.observe(dt_step)
            self._m_steps.inc()
            if self._profiler is not None:
                # W positions scored per fed row: the verify forward's work.
                self._profiler.record(self._prog_verify, dt_step, tokens=n_rows * W)
            if drafted:
                self._m_spec_drafted.inc(drafted)
                if accepted:
                    self._m_spec_accepted.inc(accepted)
                if drafted - accepted:
                    self._m_spec_rejected.inc(drafted - accepted)
            self._gauges()

    def _consumable(self, st: _Active, emitted: list[int]) -> int:
        """How many of a verify row's emissions ``_consume_pick`` takes
        before the slot retires (the finishing token included): its
        EOS/budget rules without their effects."""
        n, cnt = 0, len(st.emitted)
        for tok in emitted:
            n += 1
            if tok == self.tok.eos_id or cnt >= st.max_new:
                break
            cnt += 1
            if cnt >= st.max_new:
                break
        return n

    def _consume_pick(self, slot: int, st: _Active, tokv: int) -> None:
        """Retire on EOS or a spent budget, else feed ``tokv`` next."""
        if tokv == self.tok.eos_id or len(st.emitted) >= st.max_new:
            self._finish(slot, st)
            return
        st.emitted.append(tokv)
        if st.t_first is None:
            st.t_first = time.perf_counter()
        self.stats["generated_tokens"] += 1
        if self._tel is not None:
            self._m_tokens.inc()
        if len(st.emitted) >= st.max_new:
            self._finish(slot, st)
        else:
            st.cur = tokv

    def _finish(self, slot: int, st: _Active) -> None:
        # Before allow(): a cooldown's open -> half-open transition inside
        # it belongs to this request.
        self._breaker_trace = st.trace_id
        if self.prefix_cache is not None and st.use_prefix and self._brk_prefix.allow():
            # Feed the trie before the slot is recycled: its block-aligned
            # prompt region, donated by reference to the device tier
            # (paged) or copied to the host for the blocks the trie lacks
            # (dense). A failure feeds the breaker; the answer stands.
            B = self.block_tokens
            aligned = (st.prompt_len // B) * B
            if aligned:
                try:
                    with self._traced("prefix.insert", st.span_root,
                                      lane=st.span_root.lane if st.span_root else None,
                                      tokens=aligned):
                        if self.paged:
                            evicted = self.prefix_cache.insert_device(
                                st.ids, aligned,
                                [int(b) for b in self.alloc.table[slot][: aligned // B]],
                            )
                        else:
                            evicted = self.prefix_cache.insert(
                                st.ids, aligned,
                                lambda start: _slot_read_blocks(self.pools, slot, start, B),
                            )
                except Exception:  # noqa: BLE001 — feeding the trie is best-effort: a fault feeds the breaker and this request donates nothing
                    self._brk_prefix.record_failure()
                else:
                    self._brk_prefix.record_success()
                    if evicted and self._tel is not None:
                        self._m_prefix_evicted.inc(evicted)
        self._breaker_trace = None
        text = _detokenize_rows(
            np.asarray([st.emitted], np.int32) if st.emitted
            else np.zeros((1, 0), np.int32),
            1, self.tok,
        )[0]
        self._retire(slot, st, {"continuation": text})
        root = st.span_root
        self._end_spans(st, ("span_prefill",))
        self._end_spans(st, ("span_decode",), new_tokens=len(st.emitted))
        self._end_spans(st, ("span_root",), order=st.order, prompt_tokens=st.prompt_len,
                        new_tokens=len(st.emitted))
        if self._tel is not None or self._span_tap is not None or self._slo is not None:
            span = self._span(st)
            if self._tel is not None:
                self._m_queue_s.observe(st.t_admit - st.t_enqueue)
                self._m_total_s.observe(span["total_s"])
                if st.t_prefill is not None:
                    self._m_prefill_s.observe(st.t_prefill - st.t_admit)
                if st.t_first is not None:
                    self._m_ttft_s.observe(st.t_first - st.t_enqueue)
                self._m_retirements.inc()
            self._record_request(span, root=root)

    def _span(self, st: _Active) -> dict:
        """The answer-boundary span dict of a finished request (the JAX
        ``serve.request`` span's fields)."""
        now = time.perf_counter()
        span = {
            "order": st.order,
            "prompt_tokens": st.prompt_len,
            "new_tokens": len(st.emitted),
            "queue_s": round(st.t_admit - st.t_enqueue, 6),
            "total_s": round(now - st.t_enqueue, 6),
        }
        if st.forwards:
            span["forwards"] = st.forwards
        if st.spec:
            span["drafted"] = st.drafted
            span["draft_accepted"] = st.accepted
        if self.prefix_cache is not None and st.use_prefix:
            span["prefix_hit_tokens"] = st.prefix_hit
        if st.wv is not None:
            span["weight_version"] = st.wv
        if st.t_prefill is not None:
            span["prefill_s"] = round(st.t_prefill - st.t_admit, 6)
        if st.t_first is not None:
            span["ttft_s"] = round(st.t_first - st.t_enqueue, 6)
        return span

    def _retire(self, slot: int, st: _Active, resp: dict) -> None:
        if "error" in resp and st.emitted:
            resp["partial"] = _detokenize_rows(
                np.asarray([st.emitted], np.int32), 1, self.tok
            )[0]
        if st.wv is not None:
            resp["weight_version"] = st.wv
        self._done[st.order] = resp
        del self._active[slot]
        if self.paged:
            self.alloc.free_slot(slot)
        self._free.append(slot)

    # ---- output ------------------------------------------------------------

    def drain_ready(self) -> list[dict]:
        """Responses completed in submission order."""
        out = []
        while self._emit_next in self._done:
            out.append(self._done.pop(self._emit_next))
            self._emit_next += 1
        return out

    def run(self, reqs: list[dict]) -> list[dict]:
        """Serve a fixed request list to completion, answers in order."""
        for req in reqs:
            self.submit(req)
        while self.busy:
            self.admit()
            self.step()
        out = self.drain_ready()
        if self._tel is not None:
            if self._slo is not None:
                self._slo.maybe_evaluate(force=True)
            self._tel.maybe_flush(force=True)
        return out
