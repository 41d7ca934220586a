"""Continuous (in-flight) batching for decoder-only LM serving, paged KV.

A reduced port of ``transformer_tpu/serve/scheduler.py``
``ContinuousScheduler`` with ``kv_layout="paged"`` and
``decode_kernel="paged_flash"``:

- every slot's KV lives in ONE block pool per layer, addressed through
  per-slot block tables (``kernels/kv_pool.KVPool``, block 0 the sink);
- admission at step boundaries: a queued request takes a free slot, the
  longest block-aligned prefix of its prompt that the prefix cache holds
  is restored (``serve/prefix_cache.py``: device-tier blocks aliased into
  the table, host-tier blocks written into fresh ones), and the rest is
  chunk-prefilled through a gathered dense view of the slot's blocks,
  whose written rows are then scattered back into the pool; a prompt
  longer than its power-of-two prefill bucket feeds its tail through the
  steps;
- each step is ONE ``paged_decode_forward`` over every slot (free slots
  write only the sink), on the two CUDA kernels, replayed from a CUDA
  graph on the card (``serve/graph.py``): one token per slot, or with
  ``speculate_k`` a verify step that feeds each slot's pending token plus
  up to k lookahead tokens (prompt tail, then drafts) and keeps the
  longest accepted prefix (``serve/speculative.py``); the rejected tail
  rolls back by table truncation;
- a slot retires on EOS or when its ``max_new`` budget is spent, donates
  its prompt blocks to the prefix cache's device tier, and is recycled at
  the next step boundary. Pool exhaustion spills the device tier to the
  host tier first; at admission it then becomes a ``TransientError``,
  retried ``admission_retries`` times after a jittered ``backoff_ms``
  each (the request waits in the queue meanwhile) before it answers
  ``transient``; during a step it preempts the requesting slot;
- the request lifecycle: ``deadline_ms`` (a queued request past it
  answers ``deadline`` without taking a slot; an in-flight one is aborted
  at the next step boundary, or right after its prefill), ``cancel(order)``
  from any thread (executed at the next step boundary: ``cancelled``) and
  ``max_backlog`` (a submission past that many queued requests answers
  ``backpressure`` at once). An aborted slot returns its blocks to the
  pool, donates nothing to the prefix cache, and its answer carries the
  tokens emitted so far as ``partial``. Client threads and the scheduler
  loop share the queue under one intake lock.

Left out here (later slices): the dense layout and ``decode_kernel=
"xla"``, fault injection and circuit breakers, telemetry/tracing/SLOs,
live weight upgrades, ``shutdown``, MoE.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from collections import deque

import numpy as np
import torch

from transformer_tpu_torch.config import PAD_ID, ModelConfig
from transformer_tpu_torch.data.seeding import keyed_rng
from transformer_tpu_torch.device import resolve_device, synchronize
from transformer_tpu_torch.kernels.kv_pool import (
    KVPool,
    KVPoolExhausted,
    gather_block_views,
    pool_copy_blocks,
    pool_read_block,
    pool_write_blocks,
    scatter_rows,
)
from transformer_tpu_torch.models.paged_decode import check_paged_flash_config
from transformer_tpu_torch.models.transformer import transformer_prefill
from transformer_tpu_torch.ops.attention import init_block_pool, kv_buffer_keys
from transformer_tpu_torch.serve.graph import CapturedForward
from transformer_tpu_torch.serve.prefix_cache import PrefixCorruptionError
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


class TransientError(RuntimeError):
    """An admission failure worth a bounded, jittered retry (pool
    pressure), as opposed to a validation error, which no retry fixes."""


def error_answer(code: str, message: str) -> dict:
    return {"error": message, "code": code}


def classify_error(exc: BaseException) -> str:
    """Exception -> error code for admission-time failures."""
    if isinstance(exc, TransientError):
        return "transient"
    if isinstance(exc, (ValueError, TypeError, KeyError)):
        return "validation"
    return "internal"


def compute_params(params, cfg: ModelConfig, device: torch.device):
    """The params as serving reads them: every kernel, bias and embedding
    cast once to the compute dtype (every use casts it there anyway, so the
    values are the same ones a per-call cast gives), LayerNorm parameters
    kept as stored (``layernorm_apply`` reads them in fp32)."""
    dtype = cfg.compute_dtype

    def walk(node, is_ln=False):
        if isinstance(node, dict):
            return {
                k: walk(v, is_ln or k.startswith("ln") or k == "final_ln")
                for k, v in node.items()
            }
        if isinstance(node, list):
            return [walk(v, is_ln) for v in node]
        t = node.to(device)
        return t if is_ln else t.to(dtype)

    return walk(params)


def backoff_ms(base_ms: float, attempt: int, order: int) -> float:
    """The wait before admission retry ``attempt`` (0-based) of request
    ``order``: ``base_ms`` doubled per attempt, times a jitter in [0.5,
    1.5) drawn from (order, attempt), so same-tick failures do not retry
    in lockstep and a run replays exactly. A copy of the JAX package's
    ``serve.resilience.backoff_ms``."""
    jitter = 0.5 + random.Random(f"backoff|{order}|{attempt}").random()
    return base_ms * (2 ** attempt) * jitter


@dataclasses.dataclass
class _Pending:
    order: int
    req: dict
    attempts: int = 0          # admission retries taken
    not_before: float = 0.0    # perf_counter time before which admit() skips it
    t_enqueue: float = 0.0     # perf_counter time of submission
    deadline: float | None = None  # perf_counter time past which it expires


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


class ContinuousScheduler:
    """Step-level continuous batching over ``num_slots`` paged KV slots.

    ``submit`` queues LM requests (dicts with ``prompt`` and optional
    ``max_new`` / ``temperature`` / ``top_k`` / ``top_p`` / ``seed`` /
    ``deadline_ms``, and ``cache_prefix`` / ``speculate``, which opt a
    request out of the prefix cache or out of drafting) and returns the
    request's order; ``cancel(order)`` asks for its cancellation;
    ``submit_done`` reserves an output position for an already-answered
    response. ``admit`` / ``step`` / ``drain_ready`` are the streaming API
    the serve CLI drives; ``run`` serves a fixed list to completion.
    Answers come back in submission order.
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
        kv_block: int = 16,
        kv_pool_blocks: int = 0,
        admission_retries: int = 2,
        retry_backoff_ms: float = 20.0,
        max_backlog: int = 0,
        device="cuda",
    ):
        check_paged_flash_config(cfg)
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if speculate_k < 0:
            raise ValueError(f"speculate_k must be >= 0, got {speculate_k}")
        if prefix_cache is not None:
            # Pool blocks and prefix-cache blocks are one unit: a
            # device-tier hit aliases trie-held pool blocks into a table.
            kv_block = prefix_cache.block_tokens
        if kv_block < 1:
            raise ValueError(f"kv_block must be >= 1, got {kv_block}")
        self.device = resolve_device(device)
        self.cfg, self.tok = cfg, tokenizer
        self.params = compute_params(params, cfg, self.device)
        self.num_slots = num_slots
        self.prefill_chunk = prefill_chunk
        self.default_max_new = default_max_new
        self.max_total = max_total or cfg.max_position + 1
        self.speculate_k = speculate_k
        self.admission_retries = max(0, admission_retries)
        self.retry_backoff_ms = retry_backoff_ms
        self.max_backlog = max(0, max_backlog)
        # k > 0 with no drafter given: the model-free n-gram drafter.
        self.drafter = drafter if drafter is not None or not speculate_k else NgramDrafter()
        self.prefix_cache = prefix_cache
        self.block_tokens = kv_block
        # speculate_k rows of slack: a verify step writes k + 1 positions
        # even from the slot's last budgeted position. Prefill views are
        # gathered at slot_blocks * B rows and sliced to this length, the
        # dense layout's buffer length; admission budgets use max_total.
        self.buf_len = self.max_total + speculate_k
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
        self.forward = CapturedForward(self.params, self.pools, cfg, kv_block, self.device)
        if prefix_cache is not None:
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
        # Client threads (submit, cancel) and the scheduler loop share the
        # queue, the order counter, the done map and the cancellations
        # under this lock; iterating a deque is not atomic.
        self._intake_lock = threading.Lock()
        self._cancel_pending: dict[int, str] = {}
        # Queued requests that carry a deadline: 0 keeps the expiry scan
        # off the step path.
        self._queued_deadlines = 0
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
        }

    # ---- intake ------------------------------------------------------------

    def submit(self, req: dict) -> int:
        """Queue ``req``; returns its order (its answer's output position).
        Past ``max_backlog`` queued requests it answers ``backpressure`` at
        once instead. A ``deadline_ms`` that does not parse is left to
        admission, which answers it as a validation error."""
        now = time.perf_counter()
        with self._intake_lock:
            order = self._next_order
            self._next_order += 1
            if self.max_backlog and len(self._queue) >= self.max_backlog:
                self.stats["backpressure"] += 1
                self._done[order] = error_answer(
                    "backpressure",
                    f"admission queue is full ({self.max_backlog} requests); "
                    "retry after a backoff",
                )
                return order
            deadline = None
            try:
                d = req.get("deadline_ms")
                if d is not None:
                    deadline = now + float(d) / 1e3
            except (TypeError, ValueError):
                pass  # _start parses it again and answers the validation error
            self._queue.append(_Pending(order=order, req=req, t_enqueue=now, deadline=deadline))
            if deadline is not None:
                self._queued_deadlines += 1
        return order

    def submit_done(self, resp: dict) -> int:
        with self._intake_lock:
            order = self._next_order
            self._next_order += 1
            self._done[order] = resp
        return order

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

    def _answer_expired(self, p: _Pending, now: float) -> None:
        """A queued request's deadline passed before a slot freed."""
        self.stats["deadline_expired"] += 1
        self._done[p.order] = error_answer(
            "deadline",
            f"deadline_ms elapsed after {round((now - p.t_enqueue) * 1e3)}ms "
            "in the admission queue",
        )

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
        """Free an occupied slot without retiring it normally (deadline or
        cancellation): its blocks go back to the pool and its table row to
        the sink, so later steps write nothing of it; nothing is donated to
        the prefix cache (admission released its hit already); the answer
        is a ``code`` error carrying the emitted tokens as ``partial``."""
        self.stats["deadline_expired" if code == "deadline" else "cancelled"] += 1
        self._retire(slot, st, error_answer(code, message))

    @property
    def busy(self) -> bool:
        return bool(self._queue or self._active)

    @property
    def backlog(self) -> int:
        return len(self._queue)

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
        enters the pool. A ``TransientError`` (the pool exhausted after
        the spill) is retried up to ``admission_retries`` times, each after
        a jittered ``backoff_ms``; entries still waiting out their backoff
        are skipped this tick and go back to the front of the queue. With
        no slot occupied and every queued request waiting, it sleeps until
        the first is due (at most 50 ms), so that drive loops do not spin."""
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
                    continue
                self._done[p.order] = error_answer("transient", f"{type(e).__name__}: {e}")
            except Exception as e:  # noqa: BLE001 — per-request isolation: any admission failure answers this request alone
                self._done[p.order] = error_answer(
                    classify_error(e), f"{type(e).__name__}: {e}"
                )
        with self._intake_lock:
            self._queue.extendleft(reversed(deferred))
            self._queued_deadlines += sum(1 for p in deferred if p.deadline is not None)
            idle = not self._active and deferred and len(deferred) == len(self._queue)
        if idle:
            time.sleep(min(min(p.not_before for p in deferred) - now, 0.05))

    def _start(self, p: _Pending) -> None:
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
        use_prefix = self.prefix_cache is not None and bool(req.get("cache_prefix", True))
        hit, m = None, 0
        if use_prefix:
            # Match the prompt less its last token: at least one token goes
            # through the forward, whose logits make the first pick.
            try:
                hit = self.prefix_cache.match(ids[: L - 1])
                m = hit.tokens
            except PrefixCorruptionError:
                pass  # the corrupt subtree is gone: this admission prefills in full
        n = m + prefill_len_for(L - m, self.prefill_chunk)
        slot = self._free.pop()
        aliased = 0
        try:
            try:
                if m:
                    aliased = self._restore(slot, hit)
                self._alloc_call(lambda: self.alloc.ensure(slot, n))
                self._cow(slot, m, n)
            except KVPoolExhausted as e:  # pool pressure: retryable
                raise TransientError(str(e)) from e
            t0 = time.perf_counter()
            logits = self._prefill(slot, ids[m:n], m)
            synchronize(self.device)
            self.stats["prefill_s"] += time.perf_counter() - t0
        except BaseException:
            self.alloc.free_slot(slot)
            self._free.append(slot)
            raise
        finally:
            if hit is not None:
                hit.release()
        chunk = self.prefill_chunk
        self.stats["prompt_tokens"] += L
        self.stats["prefill_tokens"] += n - m
        self.stats["prefill_forwards"] += -(-(n - m) // chunk) if chunk > 0 else 1
        self.stats["prefix_hit_tokens"] += m
        self.stats["prefix_alias_tokens"] += aliased
        self.stats["host_restored_tokens"] += m - aliased
        spec = bool(self.speculate_k) and bool(req.get("speculate", True))
        st = _Active(
            order=p.order, ids=ids, prompt_len=L, pos=n, cur=PAD_ID,
            emitted=[], max_new=max_new, sample=sample,
            temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
            spec=spec, dstate=self.drafter.start(ids) if spec else None,
            use_prefix=use_prefix, deadline=deadline,
        )
        self._active[slot] = st
        self.stats["admitted"] += 1
        self.stats["max_active"] = max(self.stats["max_active"], len(self._active))
        if deadline is not None and time.perf_counter() >= deadline:
            # The prefill alone spent the budget: answer now rather than
            # decode tokens the client has given up on.
            self._abort(slot, st, "deadline", "deadline_ms elapsed during prefill")
            return
        if n < L:
            st.cur = ids[n]  # the prompt tail feeds through the steps
        else:
            self._consume_pick(slot, st, self._pick(logits, [st], [n - 1])[0])

    def _prefill(self, slot: int, prompt: list[int], start: int) -> torch.Tensor:
        """Chunked prefill of ``prompt`` at positions ``start ..`` into
        ``slot``: gather the slot's blocks (a restored prefix included)
        into a dense (1, buf_len, H_kv, D) view, run the cached prefill
        forward over it from ``start``, then scatter the written rows back
        into the pool. Returns the (1, V) next-token logits."""
        table = self.alloc.table_device(self.device)
        row = table[slot : slot + 1]
        caches = [
            {
                **{
                    key: gather_block_views(pool[key], row, self.buf_len)
                    for key in kv_buffer_keys(pool)
                },
                "index": start,
            }
            for pool in self.pools
        ]
        toks = torch.tensor([prompt], dtype=torch.long, device=self.device)
        logits, caches = transformer_prefill(
            self.params, toks, caches, start, self.cfg, chunk=self.prefill_chunk
        )
        n = len(prompt)
        pos = start + torch.arange(n, device=self.device)
        blk = row[0].long()[torch.clamp(pos // self.block_tokens, 0, self.slot_blocks - 1)]
        rids = blk * self.block_tokens + pos % self.block_tokens
        for pool, cache in zip(self.pools, caches):
            for key in kv_buffer_keys(pool):
                scatter_rows(pool[key], rids, cache[key][0, start : start + n])
        return logits

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
        """Before a step: blocks covering every occupied slot's writes
        ``[pos, pos + width)``, split where shared. Exhaustion (after the
        spill) preempts the slot with a ``resource`` answer carrying its
        partial continuation."""
        for slot, st in list(self._active.items()):
            try:
                self._alloc_call(lambda: self.alloc.ensure(slot, st.pos + width))
                self._cow(slot, st.pos, st.pos + width)
            except KVPoolExhausted as e:
                self.stats["kv_preempted"] += 1
                self._retire(slot, st, error_answer(
                    "resource",
                    f"kv pool exhausted after {len(st.emitted)} of "
                    f"{st.max_new} tokens: {e}",
                ))

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
        if self._active:
            self._prepare(self.speculate_k + 1)
        if not self._active:
            return
        if self.speculate_k:
            self._step_verify()
        else:
            self._step_plain()

    def _step_plain(self) -> None:
        t0 = time.perf_counter()
        N = self.num_slots
        toks = np.full((N, 1), PAD_ID, np.int64)
        positions = np.zeros((N,), np.int32)
        for slot, st in self._active.items():
            toks[slot, 0] = st.cur
            positions[slot] = st.pos
        logits = self.forward(toks, self.alloc.table, positions)
        slots = list(self._active)
        states = [self._active[s] for s in slots]
        rows = torch.tensor(slots, device=self.device)
        picks = self._pick(logits[rows, 0], states, [st.pos for st in states])
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["steps"] += 1
        for slot, st, tokv in zip(slots, states, picks):
            st.pos += 1
            if st.pos < st.prompt_len:
                st.cur = st.ids[st.pos]  # still consuming the prompt tail
                continue
            self._consume_pick(slot, st, tokv)

    def _step_verify(self) -> None:
        """One speculative verify step: every occupied slot feeds its
        pending token plus up to ``speculate_k`` lookahead tokens (the
        prompt tail first, then drafts) through ONE forward of static
        width W = k + 1 (rows padded, free slots riding along). The longest
        accepted prefix is kept and the rejected tail rolled back by table
        truncation; stale rows past a slot's position stay masked until a
        later write covers them. Greedy answers equal the plain path's."""
        t0 = time.perf_counter()
        N, W = self.num_slots, self.speculate_k + 1
        toks = np.full((N, W), PAD_ID, np.int64)
        positions = np.zeros((N,), np.int32)
        rows: dict[int, tuple[list[int], int]] = {}
        for slot, st in self._active.items():
            row, n_drafted = build_verify_row(
                st.ids + st.emitted, st.pos, self.speculate_k,
                self.drafter if st.spec else None, st.dstate,
            )
            rows[slot] = (row, n_drafted)
            toks[slot, : len(row)] = row
            positions[slot] = st.pos
        logits = self.forward(toks, self.alloc.table, positions)
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
            st.pos += keep
            if not emitted:
                st.cur = st.ids[st.pos]  # every fed position was prompt
                continue
            for tok in emitted:
                self._consume_pick(slot, st, tok)
                if slot not in self._active:
                    break  # retired (EOS / budget): the row's tail is dropped
        for slot, st in self._active.items():
            self.alloc.truncate(slot, st.pos)
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["steps"] += 1
        self.stats["drafted"] += drafted
        self.stats["accepted"] += accepted

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
        self.stats["generated_tokens"] += 1
        if len(st.emitted) >= st.max_new:
            self._finish(slot, st)
        else:
            st.cur = tokv

    def _finish(self, slot: int, st: _Active) -> None:
        if self.prefix_cache is not None and st.use_prefix:
            # Donate the block-aligned prompt region to the device tier by
            # reference before the slot's table is released.
            B = self.block_tokens
            aligned = (st.prompt_len // B) * B
            if aligned:
                self.prefix_cache.insert_device(
                    st.ids, aligned, [int(b) for b in self.alloc.table[slot][: aligned // B]]
                )
        text = _detokenize_rows(
            np.asarray([st.emitted], np.int32) if st.emitted
            else np.zeros((1, 0), np.int32),
            1, self.tok,
        )[0]
        self._retire(slot, st, {"continuation": text})

    def _retire(self, slot: int, st: _Active, resp: dict) -> None:
        if "error" in resp and st.emitted:
            resp["partial"] = _detokenize_rows(
                np.asarray([st.emitted], np.int32), 1, self.tok
            )[0]
        self._done[st.order] = resp
        del self._active[slot]
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
        return self.drain_ready()
