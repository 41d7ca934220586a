"""Continuous (in-flight) batching for decoder-only LM serving, paged KV.

A reduced port of ``transformer_tpu/serve/scheduler.py``
``ContinuousScheduler`` with ``kv_layout="paged"`` and
``decode_kernel="paged_flash"``:

- every slot's KV lives in ONE block pool per layer, addressed through
  per-slot block tables (``kernels/kv_pool.KVPool``, block 0 the sink);
- admission at step boundaries: a queued request takes a free slot and its
  prompt is chunk-prefilled through a gathered dense view of the slot's
  blocks, whose written rows are then scattered back into the pool; a
  prompt longer than its power-of-two prefill bucket feeds its tail one
  token per decode step;
- each step is ONE ``paged_decode_forward`` over every slot (free slots
  write only the sink), on the two CUDA kernels;
- a slot retires on EOS or when its ``max_new`` budget is spent, and is
  recycled at the next step boundary.

Left out here (later slices): speculative decoding, the prefix cache,
fault injection and circuit breakers, deadlines and cancellation,
telemetry/tracing/SLOs, live weight upgrades, the dense layout, MoE.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from transformer_tpu_torch.config import PAD_ID, ModelConfig
from transformer_tpu_torch.device import resolve_device, synchronize
from transformer_tpu_torch.kernels.kv_pool import (
    KVPool,
    KVPoolExhausted,
    gather_block_views,
    scatter_rows,
)
from transformer_tpu_torch.models.paged_decode import (
    check_paged_flash_config,
    paged_decode_forward,
)
from transformer_tpu_torch.models.transformer import transformer_prefill
from transformer_tpu_torch.ops.attention import init_block_pool, kv_buffer_keys
from transformer_tpu_torch.train.decode import (
    _detokenize_rows,
    prefill_len_for,
    sample_token,
)


def error_answer(code: str, message: str) -> dict:
    return {"error": message, "code": code}


def classify_error(exc: BaseException) -> str:
    """Exception -> error code for admission-time failures."""
    if isinstance(exc, KVPoolExhausted):
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


@dataclasses.dataclass
class _Pending:
    order: int
    req: dict


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


class ContinuousScheduler:
    """Step-level continuous batching over ``num_slots`` paged KV slots.

    ``submit`` queues LM requests (dicts with ``prompt`` and optional
    ``max_new`` / ``temperature`` / ``top_k`` / ``top_p`` / ``seed``);
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
        kv_block: int = 16,
        kv_pool_blocks: int = 0,
        device="cuda",
    ):
        check_paged_flash_config(cfg)
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if kv_block < 1:
            raise ValueError(f"kv_block must be >= 1, got {kv_block}")
        self.device = resolve_device(device)
        self.cfg, self.tok = cfg, tokenizer
        self.params = compute_params(params, cfg, self.device)
        self.num_slots = num_slots
        self.prefill_chunk = prefill_chunk
        self.default_max_new = default_max_new
        self.max_total = max_total or cfg.max_position + 1
        self.block_tokens = kv_block
        self.slot_blocks = -(-self.max_total // kv_block)
        # Prefill views are gathered at slot_blocks * B rows and sliced to
        # max_total, the dense layout's buffer length.
        self.buf_len = self.max_total
        num_blocks = kv_pool_blocks or (1 + num_slots * self.slot_blocks)
        self.alloc = KVPool(num_blocks, kv_block, num_slots, self.slot_blocks)
        self.pools = [
            init_block_pool(
                num_blocks, kv_block, cfg.kv_heads, cfg.head_dim,
                cfg.compute_dtype, quantize=cfg.kv_cache_int8, device=self.device,
            )
            for _ in range(cfg.num_layers)
        ]
        self._free = list(range(num_slots))
        self._active: dict[int, _Active] = {}
        self._queue: deque[_Pending] = deque()
        self._done: dict[int, dict] = {}
        self._next_order = 0
        self._emit_next = 0
        self.stats = {
            "admitted": 0, "steps": 0, "max_active": 0, "kv_preempted": 0,
            "prompt_tokens": 0, "prefill_tokens": 0, "prefill_forwards": 0,
            "prefill_s": 0.0, "decode_s": 0.0, "generated_tokens": 0,
        }

    # ---- intake ------------------------------------------------------------

    def submit(self, req: dict) -> int:
        order = self._next_order
        self._next_order += 1
        self._queue.append(_Pending(order=order, req=req))
        return order

    def submit_done(self, resp: dict) -> int:
        order = self._next_order
        self._next_order += 1
        self._done[order] = resp
        return order

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
        enters the pool."""
        while self._free and self._queue:
            p = self._queue.popleft()
            try:
                self._start(p)
            except Exception as e:  # noqa: BLE001 — per-request isolation: any admission failure answers this request alone
                self._done[p.order] = error_answer(
                    classify_error(e), f"{type(e).__name__}: {e}"
                )

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
        temperature = float(req.get("temperature", 0.0))
        sample = temperature > 0.0
        top_k = int(req.get("top_k", 0)) if sample else 0
        top_p = float(req.get("top_p", 1.0)) if sample else 1.0
        seed = int(req.get("seed", 0)) if sample else 0
        if sample and top_k > cfg.target_vocab_size:
            raise ValueError(
                f"top_k={top_k} exceeds the vocab size {cfg.target_vocab_size}"
            )
        n = prefill_len_for(L, self.prefill_chunk)
        slot = self._free.pop()
        try:
            self.alloc.ensure(slot, n)
            t0 = time.perf_counter()
            logits = self._prefill(slot, ids[:n])
            synchronize(self.device)
            self.stats["prefill_s"] += time.perf_counter() - t0
        except BaseException:
            self.alloc.free_slot(slot)
            self._free.append(slot)
            raise
        chunk = self.prefill_chunk
        self.stats["prompt_tokens"] += L
        self.stats["prefill_tokens"] += n
        self.stats["prefill_forwards"] += -(-n // chunk) if chunk > 0 else 1
        st = _Active(
            order=p.order, ids=ids, prompt_len=L, pos=n, cur=PAD_ID,
            emitted=[], max_new=max_new, sample=sample,
            temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
        )
        self._active[slot] = st
        self.stats["admitted"] += 1
        self.stats["max_active"] = max(self.stats["max_active"], len(self._active))
        if n < L:
            st.cur = ids[n]  # the prompt tail feeds token by token
        else:
            self._consume_pick(slot, st, self._pick(logits, [st], [n - 1])[0])

    def _prefill(self, slot: int, prompt: list[int]) -> torch.Tensor:
        """Chunked prefill of ``prompt`` (positions 0..n-1) into ``slot``:
        gather the slot's blocks into a dense (1, buf_len, H_kv, D) view,
        run the cached prefill forward over it, then scatter the n written
        rows back into the pool. Returns the (1, V) next-token logits."""
        table = self.alloc.table_device(self.device)
        row = table[slot : slot + 1]
        caches = [
            {
                **{
                    key: gather_block_views(pool[key], row, self.buf_len)
                    for key in kv_buffer_keys(pool)
                },
                "index": 0,
            }
            for pool in self.pools
        ]
        toks = torch.tensor([prompt], dtype=torch.long, device=self.device)
        logits, caches = transformer_prefill(
            self.params, toks, caches, 0, self.cfg, chunk=self.prefill_chunk
        )
        n = len(prompt)
        pos = torch.arange(n, device=self.device)
        blk = row[0].long()[torch.clamp(pos // self.block_tokens, 0, self.slot_blocks - 1)]
        rids = blk * self.block_tokens + pos % self.block_tokens
        for pool, cache in zip(self.pools, caches):
            for key in kv_buffer_keys(pool):
                scatter_rows(pool[key], rids, cache[key][0, :n])
        return logits

    # ---- stepping ----------------------------------------------------------

    def _pick(self, logits: torch.Tensor, states: list[_Active], positions: list[int]):
        """Next tokens for ``logits`` rows (one per state): greedy rows in one
        argmax; each sampled row with a generator seeded from (seed,
        position), so a request's draws do not depend on its neighbours."""
        picks = sample_token(logits).tolist()
        for i, (st, position) in enumerate(zip(states, positions)):
            if st.sample:
                gen = torch.Generator(device=logits.device)
                gen.manual_seed((st.seed * 1_000_003 + position) % (1 << 63))
                picks[i] = int(sample_token(
                    logits[i : i + 1], gen, sample=True,
                    temperature=st.temperature, top_k=st.top_k, top_p=st.top_p,
                )[0])
        return picks

    def step(self) -> None:
        """Advance every occupied slot one token with ONE pooled forward;
        retire finished slots. No-op when the pool is idle."""
        for slot, st in list(self._active.items()):
            try:
                self.alloc.ensure(slot, st.pos + 1)
            except KVPoolExhausted as e:
                self.stats["kv_preempted"] += 1
                self._retire(slot, st, error_answer(
                    "resource",
                    f"kv pool exhausted after {len(st.emitted)} of "
                    f"{st.max_new} tokens: {e}",
                ))
        if not self._active:
            return
        t0 = time.perf_counter()
        N = self.num_slots
        toks = np.full((N, 1), PAD_ID, np.int64)
        positions = np.zeros((N,), np.int32)
        for slot, st in self._active.items():
            toks[slot, 0] = st.cur
            positions[slot] = st.pos
        logits, self.pools = paged_decode_forward(
            self.params,
            torch.from_numpy(toks).to(self.device),
            self.pools,
            self.alloc.table_device(self.device),
            torch.from_numpy(positions).to(self.device),
            self.cfg,
            block_tokens=self.block_tokens,
        )
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
