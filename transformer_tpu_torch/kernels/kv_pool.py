"""Paged KV memory: the host-side block allocator and the tensor helpers
that address a block pool through per-slot tables.

``KVPool`` is a copy of the JAX package's allocator
(``transformer_tpu/kernels/kv_pool.py``): free-list alloc/free, per-block
refcounts, copy-on-write splits, the pinned sink block 0, and
``check_consistency``. Only ``table_device`` differs (it uploads a torch
tensor). The helpers below it are the tensor versions of
``gather_block_views`` / ``scatter_rows`` / ``block_row_ids``.

Block 0 is the SINK: permanently pinned, never allocated. Unmapped table
entries point at it, and free slots' decode steps write into it.
"""

from __future__ import annotations

import threading

import numpy as np
import torch


class KVPoolExhausted(RuntimeError):
    """The free list cannot satisfy an allocation. Admission-time callers
    degrade this to a transient (retryable) error after asking the prefix
    cache's device tier to spill; decode-time callers preempt the slot
    with a structured ``resource`` answer."""


class KVPool:
    """Host-side allocator for a ``num_blocks`` x ``block_tokens`` pool.

    Owns the per-slot block tables (``num_slots`` rows of
    ``slot_blocks`` entries each): ``table[s, j]`` is the pool block
    holding slot ``s``'s positions ``[j*B, (j+1)*B)``; entries at or past
    the slot's allocated count point at the sink. Every live table entry
    holds one reference on its block; the prefix cache's device tier takes
    additional references via :meth:`retain`. A block returns to the free
    list exactly when its refcount reaches zero — refcounts never go
    negative and a block is never double-freed (``check_consistency``
    re-derives the whole accounting; the schedule checker and the hammer
    test assert it under contention).

    Threading contract: ONE ``threading.Lock`` guards the free list, the
    refcounts, the tables, and the stats. The device-table upload cache
    (:meth:`table_device`) is refreshed under the same lock.
    """

    SINK = 0

    def __init__(
        self, num_blocks: int, block_tokens: int,
        num_slots: int, slot_blocks: int,
    ):
        if num_blocks < 2:
            raise ValueError(
                f"kv pool needs >= 2 blocks (sink + 1), got {num_blocks}"
            )
        if block_tokens < 1:
            raise ValueError(f"block_tokens must be >= 1, got {block_tokens}")
        self.num_blocks = num_blocks
        self.block_tokens = block_tokens
        self.num_slots = num_slots
        self.slot_blocks = slot_blocks
        self._lock = threading.Lock()
        self._refs = np.zeros((num_blocks,), np.int32)
        self._refs[self.SINK] = 1  # permanently pinned
        # LIFO free list (ids 1..num_blocks-1): recently freed blocks are
        # reused first, keeping the working set hot.
        self._free = list(range(num_blocks - 1, 0, -1))
        self.table = np.zeros((num_slots, slot_blocks), np.int32)
        self._owned = np.zeros((num_slots,), np.int32)
        self._dirty = True
        self._table_dev = None
        self.stats = {
            "allocated_blocks": 0, "freed_blocks": 0, "cow_splits": 0,
            "alias_blocks": 0,
        }

    # ---- accounting --------------------------------------------------------

    @property
    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def used_blocks(self) -> int:
        with self._lock:
            return self.num_blocks - 1 - len(self._free)

    def refs(self, bid: int) -> int:
        with self._lock:
            return int(self._refs[bid])

    def slot_tokens(self, slot: int) -> int:
        """Token capacity currently backed by real blocks for ``slot``."""
        with self._lock:
            return int(self._owned[slot]) * self.block_tokens

    # ---- alloc / free ------------------------------------------------------

    def _pop_free(self) -> int:
        # caller holds the lock
        if not self._free:
            raise KVPoolExhausted(
                f"kv pool exhausted: {self.num_blocks - 1} blocks all "
                "referenced (live slots + device-resident prefixes)"
            )
        bid = self._free.pop()
        self._refs[bid] = 1
        self.stats["allocated_blocks"] += 1
        return bid

    def _release(self, bid: int) -> bool:
        # caller holds the lock; returns True when the block was freed
        if bid == self.SINK:
            return False
        self._refs[bid] -= 1
        if self._refs[bid] < 0:  # pragma: no cover - guarded by tests
            raise AssertionError(f"negative refcount on block {bid}")
        if self._refs[bid] == 0:
            self._free.append(bid)
            self.stats["freed_blocks"] += 1
            return True
        return False

    def ensure(self, slot: int, tokens: int) -> bool:
        """Grow ``slot``'s table to cover ``tokens`` positions with OWNED
        (refcount-1) blocks appended past the current end. Returns True
        when the table changed. Raises :class:`KVPoolExhausted` (leaving
        already-appended blocks in place — the caller's free_slot/truncate
        rolls back) when the free list runs dry."""
        need = min(-(-tokens // self.block_tokens), self.slot_blocks)
        changed = False
        with self._lock:
            while self._owned[slot] < need:
                bid = self._pop_free()
                self.table[slot, self._owned[slot]] = bid
                self._owned[slot] += 1
                changed = True
            if changed:
                self._dirty = True
        return changed

    def extend(self, slot: int, bid: int | None = None) -> tuple[int, int]:
        """Append ONE block at the slot's next table position: alias an
        existing block (``bid`` given — takes a reference; the prefix
        cache's device-resident hit path) or allocate a fresh one.
        Returns ``(position, block_id)``."""
        with self._lock:
            j = int(self._owned[slot])
            if j >= self.slot_blocks:
                raise ValueError(
                    f"slot {slot} table full ({self.slot_blocks} blocks)"
                )
            if bid is None:
                bid = self._pop_free()
            else:
                if bid == self.SINK or self._refs[bid] <= 0:
                    raise ValueError(f"cannot alias dead block {bid}")
                self._refs[bid] += 1
                self.stats["alias_blocks"] += 1
            self.table[slot, j] = bid
            self._owned[slot] += 1
            self._dirty = True
            return j, int(bid)

    def truncate(self, slot: int, tokens: int) -> int:
        """Shrink ``slot``'s table to the blocks covering ``tokens``
        positions, releasing the rest (speculative rollback = table
        truncation; freed blocks return to the pool unless the device
        tier still references them). Returns blocks released from the
        table."""
        keep = -(-tokens // self.block_tokens) if tokens > 0 else 0
        released = 0
        with self._lock:
            while self._owned[slot] > keep:
                j = int(self._owned[slot]) - 1
                self._release(int(self.table[slot, j]))
                self.table[slot, j] = self.SINK
                self._owned[slot] = j
                released += 1
            if released:
                self._dirty = True
        return released

    def free_slot(self, slot: int) -> int:
        """Retire ``slot``: drop every table reference (aliased prefix
        blocks survive under the device tier's refs) and reset the row to
        the sink."""
        return self.truncate(slot, 0)

    # ---- sharing -----------------------------------------------------------

    def retain(self, bid: int) -> None:
        """External pin (the prefix cache's device tier adopting a
        retiring slot's block)."""
        with self._lock:
            if bid == self.SINK or self._refs[bid] <= 0:
                raise ValueError(f"cannot retain dead block {bid}")
            self._refs[bid] += 1

    def release(self, bid: int) -> bool:
        """Drop an external pin; True when the block returned to the
        free list."""
        with self._lock:
            return self._release(bid)

    def make_writable(
        self, slot: int, start_token: int, end_token: int
    ) -> list[tuple[int, int]]:
        """Copy-on-write guard for a write into positions ``[start_token,
        end_token)``: any touched block shared with another owner
        (refcount > 1) is split — a fresh block takes its table entry, the
        old block keeps its other owners. Returns ``(src, dst)`` block-id
        pairs the caller must copy ON DEVICE (``_pool_copy_blocks``)
        before dispatching the write. Normal serving flows write only past
        the aliased (block-aligned) prefix, so this usually returns [] —
        it is the guard that makes aliasing safe by construction rather
        than by call-site discipline."""
        if end_token <= start_token:
            return []
        B = self.block_tokens
        pairs: list[tuple[int, int]] = []
        with self._lock:
            j0 = start_token // B
            j1 = -(-end_token // B)
            for j in range(j0, min(j1, int(self._owned[slot]))):
                bid = int(self.table[slot, j])
                if bid == self.SINK or self._refs[bid] <= 1:
                    continue
                new = self._pop_free()
                self._refs[bid] -= 1  # > 1 before, so never frees here
                self.table[slot, j] = new
                self.stats["cow_splits"] += 1
                pairs.append((bid, new))
            if pairs:
                self._dirty = True
        return pairs

    # ---- device table ------------------------------------------------------

    def table_device(self, device):
        """The (num_slots, slot_blocks) int32 table as a tensor on
        ``device``, re-uploaded only when the host table changed since the
        last call."""
        with self._lock:
            if self._dirty or self._table_dev is None or (
                self._table_dev.device != torch.device(device)
            ):
                self._table_dev = torch.from_numpy(self.table.copy()).to(device)
                self._dirty = False
            return self._table_dev

    # ---- invariants --------------------------------------------------------

    def check_consistency(self) -> None:
        """Re-derive the whole accounting from first principles: refcounts
        never negative, free list duplicate-free and disjoint from every
        table, every live table entry referenced, freed blocks hold zero
        references, block-count conservation. The schedule checker and the
        hammer test call this after every operation."""
        with self._lock:
            free = list(self._free)
            assert len(set(free)) == len(free), "double-free: dup in free list"
            assert self.SINK not in free, "sink leaked into the free list"
            assert (self._refs >= 0).all(), (
                f"negative refcount: {self._refs.tolist()}"
            )
            for bid in free:
                assert self._refs[bid] == 0, (
                    f"free block {bid} still referenced ({self._refs[bid]})"
                )
            table_refs = np.zeros_like(self._refs)
            for s in range(self.num_slots):
                owned = int(self._owned[s])
                for j in range(self.slot_blocks):
                    bid = int(self.table[s, j])
                    if j < owned:
                        assert bid != self.SINK, (
                            f"slot {s} owned entry {j} points at the sink"
                        )
                        assert bid not in free, (
                            f"slot {s} references freed block {bid}"
                        )
                        table_refs[bid] += 1
                    else:
                        assert bid == self.SINK, (
                            f"slot {s} stale entry {j} -> {bid}"
                        )
            # refs = table occurrences + external pins (>= 0 each)
            extra = self._refs - table_refs
            extra[self.SINK] -= 1  # the permanent sink pin
            assert (extra >= 0).all(), (
                f"refcount below table occupancy: {extra.tolist()}"
            )
            live = self.num_blocks - 1 - len(free)
            assert live == int((self._refs[1:] > 0).sum()), (
                "block-count conservation violated"
            )


# ==========================================================================
# tensor helpers


def gather_block_views(buf: torch.Tensor, table: torch.Tensor, width: int | None = None):
    """``buf`` (num_blocks, B, ...) x ``table`` (N, nmax) -> (N, L, ...)
    dense-ordered views, ``L = width`` (or nmax * B). Unmapped entries
    gather the sink block; its rows sit where the offset causal mask hides
    them."""
    n, nmax = table.shape
    view = buf[table.long()]  # (N, nmax, B, ...)
    view = view.reshape(n, nmax * buf.shape[1], *buf.shape[2:])
    if width is not None and width < view.shape[1]:
        view = view[:, :width]
    return view


def scatter_rows(buf: torch.Tensor, row_ids: torch.Tensor, rows: torch.Tensor):
    """Write flat pool rows IN PLACE: ``row_ids`` (M,) flat indices
    (block * B + offset), ``rows`` (M, ...). Ids may repeat only on sink
    rows, whose content is never read unmasked. Returns ``buf``."""
    nb, bt = buf.shape[0], buf.shape[1]
    flat = buf.view(nb * bt, *buf.shape[2:])
    flat[row_ids.long()] = rows.to(buf.dtype)
    return buf


def block_row_ids(table: torch.Tensor, index: torch.Tensor, s_q: int, block_tokens: int):
    """Flat pool row ids for writes at positions [index[s], index[s] + s_q):
    (N, s_q). Positions past the table clamp into its last entry, so free
    slots (index 0, all-sink rows) land in the sink."""
    nmax = table.shape[1]
    pos = index.long()[:, None] + torch.arange(s_q, device=index.device)[None, :]
    blk = torch.gather(
        table.long(), 1, torch.clamp(pos // block_tokens, 0, nmax - 1)
    )
    return blk * block_tokens + pos % block_tokens
