"""Cross-request prefix KV cache: radix-trie prompt reuse for the paged pool.

Port of ``transformer_tpu/serve/prefix_cache.py``, host code (numpy and
dicts) kept as the JAX package's:

- **Blocks.** Prompt KV is kept as fixed-size token-aligned blocks
  (``block_tokens`` positions), per decoder layer, in the pool's own
  storage layout (``kernels/kv_pool.py``'s host block format: int8 codes
  with their fp32 scales, bf16 rows as raw 16-bit patterns, GQA at the
  kv-head count), so a restore is bit-identical to the donor's write.
- **Radix trie over token ids.** Edges are ``block_tokens``-wide token
  tuples; a node at depth ``d`` holds the KV of positions ``[d*B,
  (d+1)*B)`` of every prompt sharing that token prefix, so a match is a
  root walk.
- **Eviction.** Refcounted LRU under a byte budget: pinned nodes and
  interior nodes are never evicted.
- **Integrity.** Every host block carries a crc32, verified at match; a
  corrupt block drops its subtree and raises ``PrefixCorruptionError``.
- **Dense restore.** ``PrefixHit.stacked`` concatenates a hit's host
  blocks into one power-of-two padded run, which the dense slot pool's
  ``_slot_restore`` writes into a slot in one copy.
- **Device tier.** With the scheduler's ``KVPool`` attached, a node may
  hold a refcounted pool block id instead of (or beside) host bytes: a
  retiring slot donates its prompt blocks by reference (``insert_device``)
  and a later hit aliases them into its table (``PrefixHit.paged_plan``).
  Pool pressure spills LRU device blocks to the host tier
  (``release_device_blocks``); a host-tier hit is written into fresh pool
  blocks and re-adopted (``adopt_device``).

One ``threading.Lock`` guards every trie mutation, pin and the byte
accounting; device reads run outside it. The fault points
``prefix.match``, ``prefix.corrupt`` and ``prefix.insert``
(``serve/resilience.py``) sit where the JAX package has them. Left out:
``hot_prefixes`` (the fleet's cache warming).
"""

from __future__ import annotations

import dataclasses
import threading
import zlib
from typing import Callable, Sequence

import numpy as np

from transformer_tpu_torch.config import ModelConfig
from transformer_tpu_torch.serve.resilience import fired, maybe_fail


class PrefixCorruptionError(RuntimeError):
    """A stored KV block failed its checksum at match time. The corrupt
    subtree has already been dropped and every pin taken by the failing
    match released — the caller (scheduler admission) records a
    prefix-cache breaker failure and serves the request by full prefill,
    so a flipped bit degrades throughput, never answers."""


def _block_crc(blocks: list[dict[str, np.ndarray]]) -> int:
    """crc32 over one block's buffers in a deterministic (layer, key)
    order — the integrity tag that turns silent KV corruption (bit rot, a
    bad DMA) into a detected fault."""
    crc = 0
    for layer in blocks:
        for key in sorted(layer):
            crc = zlib.crc32(np.ascontiguousarray(layer[key]).tobytes(), crc)
    return crc


class _Node:
    """One trie node = one KV block: per-layer buffer rows for the
    ``block_tokens`` positions this node's depth covers, for every prompt
    sharing the root-to-here token path. With the device tier attached
    (paged serving), a node may instead (or additionally) hold
    ``device_block`` — a refcounted id into the serving pool's
    device-resident block pool (``kernels/kv_pool.py``); hits on such
    nodes restore by block-table aliasing with zero host<->device
    copies, and the host ``blocks`` form is materialized lazily on spill."""

    __slots__ = (
        "children", "parent", "edge", "blocks", "nbytes", "last_used",
        "refs", "crc", "device_block",
    )

    def __init__(self, parent: "_Node | None", edge: tuple[int, ...]):
        self.children: dict[tuple[int, ...], _Node] = {}
        self.parent = parent
        self.edge = edge
        self.blocks: list[dict[str, np.ndarray]] | None = None  # None = root
        self.nbytes = 0
        self.last_used = 0
        self.refs = 0
        self.crc = 0
        self.device_block: int | None = None


@dataclasses.dataclass
class PrefixHit:
    """A pinned match: ``tokens`` block-aligned prefix positions whose KV
    the trie holds. The matched nodes stay refcounted (eviction-proof)
    until ``release()`` — the scheduler releases right after the restore
    program is dispatched."""

    tokens: int
    _nodes: list[_Node]
    _cache: "PrefixCache"

    def stacked(self, cap_tokens: int) -> list[dict[str, np.ndarray]] | None:
        """The matched host blocks concatenated along the position axis
        and padded to a POWER-OF-TWO block count (clamped to
        ``cap_tokens``, the slot buffer length): per layer, (1, width, H,
        D) buffers in the host block format. The padded widths are few,
        O(log(max_total / block)); pad rows are zeros at positions ``>=
        tokens``, which the offset causal mask hides and the suffix
        prefill overwrites. Runs without the cache lock: the nodes are
        pinned and their blocks immutable. A dense-layout hit holds host
        blocks only (the device tier needs the paged pool)."""
        if not self._nodes:
            return None
        B = self._cache.block_tokens
        blocks = len(self._nodes)
        padded = 1
        while padded < blocks:
            padded *= 2
        width = min(padded * B, cap_tokens)
        out: list[dict[str, np.ndarray]] = []
        for layer in range(len(self._nodes[0].blocks)):
            per_key: dict[str, np.ndarray] = {}
            for key in self._nodes[0].blocks[layer]:
                parts = [n.blocks[layer][key] for n in self._nodes]
                if width > blocks * B:
                    shape = list(parts[0].shape)
                    shape[1] = width - blocks * B
                    parts.append(np.zeros(shape, dtype=parts[0].dtype))
                per_key[key] = np.concatenate(parts, axis=1)
            out.append(per_key)
        return out

    def paged_plan(self) -> "list[tuple[_Node, int | None, list | None]]":
        """Per matched node, the paged restore source: ``(node,
        device_block_id, host_blocks)`` — alias the device block when one
        exists (zero copies), else scatter-write the host payload into a
        fresh pool block (the scheduler then re-adopts it via
        :meth:`PrefixCache.adopt_device`, so the NEXT hit aliases). Safe
        without the lock: the nodes are pinned, pinned nodes are never
        spilled (``release_device_blocks`` skips them) or evicted, and
        both payload forms are immutable while attached."""
        return [(n, n.device_block, n.blocks) for n in self._nodes]

    def release(self) -> None:
        with self._cache._lock:
            for node in self._nodes:
                node.refs -= 1
        self._nodes = []


class PrefixCache:
    """Host-side radix-trie store of prompt-prefix KV blocks.

    ``match``/``insert`` are the whole scheduler-facing surface; both are
    plain host code (numpy + dicts) driven at admission/retirement
    boundaries. ``stats`` is cache-level introspection (block/eviction
    counts); hit-token accounting lives in the SCHEDULER's stats and
    telemetry counters (``serve_prefix_hit_tokens_total``), which count
    only hits whose admission actually succeeded.

    SCOPE: one cache per serving process — blocks are keyed by token ids
    alone, so every scheduler sharing an instance must serve the SAME
    params and cache layout (a serve process has exactly one of each;
    sharing across different weights would silently restore the wrong
    model's K/V)."""

    def __init__(
        self,
        cfg: ModelConfig,
        *,
        block_tokens: int = 16,
        budget_mb: int = 64,
        verify_checksums: bool = True,
    ):
        if cfg.attention_window:
            raise ValueError(
                "prefix cache cannot serve a rolling-window cache "
                "(attention_window): block restore addresses buffer rows by "
                "absolute position, which a rolling buffer evicts on wrap — "
                "the same policy that refuses speculative rollback"
            )
        if block_tokens < 1:
            raise ValueError(f"block_tokens must be >= 1, got {block_tokens}")
        if budget_mb < 1:
            raise ValueError(f"budget_mb must be >= 1, got {budget_mb}")
        self.cfg = cfg
        self.block_tokens = block_tokens
        self.budget_bytes = budget_mb * (1 << 20)
        self.verify_checksums = verify_checksums
        # The threading contract: one lock for every trie mutation (match,
        # insert, evict, pin/release) and the byte/stats accounting.
        self._lock = threading.Lock()
        self._root = _Node(None, ())
        self._clock = 0
        self._bytes = 0
        self._bytes_per_block = 0  # learned from the first inserted block
        # Device-resident tier: the pool allocator whose refcounts device
        # blocks live under, and the reader that fetches one block to host
        # format (spill). Attached by the scheduler via attach_device_pool;
        # None = host-only.
        self._pool = None
        self._device_reader = None
        self.stats = {
            "blocks": 0,
            "inserted_blocks": 0,
            "evicted_blocks": 0,
            "corrupt_blocks": 0,
            "device_blocks": 0,
            "spilled_blocks": 0,
        }

    # ---- device-resident tier (paged serving) -----------------------------

    def attach_device_pool(self, pool, reader) -> None:
        """Enable the device tier: ``pool`` is the serving scheduler's
        ``kernels.kv_pool.KVPool`` (the refcount authority for device
        blocks) and ``reader(block_id)`` fetches one pool block to the
        host block format (used only for spill under pressure — the hit
        path is pure table aliasing)."""
        with self._lock:
            self._pool = pool
            self._device_reader = reader

    def insert_device(
        self, ids: Sequence[int], n_tokens: int, block_ids: Sequence[int]
    ) -> int:
        """Adopt a retiring slot's device blocks for the first
        ``floor(n_tokens / B) * B`` positions of ``ids``: each missing
        trie node takes a pool reference on its block (``block_ids[j]``)
        — NO device read, NO host copy. Nodes the trie already holds just
        refresh recency (and adopt the device id if they were host-only).
        Returns 0 (the host byte budget is untouched)."""
        maybe_fail("prefix.insert")
        B = self.block_tokens
        with self._lock:
            if self._pool is None:
                raise RuntimeError(
                    "insert_device needs an attached device pool "
                    "(attach_device_pool)"
                )
            self._clock += 1
            node = self._root
            for j in range(n_tokens // B):
                key = tuple(ids[j * B : (j + 1) * B])
                child = node.children.get(key)
                if child is None:
                    child = _Node(node, key)
                    node.children[key] = child
                if child.device_block is None:
                    self._pool.retain(int(block_ids[j]))
                    child.device_block = int(block_ids[j])
                    self.stats["device_blocks"] += 1
                child.last_used = self._clock
                node = child
        return 0

    def adopt_device(self, node: _Node, block_id: int) -> None:
        """Attach a freshly written pool block to a (host-tier) node the
        scheduler just restored through it — the next hit on this node
        aliases instead of paying the host copy again. No-op when the
        node already carries a device block."""
        with self._lock:
            if self._pool is None or node.device_block is not None:
                return
            self._pool.retain(int(block_id))
            node.device_block = int(block_id)
            self.stats["device_blocks"] += 1

    def host_blocks_for(self, node: _Node) -> "list[dict[str, np.ndarray]]":
        """A node's KV payload in host block format: the stored host
        blocks when present, else an ephemeral device read. Caller must
        hold a pin on the node (a live ``PrefixHit``)."""
        if node.blocks is not None:
            return node.blocks
        reader = self._device_reader
        if node.device_block is None or reader is None:
            raise ValueError("node holds neither host nor device blocks")
        return [
            {k: np.asarray(v) for k, v in layer.items()}
            for layer in reader(node.device_block)
        ]

    def release_device_blocks(self, want_free: int, spill: bool = True) -> int:
        """Release LRU unpinned device-tier blocks until the pool freed
        ``want_free`` of them (or candidates run out). With ``spill``,
        each block's data is read back to host first and kept under the
        host byte budget when it fits (the host format — nothing is lost
        unless the host budget is also full). Returns pool blocks
        actually freed (a block still aliased by a live slot releases the
        tier's reference but frees nothing yet)."""
        freed = 0
        while freed < want_free:
            with self._lock:
                victim = None
                stack = [self._root]
                while stack:
                    n = stack.pop()
                    stack.extend(n.children.values())
                    if (
                        n.device_block is not None
                        and n.refs == 0
                        and (victim is None or n.last_used < victim.last_used)
                    ):
                        victim = n
                if victim is None:
                    break
                bid = victim.device_block
                reader = self._device_reader
                pool = self._pool
                need_spill = spill and victim.blocks is None
            host = None
            if need_spill and reader is not None:
                try:
                    # Device read outside the lock: the victim is
                    # re-checked after reacquiring — a peer that raced us
                    # simply wins.
                    host = [
                        {k: np.asarray(v) for k, v in layer.items()}
                        for layer in reader(bid)
                    ]
                except Exception:  # noqa: BLE001 — spill is best-effort: an unreadable block is dropped (the tier must still shrink under pool pressure), and the next admission of that prefix prefills in full
                    host = None
            with self._lock:
                if victim.device_block != bid or victim.refs:
                    continue  # raced: re-scan
                victim.device_block = None
                self.stats["device_blocks"] -= 1
                if host is not None and victim.blocks is None:
                    nbytes = sum(
                        a.nbytes for layer in host for a in layer.values()
                    )
                    if self._bytes_per_block == 0:
                        self._bytes_per_block = nbytes
                    if self._make_room(nbytes) is not None:
                        victim.blocks = host
                        victim.nbytes = nbytes
                        victim.crc = _block_crc(host)
                        self._bytes += nbytes
                        self.stats["blocks"] += 1
                        self.stats["spilled_blocks"] += 1
                if victim.blocks is None and not victim.children:
                    parent = victim.parent
                    if parent is not None and (
                        parent.children.get(victim.edge) is victim
                    ):
                        del parent.children[victim.edge]
            if pool is not None and pool.release(bid):
                freed += 1
        return freed

    # ---- matching ---------------------------------------------------------

    def match(self, ids: Sequence[int]) -> PrefixHit:
        """Longest block-aligned prefix of ``ids`` the trie holds. Callers
        pass the prompt MINUS its last token (``ids[:L-1]``): at least one
        token must still go through the model forward — the admission pick
        needs next-token logits, and a restore produces none. The matched
        nodes leave pinned (refcounted under the lock), so a concurrent
        insert's eviction can never free blocks the caller is about to
        restore.

        Every matched block's crc32 is re-verified (outside the lock — the
        pins make that safe) before the hit is returned: a corrupt block
        drops its whole subtree and raises :class:`PrefixCorruptionError`
        with zero pins left outstanding, so bit rot in stored KV can never
        be silently restored into a slot. ``verify_checksums=False`` at
        construction trades that guarantee back for the crc pass.

        Fault points: ``prefix.match`` raises before the walk;
        ``prefix.corrupt`` flips one byte of the first matched HOST block
        (device-tier blocks have no host bytes), which the checksum pass
        must then catch."""
        maybe_fail("prefix.match")
        B = self.block_tokens
        with self._lock:
            self._clock += 1
            node, nodes = self._root, []
            for j in range(len(ids) // B):
                child = node.children.get(tuple(ids[j * B : (j + 1) * B]))
                if child is None or (
                    # A data-less structural node (its payload was spilled
                    # away and dropped) ends the match: positions past the
                    # hole cannot be restored from either tier.
                    child.blocks is None and child.device_block is None
                ):
                    break
                child.last_used = self._clock
                child.refs += 1
                nodes.append(child)
                node = child
        corrupt_target = next((n for n in nodes if n.blocks is not None), None)
        if corrupt_target is not None and fired("prefix.corrupt"):
            layer = corrupt_target.blocks[0]
            key = next(iter(sorted(layer)))
            arr = layer[key]
            raw = np.frombuffer(arr.tobytes(), np.uint8).copy()
            raw[0] ^= 0xFF
            layer[key] = np.frombuffer(raw.tobytes(), arr.dtype).reshape(arr.shape)
        if self.verify_checksums:
            for bad in nodes:
                if bad.blocks is None:
                    continue  # device-resident: no host bytes to verify
                if _block_crc(bad.blocks) == bad.crc:
                    continue
                with self._lock:
                    for n in nodes:
                        n.refs -= 1
                    self.stats["corrupt_blocks"] += 1
                    self._drop_subtree(bad)
                raise PrefixCorruptionError(
                    f"prefix-cache block at depth {nodes.index(bad) + 1} "
                    "failed its checksum; the corrupt subtree was dropped "
                    "(or deferred until a peer's pins release)"
                )
        return PrefixHit(tokens=len(nodes) * B, _nodes=nodes, _cache=self)

    def _drop_subtree(self, node: _Node) -> None:
        """Detach ``node`` (and everything under it — descendants are
        unreachable once their ancestor is gone) after a checksum failure.
        A subtree holding ANY peer pin is left in place instead: a
        mid-insert peer has unlocked to fetch a block and will re-attach
        under this path — detaching it now would let that attach land on an
        unreachable parent, leaking byte-budget accounting forever (the
        exact invariant ``insert``'s descend-path pinning documents). The
        corrupt block stays detectable, so the next unpinned match drops
        it. Idempotent under races: only the thread that actually detaches
        adjusts the byte/stat accounting. Caller holds ``self._lock``."""
        if node.parent is None or node.parent.children.get(node.edge) is not node:
            return  # a peer's verify already dropped it
        stack, subtree = [node], []
        while stack:
            n = stack.pop()
            subtree.append(n)
            stack.extend(n.children.values())
        if any(n.refs for n in subtree):
            return  # pinned by a peer (mid-insert/mid-restore): defer
        del node.parent.children[node.edge]
        for n in subtree:
            if n.blocks is not None:
                self._bytes -= n.nbytes
                self.stats["blocks"] -= 1
            if n.device_block is not None:
                # cache lock -> pool lock is the ONE nesting order
                # (never reversed anywhere), so no lock-order cycle.
                if self._pool is not None:
                    self._pool.release(n.device_block)
                n.device_block = None
                self.stats["device_blocks"] -= 1

    # ---- insertion + eviction --------------------------------------------

    def insert(
        self,
        ids: Sequence[int],
        n_tokens: int,
        read_block: Callable[[int], list[dict[str, np.ndarray]]],
    ) -> int:
        """Store the first ``floor(n_tokens / B) * B`` positions of ``ids``,
        fetching ONLY the blocks the trie is missing via ``read_block(start)
        -> per-layer host buffers``.
        Evicts LRU unpinned leaves to stay under the byte budget; a block
        that cannot fit (everything else pinned or interior) is dropped,
        never force-stored. Returns the number of blocks evicted.

        The device->host fetch runs outside the lock (blocking under a lock
        would stall every peer); the trie is re-checked after reacquiring,
        so a peer thread that stored the same block first simply wins and
        the duplicate fetch is discarded. The descend path stays pinned
        across the unlock — the parent a new block attaches to can never be
        evicted mid-fetch."""
        maybe_fail("prefix.insert")
        B = self.block_tokens
        node, evicted, pinned = self._root, 0, []
        with self._lock:
            self._clock += 1
        try:
            for j in range(n_tokens // B):
                key = tuple(ids[j * B : (j + 1) * B])
                with self._lock:
                    child = node.children.get(key)
                    if child is not None:
                        # Pin the WHOLE descend path (existing nodes
                        # included): the current node is a childless leaf
                        # right up to the moment its child is attached, so
                        # an unpinned one could be evicted by a peer's
                        # _make_room — and the next block would then hang
                        # off a detached parent, unreachable by any match
                        # yet still counted in the byte budget.
                        child.last_used = self._clock
                        child.refs += 1
                        pinned.append(child)
                        node = child
                        continue
                    if self._bytes_per_block and not self._can_fit(
                        self._bytes_per_block
                    ):
                        break  # budget unreachable: don't even fetch
                blocks = [
                    {k: np.asarray(v) for k, v in layer.items()}
                    for layer in read_block(j * B)
                ]
                nbytes = sum(
                    a.nbytes for layer in blocks for a in layer.values()
                )
                with self._lock:
                    child = node.children.get(key)
                    if child is None:
                        self._bytes_per_block = nbytes
                        freed = self._make_room(nbytes)
                        if freed is None:
                            break  # budget unreachable now: drop the tail
                        evicted += freed
                        child = _Node(node, key)
                        child.blocks = blocks
                        child.nbytes = nbytes
                        child.crc = _block_crc(blocks)
                        node.children[key] = child
                        self._bytes += nbytes
                        self.stats["blocks"] += 1
                        self.stats["inserted_blocks"] += 1
                    child.last_used = self._clock
                    child.refs += 1
                    pinned.append(child)
                    node = child
        finally:
            with self._lock:
                for child in pinned:
                    child.refs -= 1
                self.stats["evicted_blocks"] += evicted
        return evicted

    def _can_fit(self, nbytes: int) -> bool:
        """Whether ``_make_room`` could possibly admit ``nbytes`` more:
        budget headroom plus everything its leaf-first cascade could evict
        (a node is unevictable iff it or ANY descendant is pinned — an
        unpinned chain evicts leaf by leaf). Checked BEFORE fetching a
        block off the device so an unreachable budget never pays the
        device->host copy it is about to drop. Caller holds
        ``self._lock``."""
        if nbytes > self.budget_bytes:
            return False

        def retained(n: _Node) -> int:
            kept = sum(retained(c) for c in n.children.values())
            if kept or n.refs:
                kept += n.nbytes
            return kept

        return retained(self._root) + nbytes <= self.budget_bytes

    def _make_room(self, nbytes: int) -> int | None:
        """Evict LRU unpinned childless nodes until ``nbytes`` more fits
        under the budget. Returns blocks evicted, or None when the budget
        cannot be met (every candidate pinned/interior, or the block alone
        exceeds the whole budget). O(n) scan per eviction — the trie holds
        at most budget/block_bytes nodes, and this runs at retirement
        boundaries, never on the decode hot path. Caller holds
        ``self._lock``."""
        if nbytes > self.budget_bytes:
            return None
        evicted = 0
        while self._bytes + nbytes > self.budget_bytes:
            victim = dev_victim = None
            stack = [self._root]
            while stack:
                n = stack.pop()
                stack.extend(n.children.values())
                if n.children or n.refs:
                    continue
                if n.blocks is not None:
                    if victim is None or n.last_used < victim.last_used:
                        victim = n
                elif n.device_block is not None:
                    # Device-only leaves free no host bytes; they are
                    # fallback victims only when they structurally block
                    # every host-byte chain from becoming childless.
                    if (
                        dev_victim is None
                        or n.last_used < dev_victim.last_used
                    ):
                        dev_victim = n
            if victim is None:
                victim = dev_victim
            if victim is None:
                return None
            del victim.parent.children[victim.edge]
            if victim.blocks is not None:
                self._bytes -= victim.nbytes
                self.stats["blocks"] -= 1
                evicted += 1
            if victim.device_block is not None:
                if self._pool is not None:
                    self._pool.release(victim.device_block)
                victim.device_block = None
                self.stats["device_blocks"] -= 1
        return evicted

    def hot_prefixes(self, limit: int = 8) -> "list[tuple[int, ...]]":
        """The ``limit`` most recently used maximal stored prefixes, as
        token-id tuples (each a whole root-to-leaf block path): what a
        fleet replica exports to warm a respawned peer
        (``serve/replica.py`` ``export_state``). Injecting a leaf path
        stores every block along it, so the leaves cover the whole trie.
        Recency is the leaf's ``last_used``, the clock eviction reads. The
        payloads are read later through :meth:`match`, which verifies and
        pins as usual."""
        leaves: list[tuple[int, tuple[int, ...]]] = []
        with self._lock:
            stack = [(self._root, ())]
            while stack:
                node, path = stack.pop()
                if not node.children and (
                    node.blocks is not None or node.device_block is not None
                ):
                    leaves.append((node.last_used, path))
                for child in node.children.values():
                    stack.append((child, path + child.edge))
        leaves.sort(key=lambda t: -t[0])
        return [path for _, path in leaves[: max(0, limit)]]

    # ---- introspection ----------------------------------------------------

    @property
    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes

    def block_count(self) -> int:
        with self._lock:
            return self.stats["blocks"]

    def outstanding_refs(self) -> int:
        """Total pins across the trie — 0 whenever no admission is
        mid-restore and no insert is mid-fetch (a leaked pin would make its
        block immortal under eviction)."""
        with self._lock:
            total, stack = 0, [self._root]
            while stack:
                n = stack.pop()
                stack.extend(n.children.values())
                total += n.refs
            return total
