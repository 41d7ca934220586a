"""The resource cost model of the port's programs: bytes, FLOPs, collectives.

Port of ``transformer_tpu/analysis/costs.py``. Where JAX traces a program
with ``jax.make_jaxpr`` over abstract inputs, the port runs it on the
``meta`` device under a ``TorchDispatchMode`` that sees every aten op,
the backward's and a rematerialized layer's recompute included. Nothing
is executed (a meta tensor has shape and dtype, no storage), so no card
is needed: this is JAX's "zero device execution", not a CPU fallback.
Every canned program (the scheduler's dense, gathered-view and kernel
step forwards, its prefills, verify and restore, and the train step) is
measured:

- **peak_bytes** — peak live-buffer bytes: the tensors the caller passes
  in are held for the whole program, once each. A buffer the program
  updates in place (the KV pools; the parameters and optimizer state of
  ``train/state.py``'s ``step_``) therefore counts once, which is the
  port's form of JAX's ``donate_argnums``. Every other buffer counts from
  the op that makes it until Python frees it (eager torch frees a tensor
  when its last reference goes, so this is the eager program's own
  liveness, autograd's saved tensors included). Views and in-place ops
  allocate nothing: the aten schemas' alias annotations say which ops
  those are. This is a model of the caching allocator, not its watermark,
  as JAX's is not XLA's.
- **flops** — JAX's pricing rules: 2·M·N·K per matrix product (``mm``,
  ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``dot``; batch dims multiplied
  through), 2·|out|·(C_in/groups · prod(kernel)) per convolution,
  |operand| per reduction (a softmax is two reductions, its backward one).
- **bytes_moved** — Σ over the ops seen of operand + result bytes on the
  program's device; views move nothing and are not counted, nor is the
  allocation of an uninitialised buffer (``empty``). An upper-bound
  proxy for memory traffic, for regression deltas.
- **collectives** — the process-group collectives seen (empty on every
  one-card program).

**Kernels count once each.** A call to one of the six kernel wrappers
(``flash_fwd``, ``flash_ring_step``, ``flash_dq``, ``flash_dkdv``,
``paged_flash_attention``, ``fused_ln_ffn``) with meta operands returns
outputs of the right shapes and is priced as ONE operation of
``kernels.work``'s count for its operands (the count ``chip_smoke.py``'s
bounds read), not by the ops of its plain version: the port's form of
JAX pricing a ``pallas_call`` once over its operands. Without data, a
kernel's count takes every key as real and every table entry as visible.

**KV budgets** — ``kv_cache_bytes`` prices one slot's dense KV buffer per
cache variant, ``kv_pool_bytes`` the paged pool per slot.

**Baseline workflow** — ``analysis/costs_baseline.json`` stores every
program's gated numbers; ``python -m transformer_tpu_torch.analysis
costs`` fails when peak bytes or KV bytes per slot INCREASE, the
collective set grows, or a fused paged step stops moving fewer bytes than
its gather twin. FLOPs and bytes_moved are reported and diffed but not
gated. Aten op sets change between torch versions, so the baseline is
written, and checked, on one installation.

The sharded programs (ring/Ulysses attention, the tensor-parallel FFN,
the fsdp gather and the ``--mesh`` serving programs) are listed as
``skipped``, as JAX lists them on a host with one device, until
``analysis/sharding.py`` is ported; so is JAX's compiled-HLO collective
gate, which has no counterpart here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
from typing import Any, Callable, Iterable

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from transformer_tpu_torch.kernels import work as _work

_REDUCE_OPS = frozenset({
    "sum", "mean", "amax", "amin", "prod", "argmax", "argmin", "any", "all",
    "logsumexp", "nansum", "linalg_vector_norm", "norm", "var", "std",
    "var_mean", "std_mean",
})
# max/min reduce under these overloads (``max.other`` is elementwise).
_REDUCE_OVERLOADS = {"max": ("default", "dim"), "min": ("default", "dim")}
# A softmax is a max and a sum over its operand; its backward one sum.
_SOFTMAX_REDUCTIONS = {
    "_softmax": 2, "_log_softmax": 2,
    "_softmax_backward_data": 1, "_log_softmax_backward_data": 1,
}
_CONV_OPS = frozenset({"convolution", "_convolution", "convolution_overrideable"})
_COLLECTIVE_NAMESPACES = frozenset({"c10d", "_c10d_functional", "c10d_functional"})


@dataclasses.dataclass
class CostReport:
    """Resource profile of one traced program."""

    name: str
    peak_bytes: int
    flops: int
    bytes_moved: int
    collectives: dict[str, dict[str, int]]
    arg_bytes: int
    out_bytes: int
    extras: dict[str, Any] = dataclasses.field(default_factory=dict)
    # FLOPs by aten op name (``kernel:<wrapper>`` for a priced launch);
    # not part of the report's dict.
    flops_by_op: dict[str, int] = dataclasses.field(default_factory=dict, repr=False)

    @property
    def intensity(self) -> float:
        return round(self.flops / self.bytes_moved, 4) if self.bytes_moved else 0.0

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "peak_bytes": self.peak_bytes,
            "flops": self.flops,
            "bytes_moved": self.bytes_moved,
            "arithmetic_intensity": self.intensity,
            "collectives": self.collectives,
            "arg_bytes": self.arg_bytes,
            "out_bytes": self.out_bytes,
            **self.extras,
        }


# ==========================================================================
# per-op FLOPs


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def op_flops(func, args, out) -> int:
    """FLOPs of one aten op under JAX's rules (0 for the ops it does not
    price: elementwise work is a bandwidth story)."""
    name = func._schema.name.split("::")[-1]
    if name == "mm":
        a, b = args[0], args[1]
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    if name == "addmm":
        a, b = args[1], args[2]
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    if name in ("bmm", "baddbmm"):
        a, b = (args[0], args[1]) if name == "bmm" else (args[1], args[2])
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if name in ("mv", "addmv"):
        a = args[0] if name == "mv" else args[1]
        return 2 * a.shape[0] * a.shape[1]
    if name in ("dot", "vdot"):
        return 2 * args[0].numel()
    if name in _CONV_OPS:
        # weight (C_out, C_in/groups, *kernel): all but C_out is the
        # per-output multiply-add count.
        return 2 * out.numel() * _numel(args[1].shape[1:])
    if name in _REDUCE_OPS or func._overloadname in _REDUCE_OVERLOADS.get(name, ()):
        return args[0].numel()
    if name in _SOFTMAX_REDUCTIONS:
        return _SOFTMAX_REDUCTIONS[name] * args[0].numel()
    return 0


# ==========================================================================
# the trace


def _tensors(obj) -> Iterable[torch.Tensor]:
    """Every tensor in a tree of dicts, lists, tuples and dataclasses."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_bytes(tensors: Iterable[torch.Tensor]) -> dict[int, int]:
    """Unique storages (by identity) -> their bytes."""
    out: dict[int, int] = {}
    for t in tensors:
        st = t.untyped_storage()
        out[StorageWeakRef(st).cdata] = st.nbytes()
    return out


class _Trace(TorchDispatchMode):
    """Prices every aten op on ``device_type`` tensors while the program
    runs: FLOPs, bytes moved, collectives, and the live bytes of the
    buffers the program allocates (the caller's ``held`` storages aside)."""

    def __init__(self, held: set[int], device_type: str = "meta") -> None:
        super().__init__()
        self.held = held
        self.device_type = device_type
        self.flops = 0
        self.flops_by_op: dict[str, int] = {}
        self.moved = 0
        self.collectives: dict[str, dict[str, int]] = {}
        self.kernels: dict[str, dict[str, int]] = {}
        self.live: dict[int, tuple[StorageWeakRef, int]] = {}
        self.live_bytes = 0
        self.peak = 0
        self._in_kernel = 0

    @contextlib.contextmanager
    def kernel(self, name: str, work) -> Any:
        """A kernel launch: the ops inside allocate its outputs but are not
        priced; the launch is priced once as ``work``."""
        self._in_kernel += 1
        try:
            yield
        finally:
            self._in_kernel -= 1
        flops, nbytes = int(work.flops), int(work.nbytes)
        self._add_flops(f"kernel:{name}", flops)
        self.moved += nbytes
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes_moved": 0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes_moved"] += nbytes

    def _add_flops(self, op: str, flops: int) -> None:
        if flops:
            self.flops += flops
            self.flops_by_op[op] = self.flops_by_op.get(op, 0) + flops

    def _on_device(self, t) -> bool:
        return isinstance(t, torch.Tensor) and t.device.type == self.device_type

    def _free(self) -> None:
        for key in [k for k, (ref, _) in self.live.items() if ref.expired()]:
            self.live_bytes -= self.live.pop(key)[1]

    def _allocate(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        ref = StorageWeakRef(st)
        if ref.cdata in self.held or ref.cdata in self.live:
            return
        n = st.nbytes()
        self.live[ref.cdata] = (ref, n)
        self.live_bytes += n
        self.peak = max(self.peak, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._free()
        schema = func._schema
        name = schema.name.split("::")[-1]
        if func.namespace in _COLLECTIVE_NAMESPACES:
            c = self.collectives.setdefault(name, {"count": 0, "bytes": 0})
            c["count"] += 1
            c["bytes"] += sum(_nbytes(t) for t in tree_flatten((args, kwargs))[0]
                              if isinstance(t, torch.Tensor))
        rets = schema.returns
        view = bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                                  for r in rets)
        if not self._in_kernel and not view:
            self._add_flops(name, op_flops(func, args, out))
            if not name.startswith(("empty", "new_empty")):
                self.moved += sum(
                    _nbytes(t) for t in tree_flatten((args, kwargs, out))[0]
                    if self._on_device(t)
                )
        pairs = [(rets[0], out)] if len(rets) == 1 else zip(rets, out)
        for ret, value in pairs:
            if ret.alias_info is not None:
                continue
            for t in tree_flatten(value)[0]:
                if self._on_device(t):
                    self._allocate(t)
        return out


def program_costs(name: str, fn: Callable, *args) -> CostReport:
    """Run ``fn(*args)`` over ``meta`` tensors under the trace and price
    it. ``args`` are trees of meta tensors (dicts, lists, dataclasses) and
    plain values; the tensors in them are the caller's, held for the whole
    program."""
    held = _storage_bytes(t for t in _tensors(args) if t.device.type == "meta")
    trace = _Trace(set(held))
    _work.PRICERS.append(trace)
    try:
        with trace:
            out = fn(*args)
    finally:
        _work.PRICERS.remove(trace)
    report = CostReport(
        name=name,
        peak_bytes=int(sum(held.values()) + trace.peak),
        flops=int(trace.flops),
        bytes_moved=int(trace.moved),
        collectives=trace.collectives,
        arg_bytes=int(sum(held.values())),
        out_bytes=int(sum(_nbytes(t) for t in _tensors(out))),
        flops_by_op=trace.flops_by_op,
    )
    if trace.kernels:
        report.extras["kernels"] = trace.kernels
    return report


# ==========================================================================
# abstract inputs


def abstract_params(cfg, dtype: torch.dtype | None = None):
    """The model's parameters as ``meta`` tensors (``param_spec``'s shapes,
    in ``cfg.params_dtype`` or ``dtype``)."""
    from transformer_tpu_torch.models.transformer import param_spec, unflatten

    dtype = dtype or cfg.params_dtype
    return unflatten({
        key: torch.empty(shape, dtype=dtype, device="meta")
        for key, (shape, _) in param_spec(cfg).items()
    })


def serve_params(cfg):
    """The parameters as the scheduler serves them (``compute_params``:
    cast once to the compute dtype, LayerNorms kept), on ``meta``."""
    from transformer_tpu_torch.serve.scheduler import compute_params

    return compute_params(abstract_params(cfg), cfg, torch.device("meta"))


def dense_pool(cfg, num_slots: int, buf_len: int) -> list[dict]:
    """The dense layout's per-layer buffers, as the scheduler allocates
    them, on ``meta``."""
    from transformer_tpu_torch.models.decoder import init_decoder_caches

    return [
        {k: v for k, v in layer.items() if k != "index"}
        for layer in init_decoder_caches(cfg, num_slots, buf_len, device="meta")
    ]


def paged_pool(cfg, num_slots: int, buf_len: int, pool_blocks: int, block_tokens: int):
    """The paged pool's per-layer block buffers, the (N, slot_blocks)
    table and the (N,) positions, as the scheduler allocates them, on
    ``meta``."""
    from transformer_tpu_torch.ops.attention import init_block_pool

    pool = [
        init_block_pool(pool_blocks, block_tokens, cfg.kv_heads, cfg.head_dim,
                        cfg.compute_dtype, quantize=cfg.kv_cache_int8, device="meta")
        for _ in range(cfg.num_layers)
    ]
    slot_blocks = -(-buf_len // block_tokens)
    table = torch.empty((num_slots, slot_blocks), dtype=torch.int32, device="meta")
    index = torch.empty((num_slots,), dtype=torch.int32, device="meta")
    return pool, table, index


def _tokens(*shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.long, device="meta")


# ==========================================================================
# KV budgets


def kv_cache_bytes(cfg, max_total: int) -> dict[str, Any]:
    """Device bytes of ONE slot's dense KV cache (every per-position buffer
    in the cache's own storage layout: int8 codes + fp32 scales, GQA head
    counts, rolling-window buffer lengths), plus the per-token cost."""
    from transformer_tpu_torch.models.decoder import init_decoder_caches
    from transformer_tpu_torch.ops.attention import kv_buffer_keys

    caches = init_decoder_caches(cfg, 1, max_total, device="meta")
    per_slot = 0
    buf_len = max_total
    for layer in caches:
        for key in kv_buffer_keys(layer):
            per_slot += _nbytes(layer[key])
            buf_len = int(layer[key].shape[1])
    return {
        "bytes_per_slot": int(per_slot),
        "bytes_per_token": int(per_slot // max(1, buf_len)),
        "buffer_tokens": buf_len,
        "max_total": max_total,
        "layers": len(caches),
    }


def kv_pool_bytes(
    cfg, max_total: int, num_slots: int, pool_blocks: int, block_tokens: int
) -> dict[str, Any]:
    """Device bytes of the PAGED pool amortized per slot (pool bytes /
    slots): smaller than ``kv_cache_bytes`` whenever the pool is
    provisioned below ``slots x max_total``."""
    from transformer_tpu_torch.ops.attention import kv_buffer_keys

    pool, _, _ = paged_pool(cfg, num_slots, max_total, pool_blocks, block_tokens)
    total = sum(_nbytes(layer[key]) for layer in pool for key in kv_buffer_keys(layer))
    return {
        "bytes_per_slot": int(total // max(1, num_slots)),
        "bytes_per_token": int(total // max(1, pool_blocks * block_tokens)),
        "pool_bytes": int(total),
        "pool_blocks": pool_blocks,
        "block_tokens": block_tokens,
        "max_total": max_total,
        "layers": len(pool),
    }


# ==========================================================================
# canned programs (JAX's list, names and sizes)


_SERVE_SLOTS = 2
_SERVE_TOTAL = 32
_VERIFY_W = 4
_PREFILL_LEN = 8
_RESTORE_BLOCK = 4
# The paged pool is provisioned for HALF the dense worst case.
_PAGED_BLOCK = 8
_PAGED_POOL_BLOCKS = 1 + _SERVE_SLOTS * (_SERVE_TOTAL // 2 // _PAGED_BLOCK)

SERVE_VARIANTS = ("lm_bf16", "lm_int8_cache", "lm_window", "lm_gqa")
# The paged layout refuses rolling windows.
PAGED_VARIANTS = ("lm_bf16", "lm_int8_cache", "lm_gqa")

# JAX's sharded canned programs: skipped until analysis/sharding.py is
# ported (JAX skips them on a host with one device).
SHARDED_PROGRAMS = (
    "parallel.ring_attention[seq=2]",
    "parallel.ulysses_attention[seq=2]",
    "parallel.tp_ffn[model=2]",
    "parallel.fsdp_gather[fsdp=2]",
    "serve.pool_step[lm_bf16,mesh=2]",
    "serve.pool_verify[lm_bf16,W=4,mesh=2]",
    f"serve.slot_prefill[lm_bf16,n={_PREFILL_LEN},mesh=2]",
)


def pool_step_costs(name, cfg, slots: int, max_total: int) -> CostReport:
    """The dense layout's decode step (``scheduler._pool_step``, S_q 1)."""
    from transformer_tpu_torch.serve.scheduler import _pool_step

    return program_costs(
        name, lambda p, c, t, i: _pool_step(p, c, t, i, cfg),
        serve_params(cfg), dense_pool(cfg, slots, max_total), _tokens(slots, 1),
        torch.empty((slots,), dtype=torch.int32, device="meta"),
    )


def pool_step_paged_costs(name, cfg, slots: int, max_total: int, pool_blocks: int,
                          block_tokens: int, fused: bool, s_q: int = 1) -> CostReport:
    """The paged layout's step forward: gathered views (``_pool_step_paged``)
    or, ``fused``, the two kernels (``paged_decode_forward``, the
    ``--decode_kernel paged_flash`` step)."""
    from transformer_tpu_torch.models.paged_decode import paged_decode_forward
    from transformer_tpu_torch.serve.scheduler import _pool_step_paged

    pool, table, index = paged_pool(cfg, slots, max_total, pool_blocks, block_tokens)
    if fused:
        def program(p, c, tb, ix, t):
            return paged_decode_forward(p, t, c, tb, ix, cfg, block_tokens=block_tokens)[0]
    else:
        def program(p, c, tb, ix, t):
            return _pool_step_paged(p, c, t, tb, ix, cfg, block_tokens, max_total)
    return program_costs(name, program, serve_params(cfg), pool, table, index,
                         _tokens(slots, s_q))


SERVING_LAYOUTS = ("dense", "paged", "paged_flash")


def serving_step_costs(cfg, num_slots: int, max_total: int, block_tokens: int,
                       s_q: int = 1, layouts=SERVING_LAYOUTS) -> list[CostReport]:
    """The scheduler's step forward on each of ``layouts`` (dense,
    gathered views, the kernels) at a serving shape: ``num_slots`` slots
    of ``max_total`` rows, the paged pool in ``block_tokens``-token blocks
    provisioned as the scheduler does by default (every slot can reach
    ``max_total``). Each report's ``tokens_per_step`` is the slots' S_q
    rows; its name carries the shape. A kernel launch counts every table
    entry (no lengths without data), the most the step can read."""
    pool_blocks = 1 + num_slots * -(-max_total // block_tokens)
    shape = f"slots={num_slots},max_total={max_total},block={block_tokens}"
    reports = []
    for layout in layouts:
        if layout == "dense":
            r = pool_step_costs(f"serve.pool_step[{shape}]", cfg, num_slots, max_total)
        else:
            fused = layout == "paged_flash"
            prefix = "serve.pool_step_paged_flash" if fused else "serve.pool_step_paged"
            r = pool_step_paged_costs(f"{prefix}[{shape}]", cfg, num_slots, max_total,
                                      pool_blocks, block_tokens, fused, s_q)
        r.extras["tokens_per_step"] = num_slots * s_q
        reports.append(r)
    return reports


def canned_cost_reports() -> tuple[list[CostReport], list[str]]:
    """Cost reports for every canned program, plus the names skipped."""
    from transformer_tpu_torch.analysis.configs import FAST_MATRIX, TINY_TRAIN
    from transformer_tpu_torch.kernels.kv_pool import to_host
    from transformer_tpu_torch.models.decoder import init_decoder_caches
    from transformer_tpu_torch.ops.attention import slice_kv_blocks
    from transformer_tpu_torch.serve import scheduler as sched

    reports: list[CostReport] = []

    # -- the decode hot loop, per cache variant -----------------------------
    for variant in SERVE_VARIANTS:
        cfg = FAST_MATRIX[variant]
        r = pool_step_costs(f"serve.pool_step[{variant}]", cfg, _SERVE_SLOTS, _SERVE_TOTAL)
        r.extras["kv_bytes_per_slot"] = kv_cache_bytes(cfg, _SERVE_TOTAL)["bytes_per_slot"]
        reports.append(r)

    # -- the paged step: gathered views, then the kernels --------------------
    for fused, prefix in ((False, "serve.pool_step_paged"), (True, "serve.pool_step_paged_flash")):
        for variant in PAGED_VARIANTS:
            cfg = FAST_MATRIX[variant]
            r = pool_step_paged_costs(f"{prefix}[{variant}]", cfg, _SERVE_SLOTS, _SERVE_TOTAL,
                                      _PAGED_POOL_BLOCKS, _PAGED_BLOCK, fused)
            r.extras["kv_bytes_per_slot"] = kv_pool_bytes(
                cfg, _SERVE_TOTAL, _SERVE_SLOTS, _PAGED_POOL_BLOCKS, _PAGED_BLOCK
            )["bytes_per_slot"]
            reports.append(r)

    cfg = FAST_MATRIX["lm_bf16"]
    params = serve_params(cfg)
    pool, table, _ = paged_pool(cfg, _SERVE_SLOTS, _SERVE_TOTAL, _PAGED_POOL_BLOCKS,
                                _PAGED_BLOCK)
    reports.append(program_costs(
        f"serve.slot_prefill_paged[lm_bf16,n={_PREFILL_LEN}]",
        lambda p, c, row, pr: sched._slot_prefill_paged(
            p, c, row, pr, 0, cfg, 0, _PAGED_BLOCK, _SERVE_TOTAL),
        params, pool, table[:1], _tokens(1, _PREFILL_LEN),
    ))

    # -- admission, verify, restore (the plain variant) ---------------------
    pool = dense_pool(cfg, _SERVE_SLOTS, _SERVE_TOTAL)
    reports.append(program_costs(
        f"serve.slot_prefill[lm_bf16,n={_PREFILL_LEN}]",
        lambda p, c, pr: sched._slot_prefill(p, c, 0, pr, 0, cfg, 0),
        params, pool, _tokens(1, _PREFILL_LEN),
    ))
    reports.append(program_costs(
        f"serve.pool_verify[lm_bf16,W={_VERIFY_W}]",
        lambda p, c, t, i: sched._pool_step(p, c, t, i, cfg),
        params, pool, _tokens(_SERVE_SLOTS, _VERIFY_W),
        torch.empty((_SERVE_SLOTS,), dtype=torch.int32, device="meta"),
    ))
    blocks = [
        {key: to_host(rows) for key, rows in slice_kv_blocks(c, 0, _RESTORE_BLOCK).items()}
        for c in init_decoder_caches(cfg, 1, _SERVE_TOTAL)
    ]
    reports.append(program_costs(
        f"serve.slot_restore[lm_bf16,blocks={_RESTORE_BLOCK}]",
        lambda c, b: sched._slot_restore(c, 0, b),
        pool, blocks,
    ))

    # -- the train step -----------------------------------------------------
    reports.append(train_step_costs(cfg, TINY_TRAIN, name="train.step[lm_bf16]"))
    return reports, list(SHARDED_PROGRAMS)


def train_step_costs(cfg, train_cfg, name: str = "train.step") -> CostReport:
    """One optimizer step of ``make_train_step`` (``core``: forward,
    backward, the optimizer's in-place update) over a ``meta`` train
    state: the prediction the trainer emits as ``train.predicted`` and
    ``obs summarize`` holds against the allocator's peak."""
    from transformer_tpu_torch.train.state import create_train_state, make_optimizer
    from transformer_tpu_torch.train.trainer import make_train_step

    tx = make_optimizer(cfg, train_cfg)
    state = create_train_state(cfg, train_cfg, params=abstract_params(cfg))
    step = make_train_step(cfg, train_cfg, tx=tx)
    B, L = train_cfg.batch_size, train_cfg.sequence_length
    src = _tokens(B, L) if step.uses_src else None
    scalars = torch.empty((step.scalars(state).shape[1],), dtype=torch.float32,
                          device="meta")
    r = program_costs(name, lambda s, x, y, c: step.core(s, x, y, c)[1],
                      state, src, _tokens(B, L), scalars)
    r.extras["tokens_per_step"] = B * L
    return r


# ==========================================================================
# baseline workflow


def default_costs_baseline_path() -> str:
    from transformer_tpu_torch.analysis.baselines import _package_root

    return os.path.join(_package_root(), "analysis", "costs_baseline.json")


def load_costs_baseline(path: str | None) -> dict:
    if path is None or not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def write_costs_baseline(
    reports: list[CostReport],
    kv: dict[str, dict],
    path: str,
    keep: dict[str, dict] | None = None,
) -> None:
    """Write the budget baseline. ``keep`` carries forward existing program
    entries that this host could not reproduce (skipped)."""
    payload = {
        "programs": {
            **(keep or {}),
            **{r.name: {
                "peak_bytes": r.peak_bytes,
                "flops": r.flops,
                "bytes_moved": r.bytes_moved,
                "collectives": {
                    k: v["count"] for k, v in sorted(r.collectives.items())
                },
                **(
                    {"kv_bytes_per_slot": r.extras["kv_bytes_per_slot"]}
                    if "kv_bytes_per_slot" in r.extras
                    else {}
                ),
            }
                for r in reports
            },
        },
        "kv_cache": {
            variant: {
                "bytes_per_slot": entry["bytes_per_slot"],
                "bytes_per_token": entry["bytes_per_token"],
            }
            for variant, entry in sorted(kv.items())
        },
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")


@dataclasses.dataclass
class CostsResult:
    reports: list[CostReport]
    kv: dict[str, dict]
    skipped: list[str]
    regressions: list[str]
    notes: list[str]

    @property
    def ok(self) -> bool:
        return not self.regressions

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "programs": [r.to_dict() for r in self.reports],
            "kv_cache": self.kv,
            "skipped": self.skipped,
            "regressions": self.regressions,
            "notes": self.notes,
        }


def compare_to_baseline(
    reports: list[CostReport],
    kv: dict[str, dict],
    baseline: dict,
    skipped: Iterable[str] = (),
) -> tuple[list[str], list[str]]:
    """(regressions, notes). Gated: program peak_bytes increases, KV
    bytes-per-slot/-token increases, collective-set growth, lost or
    unbaselined coverage, and a fused paged step that no longer moves fewer
    bytes than its gather twin. Advisory: decreases and FLOP /
    bytes_moved drift in either direction."""
    regressions: list[str] = []
    notes: list[str] = []
    base_programs = baseline.get("programs", {})
    seen = set()
    for r in reports:
        seen.add(r.name)
        base = base_programs.get(r.name)
        if base is None:
            regressions.append(
                f"{r.name}: not in the baseline — new programs must be "
                "budgeted (run --update-baseline and commit the diff)"
            )
            continue
        if r.peak_bytes > base["peak_bytes"]:
            regressions.append(
                f"{r.name}: peak_bytes {r.peak_bytes} > budget "
                f"{base['peak_bytes']} (+{r.peak_bytes - base['peak_bytes']})"
            )
        elif r.peak_bytes < base["peak_bytes"]:
            notes.append(
                f"{r.name}: peak_bytes improved {base['peak_bytes']} -> "
                f"{r.peak_bytes} (--update-baseline to bank it)"
            )
        kv_budget = base.get("kv_bytes_per_slot")
        kv_now = r.extras.get("kv_bytes_per_slot")
        if kv_budget is not None and kv_now is not None and kv_now > kv_budget:
            regressions.append(
                f"{r.name}: kv_bytes_per_slot {kv_now} > budget {kv_budget}"
            )
        base_coll = base.get("collectives", {})
        now_coll = {k: v["count"] for k, v in r.collectives.items()}
        for key, count in sorted(now_coll.items()):
            if key not in base_coll:
                regressions.append(
                    f"{r.name}: stray collective {key} (x{count}) — not in "
                    "the budgeted set"
                )
            elif count > base_coll[key]:
                regressions.append(
                    f"{r.name}: collective {key} count {count} > budget "
                    f"{base_coll[key]}"
                )
        for key in sorted(set(base_coll) - set(now_coll)):
            notes.append(f"{r.name}: collective {key} no longer issued")
        for field in ("flops", "bytes_moved"):
            now, was = getattr(r, field), base.get(field)
            if was is not None and now != was:
                notes.append(f"{r.name}: {field} {was} -> {now} (advisory)")
    # Structural fusion gate: every fused paged step must move strictly
    # fewer bytes than its gather twin (the gathered view's pass over the
    # pool is what the kernels remove), whatever the baseline says.
    by_name = {r.name: r for r in reports}
    for name in sorted(by_name):
        if not name.startswith("serve.pool_step_paged_flash["):
            continue
        twin = by_name.get(
            name.replace("pool_step_paged_flash", "pool_step_paged")
        )
        if twin is not None and by_name[name].bytes_moved >= twin.bytes_moved:
            regressions.append(
                f"{name}: bytes_moved {by_name[name].bytes_moved} >= gather "
                f"twin's {twin.bytes_moved} ({twin.name}) — the fused kernel "
                "no longer eliminates the gathered-view pass"
            )
    skipped = set(skipped)
    for name in sorted(set(base_programs) - seen):
        if name in skipped:
            notes.append(f"{name}: skipped (the sharded programs are not ported yet)")
        else:
            regressions.append(
                f"{name}: in the baseline but no longer produced — budget "
                "coverage lost"
            )
    base_kv = baseline.get("kv_cache", {})
    for variant, entry in sorted(kv.items()):
        base_entry = base_kv.get(variant)
        if base_entry is None:
            regressions.append(
                f"kv_cache[{variant}]: not in the baseline — run "
                "--update-baseline"
            )
            continue
        for field in ("bytes_per_slot", "bytes_per_token"):
            if entry[field] > base_entry[field]:
                regressions.append(
                    f"kv_cache[{variant}]: {field} {entry[field]} > budget "
                    f"{base_entry[field]}"
                )
            elif entry[field] < base_entry[field]:
                notes.append(
                    f"kv_cache[{variant}]: {field} improved "
                    f"{base_entry[field]} -> {entry[field]}"
                )
    return regressions, notes


def kv_budgets() -> dict[str, dict]:
    """Every serving variant's dense KV bytes, and the paged pool's."""
    from transformer_tpu_torch.analysis.configs import FAST_MATRIX

    kv = {
        variant: kv_cache_bytes(FAST_MATRIX[variant], _SERVE_TOTAL)
        for variant in SERVE_VARIANTS
    }
    kv.update({
        f"{variant}_paged": kv_pool_bytes(
            FAST_MATRIX[variant], _SERVE_TOTAL, _SERVE_SLOTS,
            _PAGED_POOL_BLOCKS, _PAGED_BLOCK,
        )
        for variant in PAGED_VARIANTS
    })
    return kv


def run_costs(
    baseline_path: str | None = None, compare: bool = True
) -> CostsResult:
    """Compute every canned cost report + KV budget and (optionally) diff
    against the checked-in baseline."""
    reports, skipped = canned_cost_reports()
    kv = kv_budgets()
    regressions: list[str] = []
    notes: list[str] = []
    if compare:
        if baseline_path is None:
            baseline_path = default_costs_baseline_path()
        baseline = load_costs_baseline(baseline_path)
        if baseline:
            regressions, notes = compare_to_baseline(reports, kv, baseline, skipped)
        else:
            notes.append(
                f"no baseline at {baseline_path} — run --update-baseline "
                "to pin budgets"
            )
    return CostsResult(
        reports=reports, kv=kv, skipped=skipped,
        regressions=regressions, notes=notes,
    )


def summarize(result: CostsResult) -> str:
    lines = []
    for r in result.reports:
        coll = (
            ", ".join(f"{k} x{v['count']}" for k, v in sorted(r.collectives.items()))
            or "none"
        )
        lines.append(
            f"{r.name}: peak {_fmt_bytes(r.peak_bytes)}, "
            f"{_fmt_count(r.flops)} FLOPs, {_fmt_bytes(r.bytes_moved)} moved "
            f"(intensity {r.intensity}), collectives: {coll}"
        )
    for variant, entry in sorted(result.kv.items()):
        if "pool_blocks" in entry:
            geom = (
                f"pool {entry['pool_blocks']} x {entry['block_tokens']}-token "
                f"blocks, max_total {entry['max_total']}"
            )
        else:
            geom = (
                f"buffer {entry['buffer_tokens']} of max_total "
                f"{entry['max_total']}"
            )
        lines.append(
            f"kv_cache[{variant}]: {_fmt_bytes(entry['bytes_per_slot'])}/slot, "
            f"{_fmt_bytes(entry['bytes_per_token'])}/token ({geom})"
        )
    for s in result.skipped:
        lines.append(f"SKIP {s} (sharded: not ported yet)")
    for n in result.notes:
        lines.append(f"note: {n}")
    for reg in result.regressions:
        lines.append(f"REGRESSION: {reg}")
    lines.append(
        f"{len(result.reports)} program(s), {len(result.regressions)} "
        f"regression(s)"
    )
    return "\n".join(lines)


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n}B"
        n /= 1024
    return f"{n}B"


def _fmt_count(n: int) -> str:
    for unit in ("", "K", "M", "G", "T"):
        if abs(n) < 1000 or unit == "T":
            return f"{n:.1f}{unit}" if unit else str(n)
        n /= 1000
    return str(n)
