"""Retrace sentinel: the steady-state serving and training paths capture no
new CUDA graph.

Port of ``transformer_tpu/analysis/retrace.py``. JAX's counterpart of a
step graph is a compiled program, counted by each jitted function's
``_cache_size()``. The port captures one CUDA graph per step signature:
``serve/graph.py``'s ``CapturedForward`` per (slots, S_q, table width) of
the scheduler's step forward, ``train/graph.py``'s ``CapturedStep`` per
batch shape. A shape that stops bucketing, or a step width that varies,
costs a capture (and the graph pool's memory) per occurrence on the card.
:class:`RetraceSentinel` snapshots the signatures a watched forward or
step has met, the caller drives the hot path, and ``check()`` fails if
any met more NEW signatures than its declared budget (0 for a steady-state
path). Both classes record their signatures on the CPU too, where the
forward runs eagerly, so a count on the CPU means what it means on the
card: there, each signature is one graph (``len(captures)``).

One scheduler per report: a port graph belongs to one scheduler's pools
(it reads their addresses), so each report drives a single long-lived
scheduler through its warm-up and its steady-state rounds, where JAX's
module-level jitted programs let its reports build a new scheduler per
request. The prefill is not captured in the port (it runs eagerly), so
the watches are the step forwards: the decode step, the verify step, the
gathered-view and kernel steps of the paged layout, and the train step.

JAX's ``leak_checking`` (``jax.checking_leaks``) has no counterpart:
eager torch has no tracers to leak. The sharded report is skipped until
the sharded replica (``serve/sharded.py``, ``--mesh``) is ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


def _captures(fn: Any) -> int | None:
    device = getattr(fn, "device", None)
    return len(fn.captures) if device is not None and device.type == "cuda" else None


def _signature_count(fn: Any) -> int:
    sigs = getattr(fn, "signatures", None)
    if sigs is None:
        raise ValueError(
            f"{fn!r} records no step signatures: pass a CapturedForward "
            "(scheduler.forward) or a CapturedStep"
        )
    return len(sigs)


@dataclasses.dataclass
class WatchDelta:
    name: str
    budget: int
    before: int
    after: int
    # On the card, the graphs the watched forward or step has captured
    # (one per signature: ``after`` when nothing was captured twice).
    captures: int | None = None

    @property
    def compiles(self) -> int:
        return self.after - self.before

    @property
    def within_budget(self) -> bool:
        return self.compiles <= self.budget

    def to_dict(self) -> dict:
        out = {
            "name": self.name,
            "budget": self.budget,
            "compiles": self.compiles,
            "cache_before": self.before,
            "cache_after": self.after,
            "ok": self.within_budget,
        }
        if self.captures is not None:
            out["captures"] = self.captures
        return out


class RetraceSentinel:
    """Budgeted signature accounting over a set of captured forwards and
    steps.

    >>> sentinel = RetraceSentinel()
    >>> sentinel.watch("decode_step", scheduler.forward, budget=0)
    >>> sentinel.snapshot()          # after warmup
    >>> ...drive the steady-state hot path...
    >>> sentinel.assert_within_budget()
    """

    def __init__(self) -> None:
        self._fns: dict[str, tuple[Any, int]] = {}
        self._before: dict[str, int] = {}

    def watch(self, name: str, fn: Any, budget: int = 0) -> None:
        _signature_count(fn)  # validate now, not at snapshot time
        self._fns[name] = (fn, budget)

    def snapshot(self) -> dict[str, int]:
        self._before = {
            name: _signature_count(fn) for name, (fn, _) in self._fns.items()
        }
        return dict(self._before)

    def deltas(self) -> list[WatchDelta]:
        if not self._fns:
            return []
        if not self._before:
            raise RuntimeError("snapshot() was never taken — nothing to diff")
        return [
            WatchDelta(
                name=name,
                budget=budget,
                before=self._before[name],
                after=_signature_count(fn),
                captures=_captures(fn),
            )
            for name, (fn, budget) in self._fns.items()
        ]

    def violations(self) -> list[WatchDelta]:
        return [d for d in self.deltas() if not d.within_budget]

    def assert_within_budget(self) -> None:
        bad = self.violations()
        if bad:
            raise AssertionError(
                "retrace budget exceeded: "
                + "; ".join(
                    f"{d.name} met {d.compiles} new step signature(s), "
                    f"budget {d.budget}"
                    for d in bad
                )
            )


# --------------------------------------------------------------------------
# canned steady-state scenarios (CLI `retrace` + tests)


def _tiny_lm_setup(device, **overrides):
    """JAX's canned model (``FAST_MATRIX["lm_bf16"]``, widened by
    ``overrides``) from seed 0 on ``device``, and a tokenizer over its
    sentence. The byte-level tokenizer's ids run past the canned 64-entry
    vocabulary (JAX's embedding gather clamps them, torch's raises), so the
    model's vocabulary is the tokenizer's."""
    from transformer_tpu_torch.analysis.configs import FAST_MATRIX
    from transformer_tpu_torch.data.tokenizer import SubwordTokenizer
    from transformer_tpu_torch.models.transformer import init_params

    cfg = FAST_MATRIX["lm_bf16"]
    tok = SubwordTokenizer.build_from_corpus(
        ["the quick brown fox jumps over the lazy dog"] * 4,
        target_vocab_size=cfg.input_vocab_size - 2,
    )
    vocab = tok.model_vocab_size
    cfg = dataclasses.replace(cfg, input_vocab_size=vocab, target_vocab_size=vocab, **overrides)
    params = init_params(cfg, torch.Generator().manual_seed(0), device=device)
    return cfg, params, tok


# The kernel step's model: the canned one at the narrowest widths the
# kernels take (fused_ln_ffn: d_model a multiple of 64, dff of 128 in
# bf16), so the report runs the kernels on the card.
KERNEL_WIDTHS = dict(d_model=64, dff=128)


def _scheduler(device, cfg, params, tok, **kw):
    from transformer_tpu_torch.serve.scheduler import ContinuousScheduler

    return ContinuousScheduler(params, cfg, tok, num_slots=2, device=device, **kw)


def _answers(out) -> list:
    assert all("continuation" in r for r in out), out
    return [r["continuation"] for r in out]


def decode_retrace_report(steps: int = 3, device="cuda") -> list[WatchDelta]:
    """Steady-state serving on the dense layout: warm one long-lived
    scheduler up on one request, snapshot, then serve ``steps`` more
    same-shaped requests. The decode step forward must meet ZERO new
    signatures: the pool's shape is fixed, whatever the occupancy."""
    cfg, params, tok = _tiny_lm_setup(device)
    s = _scheduler(device, cfg, params, tok, max_total=32, default_max_new=4)
    s.run([{"prompt": "the quick brown fox"}])  # warmup capture
    sentinel = RetraceSentinel()
    sentinel.watch("decode_step(_pool_step)", s.forward, budget=0)
    sentinel.snapshot()
    for _ in range(steps):
        out = s.run([{"prompt": "the quick brown fox"}])
        assert "continuation" in out[0], out
    return sentinel.deltas()


def speculative_retrace_report(steps: int = 3, device="cuda") -> list[WatchDelta]:
    """Steady-state SPECULATIVE serving: accept lengths vary per request,
    yet the verify forward (every row padded to the static width k + 1,
    rollback position arithmetic on the host) must meet ZERO new
    signatures after warmup."""
    cfg, params, tok = _tiny_lm_setup(device)
    waves = [
        [{"prompt": "the quick brown fox"}, {"prompt": "dog dog dog dog"}],
        [{"prompt": "the the the the the"}, {"prompt": "lazy fox"}],
        [{"prompt": "quick quick brown"}, {"prompt": "the lazy dog"}],
    ]
    s = _scheduler(device, cfg, params, tok, max_total=32, default_max_new=6,
                   speculate_k=3)
    for wave in waves:
        s.run([dict(r) for r in wave])
    sentinel = RetraceSentinel()
    sentinel.watch("verify(_pool_verify)", s.forward, budget=0)
    sentinel.snapshot()
    for i in range(steps):
        out = s.run([dict(r) for r in waves[i % len(waves)]])
        assert all("continuation" in r for r in out), out
    return sentinel.deltas()


def prefix_cache_retrace_report(steps: int = 3, device="cuda") -> list[WatchDelta]:
    """Steady-state serving WITH the prefix cache: hits, misses and
    partial hits all flow through admission (restores write rows, suffix
    prefills run eagerly), yet the decode step forward must meet ZERO new
    signatures after warmup."""
    from transformer_tpu_torch.serve.prefix_cache import PrefixCache

    cfg, params, tok = _tiny_lm_setup(device)
    cache = PrefixCache(cfg, block_tokens=4, budget_mb=8)
    waves = [
        [{"prompt": "the quick brown fox jumps"}],
        [{"prompt": "the quick brown fox jumps"},        # full hit
         {"prompt": "the quick brown dog"}],             # partial hit
        [{"prompt": "lazy"},                             # miss
         {"prompt": "the quick brown fox jumps"}],
    ]
    s = _scheduler(device, cfg, params, tok, max_total=48, default_max_new=4,
                   prefix_cache=cache)
    for wave in waves + waves:
        s.run([dict(r) for r in wave])
    sentinel = RetraceSentinel()
    sentinel.watch("decode_step(_pool_step)", s.forward, budget=0)
    sentinel.snapshot()
    for i in range(steps):
        out = s.run([dict(r) for r in waves[i % len(waves)]])
        assert all("continuation" in r for r in out), out
    return sentinel.deltas()


def _paged_report(steps, device, decode_kernel, name, **widths) -> list[WatchDelta]:
    from transformer_tpu_torch.serve.prefix_cache import PrefixCache

    cfg, params, tok = _tiny_lm_setup(device, **widths)
    cache = PrefixCache(cfg, block_tokens=4, budget_mb=8)
    s = _scheduler(device, cfg, params, tok, max_total=48, default_max_new=4,
                   prefix_cache=cache, kv_layout="paged", decode_kernel=decode_kernel)
    wave = [
        {"prompt": "the quick brown fox jumps"},
        {"prompt": "the quick brown dog"},
    ]

    def one_round():
        out = s.run([dict(r) for r in wave])       # miss / alias / partial
        # Spill rung: push every device-tier block to the host trie, then
        # re-serve: hits restore through the batched host write and are
        # re-adopted, so the NEXT round aliases again.
        s.stats["kv_spilled_blocks"] += cache.release_device_blocks(1 << 30)
        out2 = s.run([dict(r) for r in wave])
        # CoW rung: alias a device-tier block into a free slot's table
        # (refcount 2) and write-guard it: the pool splits the block and
        # copies it on the device. The row is freed before any admission.
        bid = None
        with cache._lock:
            stack = [cache._root]
            while stack:
                n = stack.pop()
                stack.extend(n.children.values())
                if n.device_block is not None:
                    bid = n.device_block
                    break
        if bid is not None:
            slot = s._free[-1]
            s.alloc.extend(slot, bid=bid)
            s._cow(slot, 0, cache.block_tokens)
            s.alloc.free_slot(slot)
        s.alloc.check_consistency()
        return _answers(out + out2)

    want = one_round()
    sentinel = RetraceSentinel()
    sentinel.watch(name, s.forward, budget=0)
    sentinel.snapshot()
    for i in range(steps):
        got = one_round()
        assert got == want, f"paged round {i} changed greedy answers"
    return sentinel.deltas()


def paged_retrace_report(steps: int = 3, device="cuda") -> list[WatchDelta]:
    """Steady-state serving on the PAGED layout across every admission
    outcome the block pool can produce (fresh allocations, frees at
    retirement, device-tier alias hits, spill to the host tier and
    host-restore, a copy-on-write block split), on both step forwards: the
    gathered views (``decode_kernel="xla"``) and the two kernels
    (``"paged_flash"``, at ``KERNEL_WIDTHS``). Each must meet ZERO new
    signatures after warmup: the table's width is static and positions
    are host-derived. Greedy answers are asserted identical round over
    round."""
    return (
        _paged_report(steps, device, "xla", "decode(_pool_step_paged)")
        + _paged_report(steps, device, "paged_flash", "decode(_pool_step_paged_flash)",
                        **KERNEL_WIDTHS)
    )


def resilience_retrace_report(steps: int = 3, device="cuda") -> list[WatchDelta]:
    """Steady-state serving WHILE circuit breakers flip: injected drafter
    and prefix-cache faults open the breakers mid-run, requests keep
    answering through the degraded path, and half-open probes close them,
    all on ONE scheduler whose verify forward must meet ZERO new
    signatures after warmup: degradation changes row contents, never the
    row width. Greedy answers are asserted identical before, during and
    after the transitions."""
    from transformer_tpu_torch.serve import resilience
    from transformer_tpu_torch.serve.prefix_cache import PrefixCache
    from transformer_tpu_torch.serve.resilience import FaultPlane

    cfg, params, tok = _tiny_lm_setup(device)
    cache = PrefixCache(cfg, block_tokens=4, budget_mb=8)
    s = _scheduler(device, cfg, params, tok, max_total=48, default_max_new=4,
                   speculate_k=2, prefix_cache=cache, breaker_threshold=2,
                   breaker_cooldown_s=0.0, retry_backoff_ms=1.0)
    wave = [
        {"prompt": "the quick brown fox jumps"},
        {"prompt": "the quick brown dog"},
        {"prompt": "lazy"},
    ]
    want = _answers(s.run([dict(r) for r in wave]))
    assert _answers(s.run([dict(r) for r in wave])) == want, (
        "prefix-cache replay changed greedy answers")
    sentinel = RetraceSentinel()
    sentinel.watch("verify(_pool_verify)", s.forward, budget=0)
    sentinel.snapshot()
    for i in range(steps):
        with resilience.active(
            FaultPlane.parse("draft.propose:p=1,times=4;prefix.match:p=1,times=4")
        ):
            out = s.run([dict(r) for r in wave])  # breakers open mid-run
        assert _answers(out) == want, f"degraded round {i} changed greedy answers"
        out = s.run([dict(r) for r in wave])      # probes close the breakers
        assert _answers(out) == want, f"recovered round {i} changed greedy answers"
        assert s.breakers["speculative"].state == "closed"
        assert s.breakers["prefix_cache"].state == "closed"
    return sentinel.deltas()


def upgrade_retrace_report(steps: int = 3, device="cuda") -> list[WatchDelta]:
    """Steady-state serving ACROSS live-weight swaps: a wave admitted on
    v0, a twin weight set staged mid-flight, the pool drained on the
    admission-time weights, the flip at a drained step boundary, traffic
    on v1, and a rollback, while the decode step forward meets ZERO new
    signatures: a flip writes new values into the tensors the graphs
    read. Answers are asserted stable per weight_version tag."""
    from transformer_tpu_torch.models.transformer import init_params

    cfg, params, tok = _tiny_lm_setup(device)
    params_new = init_params(cfg, torch.Generator().manual_seed(1), device=device)
    s = _scheduler(device, cfg, params, tok, max_total=32, default_max_new=4,
                   weight_version="v0")
    wave = [{"prompt": "the quick brown fox"}, {"prompt": "the lazy dog"}]
    want_old = _answers(s.run([dict(r) for r in wave]))  # warmup capture on v0
    sentinel = RetraceSentinel()
    sentinel.watch("decode_step(_pool_step)", s.forward, budget=0)
    sentinel.snapshot()
    want_new = None
    for i in range(steps):
        for r in wave:
            s.submit(dict(r))
        s.admit()
        assert s.active_count == len(wave), "wave not admitted pre-stage"
        s.stage_params(params_new, "v1")
        while s.busy:
            s.admit()
            s.step()
        out = s.drain_ready()
        assert _answers(out) == want_old, (
            f"round {i}: straddling requests left their admission weights")
        assert all(r["weight_version"] == "v0" for r in out)
        s.step()  # the drained boundary: the flip lands here
        assert s.weight_version == "v1", "swap did not land"
        out = s.run([dict(r) for r in wave])
        assert all(r["weight_version"] == "v1" for r in out)
        if want_new is None:
            want_new = _answers(out)
        assert _answers(out) == want_new, f"round {i}: v1 answers drifted"
        s.stage_rollback()
        s.step()
        assert s.weight_version == "v0", "rollback did not land"
        out = s.run([dict(r) for r in wave])
        assert _answers(out) == want_old, f"round {i}: rollback changed v0 answers"
    return sentinel.deltas()


def train_retrace_report(steps: int = 3, device="cuda") -> list[WatchDelta]:
    """Steady-state training: one warmup step captures; ``steps`` more
    same-shaped steps through the same ``CapturedStep`` must not."""
    from transformer_tpu_torch.analysis.configs import TINY_TRAIN
    from transformer_tpu_torch.train.graph import CapturedStep
    from transformer_tpu_torch.train.state import create_train_state, make_optimizer
    from transformer_tpu_torch.train.trainer import make_train_step

    cfg, params, _ = _tiny_lm_setup(device)
    train_cfg = TINY_TRAIN
    tx = make_optimizer(cfg, train_cfg)
    state = create_train_state(cfg, train_cfg, params=params)
    step = make_train_step(cfg, train_cfg, tx=tx)
    graph = CapturedStep(step.core, train_cfg.seed, device)
    B, L = train_cfg.batch_size, train_cfg.sequence_length
    rng = np.random.default_rng(0)

    def one_step(state):
        ids = rng.integers(1, cfg.input_vocab_size, size=(B, L))
        tgt = torch.from_numpy(ids).to(device)
        scalars = torch.from_numpy(step.scalars(state)[0]).to(device)
        return graph(state, None, tgt, scalars)[0]

    state = one_step(state)  # warmup
    sentinel = RetraceSentinel()
    sentinel.watch("train_step", graph, budget=0)
    sentinel.snapshot()
    for _ in range(steps):
        state = one_step(state)
    return sentinel.deltas()


REPORTS = {
    "decode": decode_retrace_report,
    "speculative": speculative_retrace_report,
    "prefix_cache": prefix_cache_retrace_report,
    "paged": paged_retrace_report,
    "resilience": resilience_retrace_report,
    "upgrade": upgrade_retrace_report,
    "train": train_retrace_report,
}
# Skipped until the sharded replica (``serve/sharded.py``, ``--mesh``) is
# ported: JAX's sharded report watches its per-instance programs.
SKIPPED_REPORTS = ("sharded",)
