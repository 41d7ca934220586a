"""The pooled decode and verify forwards replayed from CUDA graphs.

The JAX package runs each serving step as one jitted, donated program
(``_pool_step``, ``_pool_verify`` on the dense layout, their gathered-view
twins ``_pool_step_paged`` / ``_pool_verify_paged``, and
``_pool_step_paged_flash`` / ``_pool_verify_paged_flash``): one dispatch
from the host per step. PyTorch runs the forward eagerly, a few hundred
kernel launches a step at long4k, which the host cannot issue as fast as
the card runs them; the port's counterpart of a compiled program is a
CUDA graph (as ``train/graph.py`` is for the train step).

``CapturedForward`` keeps one graph of a layout's step forward per
(slots, S_q, table width): S_q 1 for the plain step, k + 1 for the verify
step, table width 0 on the dense layout (no table). The forward is
``paged_decode_forward`` (the kernels) unless the scheduler passes
another ``program``: the dense or the gathered-view step. Its static
input is one int64 buffer that packs the step's tokens, the block table
(paged layouts) and the per-slot positions; each call packs them on the
host, copies the buffer to the card in one transfer and replays. The
first call of a shape runs the forward eagerly on a side stream (a real
step: it also builds and loads the kernels and grows their scratch) and
then captures it into the memory pool every graph of the forward shares;
the capture launches nothing. The KV pools are updated
in place and the parameters never move, so a graph stays valid for the
scheduler's life. The returned logits are the graph's output buffer,
which the next call overwrites. Launch counters run in Python, so the
capture's counts are taken back off and each replay adds them again
(``kernels.add_launches``). On the CPU the forward runs eagerly. A
capture or replay that fails raises: nothing falls back to the eager
forward on the card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from transformer_tpu_torch.config import ModelConfig
from transformer_tpu_torch.kernels import add_launches, launch_counts
from transformer_tpu_torch.models.paged_decode import paged_decode_forward


def _pack_inputs(toks: np.ndarray, table: np.ndarray | None, index: np.ndarray) -> np.ndarray:
    """(N, S_q) tokens, the (N, nmax) table (none on the dense layout) and
    (N,) positions as one int64 vector: the forward's whole input in one
    host-to-device copy."""
    parts = [np.asarray(toks, np.int64).reshape(-1)]
    if table is not None:
        parts.append(np.asarray(table, np.int64).reshape(-1))
    parts.append(np.asarray(index, np.int64).reshape(-1))
    return np.concatenate(parts)


def _signature(toks: np.ndarray, table: np.ndarray | None) -> tuple[int, int, int]:
    return (*np.shape(toks), 0 if table is None else np.shape(table)[1])


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    staging: torch.Tensor  # pinned host copy of the packed inputs
    copied: torch.cuda.Event  # the staging buffer's last copy to the card
    packed: torch.Tensor  # the graph's static input on the card
    logits: torch.Tensor  # the graph's output
    launches: dict[str, int]


Program = Callable[[torch.Tensor, "torch.Tensor | None", torch.Tensor], torch.Tensor]


class CapturedForward:
    """A step forward over the scheduler's KV storage, called with host
    arrays ``(toks (N, S_q), table (N, nmax) or None, index (N,))`` and
    returning (N, S_q, V) logits on the device: by graph replay on the
    card, eagerly on the CPU. ``program(toks, table, index)`` is the
    forward on device tensors (table None on the dense layout); by default
    ``paged_decode_forward`` over ``pools``. ``captures`` lists ((N, S_q,
    table width), seconds) per capture (host clock); ``replays`` counts
    the calls served by a replay (every call on the card but each shape's
    first, which runs eagerly before its capture). ``signatures`` holds
    every (N, S_q, table width) a call has met, on the CPU too, where
    nothing is captured: on the card each is one graph
    (``analysis/retrace.py`` budgets them)."""

    def __init__(self, params, pools: list[dict], cfg: ModelConfig, block_tokens: int,
                 device: torch.device, program: Program | None = None) -> None:
        self.params, self.pools, self.cfg = params, pools, cfg
        self.block_tokens = block_tokens
        self.device = torch.device(device)
        self.program = program or self._paged_flash
        self.graphs: dict[tuple[int, int, int], _Graph] = {}
        self.captures: list[tuple[tuple[int, int, int], float]] = []
        self.signatures: set[tuple[int, int, int]] = set()
        self.replays = 0
        if self.device.type == "cuda":
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)

    def _paged_flash(self, toks, table, index) -> torch.Tensor:
        logits, _ = paged_decode_forward(
            self.params, toks, self.pools, table, index, self.cfg,
            block_tokens=self.block_tokens,
        )
        return logits

    def _forward(self, packed: torch.Tensor, sig: tuple[int, int, int]) -> torch.Tensor:
        n, s_q, nmax = sig
        toks = packed[: n * s_q].view(n, s_q)
        table = packed[n * s_q : n * (s_q + nmax)].view(n, nmax).to(torch.int32) if nmax else None
        index = packed[n * (s_q + nmax) :].to(torch.int32)
        with torch.no_grad():
            return self.program(toks, table, index)

    def eager(self, toks: np.ndarray, table: np.ndarray | None, index: np.ndarray) -> torch.Tensor:
        """The forward without a graph (on any device)."""
        packed = torch.from_numpy(_pack_inputs(toks, table, index)).to(self.device)
        return self._forward(packed, _signature(toks, table))

    def __call__(self, toks: np.ndarray, table: np.ndarray | None,
                 index: np.ndarray) -> torch.Tensor:
        sig = _signature(toks, table)
        self.signatures.add(sig)
        if self.device.type != "cuda":
            return self.eager(toks, table, index)
        host = _pack_inputs(toks, table, index)
        g = self.graphs.get(sig)
        if g is None:
            return self._warm_up_and_capture(sig, host)
        g.copied.synchronize()  # the previous call's copy has read the staging buffer
        g.staging.numpy()[:] = host
        g.packed.copy_(g.staging, non_blocking=True)
        g.copied.record()
        g.graph.replay()
        self.replays += 1
        add_launches(g.launches)
        return g.logits

    def _warm_up_and_capture(self, sig, host: np.ndarray) -> torch.Tensor:
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            logits = self._forward(torch.from_numpy(host).to(self.device), sig)
        current.wait_stream(self.stream)

        t0 = time.perf_counter()
        staging = torch.empty(host.shape, dtype=torch.int64, pin_memory=True)
        packed = torch.empty(host.shape, dtype=torch.int64, device=self.device)
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            out = self._forward(packed, sig)
        after = launch_counts()
        launched = {name: after[name] - before[name] for name in after}
        add_launches({name: -n for name, n in launched.items()})  # the capture ran nothing
        self.graphs[sig] = _Graph(graph, staging, torch.cuda.Event(), packed, out, launched)
        self.captures.append((sig, time.perf_counter() - t0))
        return logits
