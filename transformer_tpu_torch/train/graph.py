"""The train step captured in a CUDA graph: the card's side of
``steps_per_dispatch``.

The JAX package runs the K optimizer steps of a dispatch as one jitted
``lax.scan`` (``make_multistep_train_step``): one compiled program per
stacked batch shape, one host dispatch per K steps. PyTorch runs eagerly,
so a base step costs thousands of kernel launches from the host; the
counterpart of a compiled program is a CUDA graph. ``CapturedStep`` keeps
one graph of the step per batch signature (the shapes of ``src`` and
``tgt``), as JAX keeps one trace per shape, and ``trainer.
make_multistep_train_step`` replays it once per step of a dispatch, back to
back, with no host synchronize in between.

A new signature's first step runs eagerly on a side stream: it is a real
step of the run (and it builds and loads the kernels, makes cuBLAS's
workspace for the stream, and records the step's dropout keys). The graph
is captured right after it, on the same stream, into the memory pool all
of this step's graphs share; the capture launches nothing. Each replay
then copies its step's batch and per-update scalars (Adam's bias
corrections or Adafactor's decay, and the learning rate: the optimizer's
``scalars``) into the graph's static inputs, reseeds the step's dropout
generators, and the MLM's masking generator, from the real (seed, step)
key (``ops.nn.DropoutTape``), and replays. The parameters and the
optimizer's state are updated in place, so the graph stays valid from
step to step; a state whose tensors are not the captured ones (a restore
into new tensors) is captured anew. Launch counters run in Python, so at capture
the graph's launches are counted and taken back off, and every replay
adds them again. A capture or a replay that fails raises: nothing falls
back to the eager step.
"""

from __future__ import annotations

import dataclasses
import time
from collections.abc import Callable

import torch

from transformer_tpu_torch.kernels import add_launches, launch_counts
from transformer_tpu_torch.models.transformer import flatten
from transformer_tpu_torch.ops.nn import DropoutTape, dropout_tape


def advanced(state):
    """``state`` one step on: what a replay does to the host's mirror of
    the step and of the optimizer's count (the tensors moved on the device)."""
    opt = dataclasses.replace(state.opt_state, count=state.opt_state.count + 1)
    return dataclasses.replace(state, step=state.step + 1, opt_state=opt)


def _addresses(state) -> tuple[int, ...]:
    return tuple(t.data_ptr() for t in [*flatten(state.params).values(),
                                         *state.opt_state.tensors()])


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    src: torch.Tensor | None
    tgt: torch.Tensor
    scalars: torch.Tensor
    metrics: dict[str, torch.Tensor]
    tape: DropoutTape
    launches: dict[str, int]
    addresses: tuple[int, ...]


class CapturedStep:
    """``core(state, src, tgt, scalars) -> (state, metrics)``, a train step
    on device tensors whose dropout is keyed (seed, state.step), as a
    CUDA graph per batch signature. Call it like ``core``: it runs the
    step (the first of a signature eagerly, then by replay) and returns
    the advanced state and the step's metrics, which the next call
    overwrites. ``captures`` lists (signature, seconds) per capture (host
    clock, the synchronize before the capture included). ``signatures``
    holds every batch signature a call has met, on the CPU too, where
    the step runs eagerly: on the card each is one graph
    (``analysis/retrace.py`` budgets them)."""

    def __init__(self, core: Callable, seed: int, device: torch.device) -> None:
        self.core = core
        self.seed = seed
        self.device = torch.device(device)
        if self.device.type == "cuda":
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)
        self.graphs: dict[tuple, _Graph] = {}
        self.captures: list[tuple[tuple, float]] = []
        self.signatures: set[tuple] = set()

    def __call__(self, state, src, tgt, scalars):
        sig = (None if src is None else tuple(src.shape), tuple(tgt.shape))
        self.signatures.add(sig)
        if self.device.type != "cuda":
            return self.core(state, src, tgt, scalars)
        g = self.graphs.get(sig)
        if g is None or g.addresses != _addresses(state):
            return self._warm_up_and_capture(sig, state, src, tgt, scalars)
        if src is not None:
            g.src.copy_(src)
        g.tgt.copy_(tgt)
        g.scalars.copy_(scalars)
        g.tape.reseed((self.seed, state.step))
        g.graph.replay()
        add_launches(g.launches)
        return advanced(state), g.metrics

    def _warm_up_and_capture(self, sig, state, src, tgt, scalars):
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        tape = DropoutTape((self.seed, state.step))
        with torch.cuda.stream(self.stream), dropout_tape(tape):
            new_state, metrics = self.core(state, src, tgt, scalars)
        current.wait_stream(self.stream)

        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        tape.arm(graph, self.device)
        tape.base = (self.seed, new_state.step)
        static = dict(
            src=None if src is None else torch.empty(src.shape, dtype=torch.long,
                                                     device=self.device),
            tgt=torch.empty(tgt.shape, dtype=torch.long, device=self.device),
            scalars=torch.empty_like(scalars),
        )
        before = launch_counts()
        with dropout_tape(tape), torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            _, static_metrics = self.core(new_state, static["src"], static["tgt"],
                                          static["scalars"])
        tape.check_complete()
        after = launch_counts()
        launched = {name: after[name] - before[name] for name in after}
        add_launches({name: -n for name, n in launched.items()})  # the capture ran nothing
        self.graphs[sig] = _Graph(graph, static["src"], static["tgt"], static["scalars"],
                                  static_metrics, tape, launched, _addresses(new_state))
        self.captures.append((sig, time.perf_counter() - t0))
        return new_state, metrics
