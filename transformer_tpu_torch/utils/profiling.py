"""Tracing / profiling of the port's training loop.

Port of ``transformer_tpu/utils/profiling.py`` with torch twins of its
device hooks:

- :class:`Profiler` records one ``torch.profiler`` window over the training
  steps ``[start_step, start_step + num_steps)`` (relative to the first
  step it sees): CPU activity always, and CUDA activity (each kernel, its
  device time) when a card is present. It writes one Chrome trace,
  ``<log_dir>/<host>_<pid>.<ms>.pt.trace.json``, the file name
  ``torch.profiler.tensorboard_trace_handler`` uses, so TensorBoard's
  PyTorch profiler plugin and ui.perfetto.dev both load it.
- :func:`annotate` labels a host-side region on that timeline
  (``torch.profiler.record_function``); the trainer labels each dispatch
  ``train.step``.
- :class:`StepTimer` keeps the step-duration histogram and throughput
  summary of the JAX package's. The JAX twin times windows between the
  blocking reads of an asynchronous loop (``tick`` / ``sync``); the
  port's trainer ends every dispatch in a device synchronize and times
  it, so it hands each dispatch's seconds to :meth:`StepTimer.observe`.

The JAX module's ``enable_compilation_cache`` has no counterpart here:
there is no jit cache to persist. The port's kernels build once per
source hash into ``build/`` (``kernels/build.py``) and are reused by every
later process, and a CUDA graph is captured per process, in seconds.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time

from transformer_tpu_torch.obs.quantiles import StreamingHistogram


class Profiler:
    """Capture one ``torch.profiler`` trace over a window of training steps.

    Drive it from a training loop with ``maybe_trace(step)`` once per
    dispatch; the trace starts when ``step`` has moved ``start_step`` past
    the first step seen and stops ``num_steps`` later (or at ``stop()``,
    whichever comes first). ``trace_path`` names the file written."""

    def __init__(self, log_dir: str, start_step: int = 2, num_steps: int = 3):
        self.log_dir = log_dir
        # Relative to the first observed step, so a run restored at step N
        # still skips `start_step` warm-up steps (kernel builds, captures).
        self.start_step = start_step
        self.num_steps = num_steps
        self.trace_path: str | None = None
        self._first_step: int | None = None
        self._active = False
        self._done = False
        self._prof = None

    def maybe_trace(self, step: int, block_on=None) -> None:
        if self._done:
            return
        if self._first_step is None:
            self._first_step = step
        rel = step - self._first_step
        if not self._active and rel >= self.start_step:
            import torch
            from torch.profiler import ProfilerActivity, profile

            os.makedirs(self.log_dir, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.start()
            self._active = True
            self._stop_at = step + self.num_steps
        elif self._active and step >= self._stop_at:
            self.stop(block_on)

    def stop(self, block_on=None) -> None:
        """End the capture and write the trace. Pass the training state (or
        anything else the profiled steps produced) as ``block_on`` to wait
        for the card first, so the window's device work lands inside the
        trace (the JAX twin blocks on the state there)."""
        if not self._active:
            return
        import torch

        if block_on is not None and torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        name = f"{socket.gethostname()}_{os.getpid()}.{int(time.time() * 1000)}.pt.trace.json"
        self.trace_path = os.path.join(self.log_dir, name)
        self._prof.export_chrome_trace(self.trace_path)
        self._active = False
        self._done = True


@contextlib.contextmanager
def annotate(name: str):
    """Label a host-side region on the profiler timeline."""
    from torch.profiler import record_function

    with record_function(name):
        yield


class StepTimer:
    """Step throughput and the step-duration distribution, from dispatches
    timed up to their device synchronize (:meth:`observe`)."""

    def __init__(self, tokens_per_step: int = 0):
        self.tokens_per_step = tokens_per_step
        # Online step-duration distribution (p50/p95/p99), fed a dispatch at
        # a time. The trainer binds this instance into its registry
        # (`registry.histogram(name, hist=timer.histogram)`), so telemetry
        # exports the same sample stream. It survives reset(): reset()
        # reopens the throughput window per epoch, but the duration
        # distribution is a run-level statistic.
        self.histogram = StreamingHistogram()
        self.reset()

    def reset(self) -> None:
        self._total_steps = 0
        self._total_tokens = 0
        self._total_time = 0.0

    def observe(self, seconds: float, tokens: int | None = None, steps: int = 1) -> None:
        """One dispatch of ``steps`` steps took ``seconds`` (up to its device
        synchronize) and fed ``tokens`` (default ``tokens_per_step`` a
        step)."""
        self._total_time += seconds
        self._total_steps += steps
        self._total_tokens += self.tokens_per_step * steps if tokens is None else tokens
        # The dispatch's time spread evenly over its steps (n identical
        # samples keeps the step-count weighting).
        self.histogram.observe(seconds / steps, n=steps)

    @property
    def count(self) -> int:
        return self._total_steps

    @property
    def total_tokens(self) -> int:
        return self._total_tokens

    @property
    def total_time_s(self) -> float:
        return self._total_time

    @property
    def mean_s(self) -> float:
        return self._total_time / self._total_steps if self._total_steps else 0.0

    @property
    def steps_per_sec(self) -> float:
        return self._total_steps / self._total_time if self._total_time > 0 else 0.0

    @property
    def tokens_per_sec(self) -> float:
        return self._total_tokens / self._total_time if self._total_time > 0 else 0.0

    def summary(self) -> str:
        if not self._total_steps:
            return "no steps timed"
        msg = (
            f"{self.count} steps: mean {self.mean_s * 1e3:.1f}ms "
            f"({self.steps_per_sec:.2f} steps/s"
        )
        if self._total_tokens:
            msg += f", {self.tokens_per_sec:,.0f} tokens/s"
        msg += ")"
        if self.histogram.count:
            p = self.histogram.percentiles()
            msg += (
                f" p50 {p['p50'] * 1e3:.1f}ms p95 {p['p95'] * 1e3:.1f}ms "
                f"p99 {p['p99'] * 1e3:.1f}ms"
            )
        return msg
