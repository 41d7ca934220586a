"""transformer_tpu_torch.analysis — analyses of the port's programs.

Port of ``transformer_tpu/analysis/`` (one CLI, ``python -m
transformer_tpu_torch.analysis``), so far:

- :mod:`.costs` — the cost model: every canned program runs on the
  ``meta`` device under a dispatch mode that prices each aten op (peak
  live-buffer bytes, FLOPs, bytes moved, collectives) and each kernel
  launch once (``kernels/work.py``), plus KV-cache budgets per cache
  variant, gated against ``analysis/costs_baseline.json``. No device
  execution.
- :mod:`.retrace` — the step-signature sentinel: the steady-state decode,
  verify, paged, resilience, upgrade and train paths must meet no new
  CUDA-graph signature after warm-up.
- :mod:`.configs` — the config matrix both trace; :mod:`.baselines` — the
  finding/fingerprint/baseline plumbing of the lint families.

Not ported yet (``ROADMAP.md``): ``contracts``, ``sharding``, ``kernels``,
``rules``, ``concurrency`` and ``schedules``.

Importing the package costs nothing until a pass runs.
"""

from transformer_tpu_torch.analysis.baselines import Finding, RulesReport
from transformer_tpu_torch.analysis.costs import (
    CostReport,
    kv_cache_bytes,
    program_costs,
    run_costs,
    train_step_costs,
)
from transformer_tpu_torch.analysis.retrace import RetraceSentinel, WatchDelta

__all__ = [
    "Finding",
    "RulesReport",
    "CostReport",
    "program_costs",
    "kv_cache_bytes",
    "run_costs",
    "train_step_costs",
    "RetraceSentinel",
    "WatchDelta",
]
