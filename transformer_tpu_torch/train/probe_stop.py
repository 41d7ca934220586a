"""Keep-best / early-stop accounting on a periodic quality probe (BLEU).

A copy of ``transformer_tpu/train/probe_stop.py``: the state file is the
same JSON, so either package reads what the other wrote. It rides the
port's ``Trainer.fit(epoch_callback=...)``: return ``update(...) ==
"stop"`` from the callback and ``fit`` checkpoints that epoch and ends.

The trainer's built-in plateau stop (``Trainer.fit`` + ``early_stop_patience``)
watches *eval loss*; convergence runs that report a decode metric need the
decision wired to the metric itself: the bundled-corpus ladder showed
small+smoothing BLEU peaking at ~epoch 60 then *dropping* (2.34 -> 2.08 by
epoch 70) while eval loss still looked flat — a 40-epoch budget can buy
memorization. This module is the probe-side counterpart: track per-probe
BLEU, remember which probe was best (so the caller can export those params),
and stop after ``patience`` consecutive non-improving probes.

All state is persisted as one small JSON next to the run's checkpoints, so
the decision survives the resumable-run pattern (``benchmarks/bleu_run.py``
re-invoked per relay window with ``--epoch_budget``): a stop decided in one
invocation is still a stop in the next, and a best probe recorded three
windows ago is still the best.

The reference has no analogue — it trains a fixed epoch count and keeps only
rotated last-N checkpoints (``train.py:159``, ``max_to_keep=5``), so its
final model is whatever the last epoch produced.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field


@dataclass
class ProbeKeepBest:
    """Persisted best-probe tracker with a consecutive-miss stopping rule.

    ``update(epoch, value)`` returns one of:

    - ``"new_best"``  — this probe beat every previous one by > ``min_delta``;
      the caller should snapshot the current params as the run's best.
    - ``"stop"``      — ``patience`` consecutive probes have failed to set a
      new best; the caller should stop training and keep the best snapshot.
    - ``"continue"``  — neither.

    ``patience <= 0`` disables stopping (every miss returns ``"continue"``),
    but best-tracking still runs so keep-best export works on fixed-budget
    runs too.
    """

    path: str
    patience: int = 2
    min_delta: float = 0.0
    probes: list[dict] = field(default_factory=list)
    best_epoch: int | None = None
    best_value: float | None = None
    stopped_epoch: int | None = None

    def __post_init__(self) -> None:
        if os.path.exists(self.path):
            with open(self.path) as f:
                saved = json.load(f)
            self.probes = list(saved.get("probes", []))
            self.best_epoch = saved.get("best_epoch")
            self.best_value = saved.get("best_value")
            self.stopped_epoch = saved.get("stopped_epoch")

    # ------------------------------------------------------------------ core
    @property
    def misses_since_best(self) -> int:
        """Consecutive probes since (and not counting) the best one."""
        n = 0
        for p in reversed(self.probes):
            if self.best_epoch is not None and p["epoch"] == self.best_epoch:
                break
            n += 1
        return n

    def would_be_best(self, value: float) -> bool:
        """Would ``update(_, value)`` return ``"new_best"``? Exposed so a
        caller can snapshot params BEFORE committing the record (crash
        between the two then re-runs the probe instead of leaving the
        record pointing at a snapshot that was never written)."""
        return (
            self.best_value is None
            or float(value) > self.best_value + self.min_delta
        )

    def update(self, epoch: int, value: float) -> str:
        """Record one probe and return the decision (see class docstring).

        ``epoch`` is 1-based (the number of completed epochs at probe time).
        Re-recording an epoch already in the history (a resumed invocation
        re-probing its restore point) replaces the old record instead of
        double-counting a miss.
        """
        value = float(value)
        is_best = self.would_be_best(value)
        self.probes = [p for p in self.probes if p["epoch"] != epoch]
        self.probes.append({"epoch": epoch, "bleu": value})
        self.probes.sort(key=lambda p: p["epoch"])
        decision = "continue"
        if is_best:
            self.best_value = value
            self.best_epoch = epoch
            decision = "new_best"
        elif self.patience > 0 and self.misses_since_best >= self.patience:
            self.stopped_epoch = epoch
            decision = "stop"
        self._save()
        return decision

    # ----------------------------------------------------------- persistence
    def _save(self) -> None:
        tmp = f"{self.path}.tmp"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "probes": self.probes,
                    "best_epoch": self.best_epoch,
                    "best_value": self.best_value,
                    "stopped_epoch": self.stopped_epoch,
                },
                f,
            )
        os.replace(tmp, self.path)  # atomic: a crash mid-write keeps the old
