"""``train/probe_stop.py`` (``ProbeKeepBest``) against the JAX package's:
JAX's ``tests/test_probe_stop.py`` cases run on both packages' trackers
and must decide alike; a state file written by one package is read by
the other; and the rule rides the port's ``Trainer.fit(epoch_callback=)``
as JAX's ``TestTrainerCallbackStop`` has it (a truthy return ends the run
after that epoch's checkpoint, off the checkpoint cadence)."""

import dataclasses
import json

import numpy as np
import pytest

from transformer_tpu.train.probe_stop import ProbeKeepBest as JProbe
from transformer_tpu_torch.config import ModelConfig, TrainConfig
from transformer_tpu_torch.train.checkpoint import CheckpointManager
from transformer_tpu_torch.train.probe_stop import ProbeKeepBest
from transformer_tpu_torch.train.state import create_train_state
from transformer_tpu_torch.train.trainer import Trainer

TINY = ModelConfig(
    num_layers=1, d_model=16, num_heads=2, dff=32, input_vocab_size=30,
    target_vocab_size=30, max_position=32, dtype="float32", dropout_rate=0.0,
)
TCFG = TrainConfig(batch_size=4, sequence_length=8, epochs=1, warmup_steps=10,
                   eval_every_steps=0, log_every_steps=0)

# JAX's cases: (patience, min_delta, [(epoch, value), ...]) with the
# decisions and the final best/stopped epochs its tests expect.
CASES = {
    "first_probe_is_best": (2, 0.0, [(10, 0.21)], ["new_best"], 10, None),
    "stops_after_patience_misses": (
        2, 0.0, [(10, 1.0), (14, 2.0), (18, 1.9), (22, 1.8)],
        ["new_best", "new_best", "continue", "stop"], 14, 22),
    "recovery_resets_the_window": (
        2, 0.0, [(4, 1.0), (8, 0.9), (12, 1.5), (16, 1.4)],
        ["new_best", "continue", "new_best", "continue"], 12, None),
    "reprobe_same_epoch_replaces": (
        2, 0.0, [(10, 2.0), (14, 1.9), (14, 1.9)],
        ["new_best", "continue", "continue"], 10, None),
    "min_delta_gates_new_best": (3, 0.1, [(4, 1.0), (8, 1.05)], ["new_best", "continue"], 4,
                                 None),
    "patience_zero_never_stops": (
        0, 0.0, [(4, 2.0), (8, 1.0), (12, 1.0), (16, 1.0), (20, 1.0)],
        ["new_best"] + ["continue"] * 4, 4, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_decisions_equal_jax(tmp_path, case):
    patience, delta, probes, decisions, best, stopped = CASES[case]
    got = ProbeKeepBest(str(tmp_path / "got.json"), patience=patience, min_delta=delta)
    want = JProbe(str(tmp_path / "want.json"), patience=patience, min_delta=delta)
    for (epoch, value), decision in zip(probes, decisions, strict=True):
        assert got.would_be_best(value) == want.would_be_best(value)
        assert got.update(epoch, value) == want.update(epoch, value) == decision
        assert got.misses_since_best == want.misses_since_best
    assert (got.best_epoch, got.stopped_epoch) == (best, stopped)
    assert got.probes == want.probes
    assert json.loads((tmp_path / "got.json").read_text()) == json.loads(
        (tmp_path / "want.json").read_text())


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_state_file_crosses_packages(tmp_path, writer):
    """The resumable-run pattern across packages: one package's tracker
    records, the other's picks up the window and decides the stop."""
    first, second = (ProbeKeepBest, JProbe) if writer == "port" else (JProbe, ProbeKeepBest)
    path = str(tmp_path / "p.json")
    s = first(path, patience=2)
    s.update(10, 2.0)
    s.update(14, 1.9)
    s2 = second(path, patience=2)
    assert s2.best_epoch == 10 and s2.best_value == 2.0 and s2.misses_since_best == 1
    assert s2.update(18, 1.8) == "stop"
    s3 = first(path, patience=2)
    assert s3.stopped_epoch == 18 and s3.probes == s2.probes


class _FixedBatches:
    """The same batch ``n`` times an epoch."""

    def __init__(self, n=4, seed=0):
        rng = np.random.default_rng(seed)
        self.n = n
        self.src = rng.integers(1, 30, size=(4, 8)).astype(np.int32)
        self.tgt = rng.integers(1, 30, size=(4, 8)).astype(np.int32)

    def __len__(self):
        return self.n

    def batches(self, epoch=0):
        for _ in range(self.n):
            yield self.src, self.tgt


def test_truthy_callback_return_stops_fit(tmp_path):
    tc = dataclasses.replace(TCFG, epochs=6, checkpoint_every_epochs=5)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2, is_primary=True)
    logs, seen = [], []

    def cb(epoch, tr):
        seen.append(epoch)
        return epoch == 1  # stop after the second epoch

    tr = Trainer(TINY, tc, create_train_state(TINY, tc, device="cpu"), checkpoint=mgr,
                 log_fn=logs.append)
    tr.fit(_FixedBatches(n=4), epoch_callback=cb)
    assert seen == [0, 1]
    assert any("stop requested by epoch callback" in line for line in logs)
    assert mgr.all_steps() == [8]  # saved at the stop despite cadence 5
    assert not (tmp_path / "EARLY_STOPPED").exists()  # the plateau rule's marker only


def test_none_return_keeps_training():
    tc = dataclasses.replace(TCFG, epochs=3)
    seen = []
    tr = Trainer(TINY, tc, create_train_state(TINY, tc, device="cpu"), log_fn=lambda s: None)
    tr.fit(_FixedBatches(n=4), epoch_callback=lambda e, t: seen.append(e))
    assert seen == [0, 1, 2]


def test_probe_keep_best_stops_fit_on_the_probe(tmp_path):
    """``ProbeKeepBest`` as the callback, over a fixed probe sequence (1.0,
    2.0, 1.5, 1.4, ...): epoch 2 is the best, the fourth probe is the
    second miss and stops the run after its epoch."""
    tc = dataclasses.replace(TCFG, epochs=8)
    probe = ProbeKeepBest(str(tmp_path / "probe.json"), patience=2)
    values = {0: 1.0, 1: 2.0, 2: 1.5, 3: 1.4, 4: 3.0}

    def cb(epoch, tr):
        return probe.update(epoch + 1, values[epoch]) == "stop"

    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=3, is_primary=True)
    tr = Trainer(TINY, tc, create_train_state(TINY, tc, device="cpu"), checkpoint=mgr,
                 log_fn=lambda s: None)
    tr.fit(_FixedBatches(n=2), epoch_callback=cb)
    assert tr.state.step == 4 * 2  # four epochs: the fourth probe is the second miss
    assert (probe.best_epoch, probe.stopped_epoch) == (2, 4)
    assert JProbe(str(tmp_path / "probe.json")).stopped_epoch == 4
