"""The port trainer's telemetry against the JAX trainer's.

A tiny seq2seq model and a tiny decoder-only LM (weights from a JAX init,
converted by ``convert.params_from_numpy``) train 4 steps (2 epochs of 2
batches, made from numpy seeds, with a bounded eval every 2 steps and a
checkpoint manager) through JAX's ``Trainer`` and the port's, each with a
``Telemetry`` bundle (event log, Prometheus file, tracer, program
profiler) and TensorBoard writers. Then:

- the event kinds come in the same order, with the same field names per
  kind (spans per name), and the spans form the same parent tree (names,
  lanes);
- ``<file>.prom`` holds the same metric names and types;
- the TensorBoard files hold the same tags at the same steps;
- the port's losses and parameters are bit-identical to its own run with
  telemetry off (``Trainer.losses``, the parameter digest).

The port always emits ``train.predicted`` (and its
``train_predicted_peak_bytes`` gauge), the cost model's prediction of its
step; JAX's trainer emits its own where its cost model can trace (with
JAX versions whose ``jax.core`` still has ``Literal`` and ``ClosedJaxpr``)
and otherwise logs "cost-model prediction unavailable". Where JAX emitted
one, the two are compared like every other event (fields, order, the
gauge); where it did not, the port's is compared with
``train_step_costs`` run directly and left out of the comparison. A
``Profiler`` window of
``num_steps`` steps holds that many ``train.step`` ranges; SIGTERM with
the flight recorder armed still checkpoints; ``cli.train`` and
``cli.distributed_train`` write the telemetry their flags ask for.
"""

import json
import os
import signal
import struct

import jax
import numpy as np
import pytest

import transformer_tpu.obs as jobs
import transformer_tpu_torch.obs as tobs
from transformer_tpu.config import ModelConfig as JConfig
from transformer_tpu.config import TrainConfig as JTrain
from transformer_tpu.train.checkpoint import CheckpointManager as JCheckpoints
from transformer_tpu.train.checkpoint import _flatten
from transformer_tpu.train.state import create_train_state as j_create_state
from transformer_tpu.train.trainer import Trainer as JTrainer
from transformer_tpu_torch.analysis.costs import train_step_costs
from transformer_tpu_torch.config import ModelConfig, TrainConfig
from transformer_tpu_torch.convert import params_digest, params_from_numpy
from transformer_tpu_torch.train.checkpoint import CheckpointManager
from transformer_tpu_torch.train.state import create_train_state
from transformer_tpu_torch.train.trainer import Trainer
from transformer_tpu_torch.utils.profiling import Profiler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(num_layers=1, d_model=16, num_heads=2, dff=32, input_vocab_size=40,
            target_vocab_size=40, max_position=32, dtype="float32", dropout_rate=0.0)
MODELS = {"seq2seq": BASE, "lm": {**BASE, "decoder_only": True}}
TRAIN = dict(batch_size=4, sequence_length=8, epochs=2, warmup_steps=10, log_every_steps=1,
             eval_every_steps=2, eval_max_batches=1)


class Batches:
    """``n`` (src, tgt) batches an epoch, keyed on (seed, epoch, i); rows
    padded after their own lengths."""

    def __init__(self, n=2, seed=7):
        self.n, self.seed = n, seed

    def __len__(self):
        return self.n

    def batches(self, epoch=0):
        for i in range(self.n):
            rng = np.random.default_rng([self.seed, epoch, i])
            src = rng.integers(3, 40, size=(4, 8)).astype(np.int32)
            tgt = rng.integers(3, 40, size=(4, 8)).astype(np.int32)
            for row in range(4):
                src[row, 8 - row:] = 0
                tgt[row, 7 - row:] = 0
            yield src, tgt


def _telemetry(pkg, path):
    tel = pkg.Telemetry(events=pkg.EventLog(path), prom_path=f"{path}.prom",
                        interval=1e9, trace=True)
    tel.arm_profiler(baseline={})
    return tel


def _jax_fit(model_kw, root, steps_per_dispatch=1):
    cfg = JConfig(**model_kw)
    tcfg = JTrain(**TRAIN, steps_per_dispatch=steps_per_dispatch)
    state = j_create_state(jax.random.PRNGKey(0), cfg, tcfg)
    init = {k: np.asarray(v) for k, v in _flatten(state.params).items()}
    tel = _telemetry(jobs, str(root / "jax.jsonl"))
    trainer = JTrainer(cfg, tcfg, state, log_dir=str(root / "jax_tb"),
                       checkpoint=JCheckpoints(str(root / "jax_ckpt")), log_fn=lambda *_: None,
                       telemetry=tel)
    trainer.fit(Batches(), Batches(n=1, seed=9))
    tel.close()
    return init


def _port_fit(model_kw, init, root=None, telemetry=True, steps_per_dispatch=1, profiler=None,
              data=None):
    cfg = ModelConfig(**model_kw)
    tcfg = TrainConfig(**TRAIN, steps_per_dispatch=steps_per_dispatch)
    state = create_train_state(cfg, tcfg, params=params_from_numpy(init, cfg, device="cpu"))
    tel = _telemetry(tobs, str(root / "port.jsonl")) if telemetry else None
    trainer = Trainer(cfg, tcfg, state, log_fn=lambda *_: None, telemetry=tel,
                      checkpoint=CheckpointManager(str(root / ("port_ckpt" if telemetry
                                                               else "plain_ckpt"))),
                      log_dir=str(root / "port_tb") if telemetry else None, profiler=profiler)
    trainer.fit(data or Batches(), Batches(n=1, seed=9))
    if tel is not None:
        tel.close()
    return trainer


def _events(path):
    return jobs.read_events(path)


def _without_predicted(events):
    return [e for e in events if e["kind"] != "train.predicted"]


def _shape(events):
    """(kind, span name) in order, and the field names per (kind, name)."""
    order = [(e["kind"], e.get("name") if e["kind"] == "trace.span" else None)
             for e in events]
    fields = {}
    for e, key in zip(events, order):
        fields.setdefault(key, set()).update(k for k in e if k != "ts")
    return order, fields


def _tree(events):
    spans = [e for e in events if e["kind"] == "trace.span"]
    names = {e["span"]: e["name"] for e in spans}
    assert len({e["trace"] for e in spans}) == 1  # one train.fit tree
    return sorted((e["name"], e.get("lane"), names.get(e.get("parent"))) for e in spans)


def _prom_names(path):
    with open(path) as f:
        return sorted(tuple(line.split()[2:4]) for line in f if line.startswith("# TYPE"))


def _tfevents(log_dir):
    """{(run, tag): [steps]} of every tfevents file under ``log_dir``."""
    out = {}
    for run in ("train", "test"):
        d = os.path.join(log_dir, run)
        for name in sorted(os.listdir(d)):
            data = open(os.path.join(d, name), "rb").read()
            off = 0
            while off < len(data):
                (length,) = struct.unpack("<Q", data[off:off + 8])
                event = _proto(data[off + 12:off + 12 + length])
                off += 16 + length
                if 5 not in event:
                    continue  # the file-version record
                step = event.get(2, [0])[0]
                for value in _proto(event[5][0]).get(1, []):
                    tag = _proto(value)[1][0].decode()
                    out.setdefault((run, tag), []).append(step)
    return out


def _proto(buf):
    fields, off = {}, 0
    while off < len(buf):
        tag, off = _varint(buf, off)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, off = _varint(buf, off)
        elif wire == 1:
            val, off = buf[off:off + 8], off + 8
        elif wire == 5:
            val, off = buf[off:off + 4], off + 4
        else:
            n, off = _varint(buf, off)
            val, off = buf[off:off + n], off + n
        fields.setdefault(field, []).append(val)
    return fields


def _varint(buf, off):
    shift = val = 0
    while True:
        b = buf[off]
        off += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, off
        shift += 7


@pytest.mark.parametrize("spd", [1, 2])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_train_telemetry_matches_jax(model, spd, tmp_path):
    model_kw = MODELS[model]
    init = _jax_fit(model_kw, tmp_path, spd)
    port = _port_fit(model_kw, init, tmp_path, steps_per_dispatch=spd)
    plain = _port_fit(model_kw, init, tmp_path, telemetry=False, steps_per_dispatch=spd)
    assert port.state.step == plain.state.step == 4
    # Inert: the same losses and parameters, bit for bit.
    assert port.losses == plain.losses
    assert params_digest(port.state.params) == params_digest(plain.state.params)

    jev, tev = _events(str(tmp_path / "jax.jsonl")), _events(str(tmp_path / "port.jsonl"))
    # The port's prediction, always: one event at fit start, the cost
    # model's numbers for this run's config.
    pred = [e for e in tev if e["kind"] == "train.predicted"]
    assert len(pred) == 1
    want = train_step_costs(ModelConfig(**model_kw), TrainConfig(**TRAIN, steps_per_dispatch=spd))
    assert {k: pred[0][k] for k in ("program", "peak_bytes", "flops", "bytes_moved",
                                    "tokens_per_step")} == {
        "program": "train_step", "peak_bytes": want.peak_bytes, "flops": want.flops,
        "bytes_moved": want.bytes_moved, "tokens_per_step": TRAIN["batch_size"] *
        TRAIN["sequence_length"]}
    jpred = [e for e in jev if e["kind"] == "train.predicted"]
    if jpred:  # JAX's cost model traced: its prediction compared like any event
        assert pred[0]["tokens_per_step"] == jpred[0]["tokens_per_step"]
    else:
        tev = _without_predicted(tev)
    jorder, jfields = _shape(jev)
    torder, tfields = _shape(tev)
    assert torder == jorder
    assert tfields == jfields
    assert _tree(tev) == _tree(jev)
    jnames = set(_prom_names(str(tmp_path / "jax.jsonl.prom")))
    if not jpred:
        jnames.add(("train_predicted_peak_bytes", "gauge"))
    assert _prom_names(str(tmp_path / "port.jsonl.prom")) == sorted(jnames)

    jtb = _tfevents(os.path.join(tmp_path, "jax_tb"))
    assert _tfevents(os.path.join(tmp_path, "port_tb")) == jtb
    assert jtb[("train", "loss")] == [0, 1] and ("test", "loss") in jtb

    # The port's numbers: 4 steps counted, one train.step sample a dispatch.
    snap = [e for e in tev if e["kind"] == "metrics.snapshot"][-1]["metrics"]
    assert snap["train_steps_total"] == 4
    assert snap["train_step_seconds"]["count"] == 4
    assert snap["perf_seconds_train_step"]["count"] == 4 // spd
    compile_ev = [e for e in tev if e["kind"] == "train.compile"][-1]
    assert compile_ev["cache_sizes"] == (
        {"train_step": 0, "eval_step": 0} if spd == 1
        else {"train_step": 0, "multi_step": 0, "eval_step": 0})


def test_profiler_window_holds_num_steps_train_step_ranges(tmp_path):
    init = {k: np.asarray(v) for k, v in _flatten(
        j_create_state(jax.random.PRNGKey(0), JConfig(**MODELS["lm"]), JTrain(**TRAIN)).params
    ).items()}
    prof = Profiler(str(tmp_path / "prof"), start_step=1, num_steps=2)
    trainer = _port_fit(MODELS["lm"], init, tmp_path, telemetry=False, profiler=prof,
                        data=Batches(n=3))
    assert trainer.state.step == 6
    assert prof.trace_path and os.path.dirname(prof.trace_path) == str(tmp_path / "prof")
    with open(prof.trace_path) as f:
        trace = json.load(f)
    ranges = [e for e in trace["traceEvents"] if e.get("name") == "train.step"]
    assert len(ranges) == 2


def test_sigterm_with_the_flight_recorder_armed_checkpoints(tmp_path):
    """The recorder's SIGTERM handler is installed before the fit (as
    ``flags_to_telemetry`` installs it); the trainer's guard still latches
    the signal, saves the checkpoint and emits ``train.preempt``, and the
    recorder dumps its ring."""
    model_kw = MODELS["lm"]
    cfg = ModelConfig(**model_kw)
    tcfg = TrainConfig(**TRAIN)
    state = create_train_state(cfg, tcfg, device="cpu")
    path = str(tmp_path / "p.jsonl")
    tel = tobs.Telemetry(events=tobs.EventLog(path), interval=1e9)
    rec = tel.arm_flight(f"{path}.flight.json")

    class Kill(Batches):
        def batches(self, epoch=0):
            for i, b in enumerate(super().batches(epoch)):
                if epoch == 1 and i == 1:
                    os.kill(os.getpid(), signal.SIGTERM)
                yield b

    original = signal.getsignal(signal.SIGTERM)
    logs = []
    try:
        rec.install_signal_handlers()
        trainer = Trainer(cfg, tcfg, state, log_fn=logs.append, telemetry=tel,
                          checkpoint=CheckpointManager(str(tmp_path / "ck")))
        trainer.fit(Kill())
    finally:
        signal.signal(signal.SIGTERM, original)
    tel.close()
    assert any(line.startswith("preemption (signal 15) at step 4") for line in logs), logs
    assert CheckpointManager(str(tmp_path / "ck")).latest_step == 4
    kinds = [e["kind"] for e in tobs.read_events(path)]
    assert "train.preempt" in kinds and "flight.dump" in kinds
    with open(f"{path}.flight.json") as f:
        assert json.load(f)["reason"] in ("signal", "close")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("tel_corpus")
    for side in ("src", "tgt"):
        for split, n in (("train", 60), ("test", 12)):
            with open(os.path.join(ROOT, "data", f"{side}-{split}.txt"), encoding="utf-8") as f:
                lines = [next(f) for _ in range(n)]
            (d / f"{side}-{split}.txt").write_text("".join(lines), encoding="utf-8")
    return d


def _cli_argv(d, tmp_path, *extra):
    return ["--device=cpu", "--decoder_only", "--dataset_path", str(d), "--tgt_vocab_file",
            str(d / "v.subwords"), "--target_vocab_size", "300", "--num_layers", "1",
            "--d_model", "16", "--dff", "32", "--num_heads", "2", "--sequence_length", "32",
            "--batch_size", "8", "--epochs", "1", "--ckpt_path", str(tmp_path / "ckpt"),
            "--export_path", str(tmp_path / "export"), "--metrics_jsonl",
            str(tmp_path / "m.jsonl"), "--trace", "--profile_dir", str(tmp_path / "prof"),
            "--profile_start_step", "1", "--profile_num_steps", "2", "--tb_log_dir",
            str(tmp_path / "tb"), *extra]


@pytest.mark.parametrize("cli", ["train", "distributed_train"])
def test_cli_writes_the_telemetry_its_flags_ask_for(corpus, tmp_path, cli, capsys):
    from transformer_tpu_torch.cli import distributed_train, train
    from transformer_tpu_torch.obs.__main__ import main as obs_main

    main = train.main if cli == "train" else distributed_train.main
    trainer = main(_cli_argv(corpus, tmp_path), log_fn=lambda *_: None)
    steps = trainer.state.step
    events = tobs.read_events(str(tmp_path / "m.jsonl"))
    kinds = {e["kind"] for e in events}
    assert {"train.window", "train.compile", "metrics.snapshot", "trace.span",
            "flight.dump"} <= kinds
    snap = [e for e in events if e["kind"] == "metrics.snapshot"][-1]["metrics"]
    assert snap["train_steps_total"] == steps
    assert os.path.exists(tmp_path / "m.jsonl.prom")
    assert os.path.exists(tmp_path / "m.jsonl.flight.json")
    assert len(os.listdir(tmp_path / "prof")) == 1
    (stamp,) = os.listdir(tmp_path / "tb")
    assert sorted(os.listdir(tmp_path / "tb" / stamp)) == ["test", "train"]
    capsys.readouterr()
    assert obs_main(["summarize", str(tmp_path / "m.jsonl")]) == 0
    out = capsys.readouterr().out
    assert f"train: {steps} steps" in out and "perf: " in out and "train.step" in out
