"""Training that survives: gradient accumulation, the chunked loss and
adamw against the JAX package, and resume, preemption, early stop and the
checkpoint CLIs of the port.

- ``grad_accum_steps`` 2 and 4: three steps under plain SGD (lr 0.5, so
  the parameters carry the raw gradient sums; Adam would amplify rounding
  of near-zero gradients) equal the whole-batch port steps and JAX's
  accumulation: loss within 2e-5 relative, params within 1e-5 absolute
  (the JAX package's own accumulation test's limits); a count that does
  not divide the batch raises.
- ``loss_chunks`` 2 and 4 (4 does not divide the 63 scored positions):
  the train step against JAX's chunked step and the port's unchunked one,
  loss and sums within 1e-6 relative, params within 1e-6; the eval step
  within 1e-6; chunks 2 with accumulation 2 against JAX's combination
  within 2e-5 / 1e-5.
- adamw (with clipping): three updates against optax's (jitted, as the
  JAX train step runs it) on the same grads and params within 1e-6
  relative plus 1e-6 of the leaf's largest update (where the decay term
  cancels the Adam term an element's relative error has no bound); with
  zero gradients, the pure decay within 1e-6 relative, on every leaf of
  rank >= 2 not named ``bias`` and on no other.
- Resume: a 2-epoch run and a 1-epoch run resumed to 2 epochs (dropout
  0.1, shuffled (seed, epoch) batches) end with identical
  ``params_digest``, sync and async; SIGTERM delivered in-process during
  epoch 2 saves a manifest-verified checkpoint at the logged step and the
  relaunch replays epoch 2 and ends n steps later.
- Early stop: a plateau stops the run; the marker blocks a relaunch; the
  patience window survives a resume; an empty eval gives no signal; an
  epoch callback's stop saves a checkpoint and writes no marker.
- CLIs on the CPU: ``cli.train`` resumes from ``--ckpt_path`` and after a
  finished run trains nothing and exports again; ``cli.export
  --average_last 2 --quantize int8`` writes an export within the int8
  bound of the fp32 average and smaller than fp32, with its usage
  errors; ``cli.distributed_train`` over 2 gloo processes: rank 0 writes,
  and a resumed run's parameters equal an uninterrupted run's (a
  micro-batch that does not split over the data axis raises); the
  default ``--ckpt_path`` is ``model_dist`` in the working directory, and
  no run of the tests writes one in the repository root.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from transformer_tpu.config import ModelConfig as JConfig
from transformer_tpu.config import TrainConfig as JTrain
from transformer_tpu.train.checkpoint import _flatten as j_flatten
from transformer_tpu.train.state import TrainState as JState
from transformer_tpu.train.state import create_train_state as j_create_state
from transformer_tpu.train.state import make_optimizer as j_make_optimizer
from transformer_tpu.train.trainer import make_eval_step as j_make_eval_step
from transformer_tpu.train.trainer import make_train_step as j_make_train_step
from transformer_tpu_torch.config import ModelConfig, TrainConfig
from transformer_tpu_torch.convert import load_export, params_digest, params_from_numpy
from transformer_tpu_torch.models.transformer import flatten, unflatten
from transformer_tpu_torch.train.checkpoint import (
    AsyncCheckpointManager,
    CheckpointManager,
    _q8_group_axes,
    average_checkpoints,
    verify_manifest,
)
from transformer_tpu_torch.train.state import TrainState, create_train_state, make_optimizer
from transformer_tpu_torch.train.trainer import Trainer, make_eval_step, make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(
    num_layers=1, d_model=32, num_heads=4, dff=64, input_vocab_size=50,
    target_vocab_size=60, max_position=64, dropout_rate=0.0, dtype="float32",
    attention_impl="flash",
)
TRAIN = dict(batch_size=4, sequence_length=64, warmup_steps=4, label_smoothing=0.1)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _pairs(seed, b=4, s=64):
    """(src, tgt) id batches, each row padded after its own length."""
    rng = np.random.default_rng(seed)
    src = rng.integers(1, MODEL["input_vocab_size"], size=(b, s)).astype(np.int32)
    tgt = rng.integers(1, MODEL["target_vocab_size"], size=(b, s)).astype(np.int32)
    for row in range(b):
        src[row, s - 3 * row - 1:] = 0
        tgt[row, s - 5 * row - 2:] = 0
    return src, tgt


class _SGD:
    """optax.sgd(lr) on the port's flat dicts: the update is -lr * g."""

    def __init__(self, lr):
        self.lr = lr

    def update(self, grads, state, params=None):
        return {k: -self.lr * g for k, g in grads.items()}, state


def _sgd_runs(train_kw: dict, steps: int = 3, whole: bool = True):
    """(JAX losses, JAX params, port losses, port params[, port whole-batch
    losses and params]) after ``steps`` SGD steps from one JAX init."""
    jcfg, cfg = JConfig(**MODEL), ModelConfig(**MODEL)
    init = j_create_state(jax.random.PRNGKey(0), jcfg, JTrain(**TRAIN)).params
    sgd = optax.sgd(0.5)
    jstate = JState(step=jnp.int32(0), params=init, opt_state=sgd.init(init))
    jstep = jax.jit(j_make_train_step(jcfg, JTrain(**TRAIN, **train_kw), tx=sgd))
    runs = [("port", train_kw)] + ([("whole", {})] if whole else [])
    states = {name: TrainState(0, params_from_numpy(j_flatten(init), cfg, device="cpu"), None)
              for name, _ in runs}
    for st in states.values():
        for p in flatten(st.params).values():
            p.requires_grad_(True)
    port_steps = {name: make_train_step(cfg, TrainConfig(**TRAIN, **kw), tx=_SGD(0.5))
                  for name, kw in runs}
    losses = {"jax": [], **{name: [] for name, _ in runs}}
    for i in range(steps):
        src, tgt = _pairs(30 + i)
        jstate, jm = jstep(jstate, src, tgt, jax.random.PRNGKey(0))
        losses["jax"].append(float(jm["loss"]))
        for name, _ in runs:
            states[name], m = port_steps[name](states[name], src, tgt)
            losses[name].append(float(m["loss"]))
    params = {name: {k: v.detach().numpy() for k, v in flatten(st.params).items()}
              for name, st in states.items()}
    params["jax"] = j_flatten(jstate.params)
    return losses, params


def _close(losses, params, a, b, loss_rtol, atol):
    for got, want in zip(losses[a], losses[b]):
        assert abs(got - want) <= loss_rtol * abs(want), (a, b, losses[a], losses[b])
    for key, want in params[b].items():
        np.testing.assert_allclose(params[a][key], want, rtol=0, atol=atol, err_msg=f"{a} {key}")


# --------------------------------------------------------------------------
# gradient accumulation, chunked loss, adamw


@pytest.mark.parametrize("accum", [2, 4])
def test_grad_accum_equals_whole_batch_and_jax(accum):
    losses, params = _sgd_runs(dict(grad_accum_steps=accum))
    _close(losses, params, "port", "jax", 2e-5, 1e-5)
    _close(losses, params, "port", "whole", 2e-5, 1e-5)


def test_grad_accum_must_divide_the_batch():
    cfg, tcfg = ModelConfig(**MODEL), TrainConfig(**TRAIN, grad_accum_steps=3)
    state = create_train_state(cfg, tcfg, device="cpu")
    with pytest.raises(ValueError, match="must divide the batch 4"):
        make_train_step(cfg, tcfg)(state, *_pairs(0))


@pytest.mark.parametrize("chunks", [2, 4])
def test_loss_chunks_equal_jax_and_the_unchunked_loss(chunks):
    losses, params = _sgd_runs(dict(loss_chunks=chunks), steps=2)
    _close(losses, params, "port", "jax", 1e-6, 1e-6)
    _close(losses, params, "port", "whole", 1e-6, 1e-6)
    # eval, and the exact sums
    jcfg, cfg = JConfig(**MODEL), ModelConfig(**MODEL)
    jstate = j_create_state(jax.random.PRNGKey(0), jcfg, JTrain(**TRAIN))
    state = create_train_state(cfg, TrainConfig(**TRAIN),
                               params=params_from_numpy(j_flatten(jstate.params), cfg, "cpu"))
    src, tgt = _pairs(40)
    want = j_make_eval_step(jcfg, JTrain(**TRAIN, loss_chunks=chunks))(jstate, src, tgt)
    got = make_eval_step(cfg, TrainConfig(**TRAIN, loss_chunks=chunks))(state, src, tgt)
    plain = make_eval_step(cfg, TrainConfig(**TRAIN))(state, src, tgt)
    for key in ("loss", "loss_sum", "weight", "correct"):
        assert _rel(float(got[key]), float(want[key])) <= 1e-6, key
        assert _rel(float(got[key]), float(plain[key])) <= 1e-6, key


def test_loss_chunks_compose_with_grad_accum():
    losses, params = _sgd_runs(dict(loss_chunks=2, grad_accum_steps=2))
    _close(losses, params, "port", "jax", 2e-5, 1e-5)
    _close(losses, params, "port", "whole", 2e-5, 1e-5)


def test_adamw_matches_optax_and_its_decay_mask():
    jcfg, cfg = JConfig(**MODEL), ModelConfig(**MODEL)
    kw = dict(optimizer="adamw", weight_decay=0.1, max_grad_norm=0.5)
    jtx, tx = j_make_optimizer(jcfg, JTrain(**TRAIN, **kw)), make_optimizer(cfg, TrainConfig(**TRAIN, **kw))
    rng = np.random.default_rng(1)
    # In optax's (sorted) leaf order, so that the clip's global norm sums alike.
    params = {"a/bias": rng.standard_normal((3, 5)).astype(np.float32),  # 2-D, still exempt
              "a/kernel": rng.standard_normal((4, 5)).astype(np.float32),
              "ln/scale": rng.standard_normal((5,)).astype(np.float32)}
    def tree(flat):  # optax's mask reads the leaf's own name: nest the flat names
        return jax.tree.map(jnp.asarray, unflatten(dict(flat)))

    jstate, state = jtx.init(tree(params)), tx.init({k: torch.from_numpy(v) for k, v in params.items()})
    # jitted, as the JAX train step runs it (eager optax rounds the bias
    # correction's power differently)
    j_update = jax.jit(jtx.update)
    for step in range(3):
        grads = {k: (rng.standard_normal(v.shape) * 10 ** (step - 1)).astype(np.float32)
                 for k, v in params.items()}
        jup, jstate = j_update(tree(grads), jstate, tree(params))
        up, state = tx.update({k: torch.from_numpy(v) for k, v in grads.items()}, state,
                              {k: torch.from_numpy(v) for k, v in params.items()})
        jup = j_flatten(jup)
        for k in params:  # the decay term can cancel the Adam term: see the docstring
            np.testing.assert_allclose(up[k].numpy(), jup[k], rtol=1e-6,
                                       atol=1e-6 * np.abs(jup[k]).max())
    # zero gradients: the update is the decay alone, on the model's own leaves
    jtx = j_make_optimizer(jcfg, JTrain(**TRAIN, optimizer="adamw", weight_decay=0.1))
    tx = make_optimizer(cfg, TrainConfig(**TRAIN, optimizer="adamw", weight_decay=0.1))
    leaves = flatten(create_train_state(cfg, TrainConfig(**TRAIN), device="cpu").params)
    zero = {k: torch.zeros_like(v) for k, v in leaves.items()}
    state = tx.init(leaves)
    jparams = tree({k: v.detach().numpy() for k, v in leaves.items()})
    jstate, j_update = jtx.init(jparams), jax.jit(jtx.update)
    for _ in range(3):
        up, state = tx.update(zero, state, leaves)
        jup, jstate = j_update(jax.tree.map(jnp.zeros_like, jparams), jstate, jparams)
    jup = j_flatten(jup)
    for k, u in up.items():
        np.testing.assert_allclose(u.numpy(), jup[k], rtol=1e-6, atol=1e-12)
        decayed = leaves[k].dim() >= 2 and not k.endswith("bias")
        assert (float(u.abs().max()) > 0.0) == decayed, k


# --------------------------------------------------------------------------
# resume and preemption through Trainer.fit

RESUME_MODEL = {**MODEL, "dropout_rate": 0.1}


class _Batches:
    """``n`` distinct batches an epoch, in an order keyed on (seed, epoch);
    ``on_batch(epoch, i)`` runs before batch i is handed out."""

    def __init__(self, n=3, seed=0, on_batch=None):
        self.data = [_pairs(100 * seed + i) for i in range(n)]
        self.seed, self.on_batch = seed, on_batch

    def __len__(self):
        return len(self.data)

    def batches(self, epoch=0):
        order = np.random.default_rng([self.seed, epoch]).permutation(len(self.data))
        for i, j in enumerate(order):
            if self.on_batch is not None:
                self.on_batch(epoch, i)
            yield self.data[j]


def _fit(epochs, ckpt=None, train=None, test=None, **train_kw):
    cfg = ModelConfig(**RESUME_MODEL)
    tcfg = TrainConfig(**{**TRAIN, "epochs": epochs, "eval_every_steps": 0,
                          "log_every_steps": 0, **train_kw})
    logs = []
    trainer = Trainer(cfg, tcfg, create_train_state(cfg, tcfg, device="cpu"),
                      log_fn=logs.append, checkpoint=ckpt)
    trainer.fit(train or _Batches(), test)
    return trainer, logs


@pytest.mark.parametrize("manager", [CheckpointManager, AsyncCheckpointManager])
def test_resumed_run_equals_uninterrupted(tmp_path, manager):
    whole, _ = _fit(2, manager(str(tmp_path / "u")))
    _fit(1, manager(str(tmp_path / "r")))
    resumed, logs = _fit(2, manager(str(tmp_path / "r")))
    assert "restored checkpoint at step 3" in logs and "resuming at epoch 2/2 (step 3)" in logs
    assert len(resumed.step_seconds) == 3 and resumed.state.step == whole.state.step == 6
    assert params_digest(resumed.state.params) == params_digest(whole.state.params)
    assert resumed.state.opt_state.count == 6
    for k, mu in whole.state.opt_state.mu.items():
        assert torch.equal(mu, resumed.state.opt_state.mu[k]), k
    assert CheckpointManager(str(tmp_path / "r")).all_steps() == [3, 6]


def test_sigterm_saves_and_the_relaunch_resumes(tmp_path):
    def kill_in_epoch_2(epoch, i):
        if epoch == 1 and i == 1:
            os.kill(os.getpid(), signal.SIGTERM)

    mgr = AsyncCheckpointManager(str(tmp_path))
    trainer, logs = _fit(2, mgr, _Batches(on_batch=kill_in_epoch_2))
    preempt = [ln for ln in logs if ln.startswith("preemption")]
    assert preempt == [f"preemption (signal {int(signal.SIGTERM)}) at step 5: "
                       f"checkpoint saved to {mgr.path(5)}"], logs
    assert mgr.all_steps() == [5] and trainer.state.step == 5
    verify_manifest(mgr.path(5))
    assert signal.getsignal(signal.SIGTERM) is not None  # the guard restored the handler
    relaunched, logs = _fit(2, CheckpointManager(str(tmp_path)))
    assert "resuming at epoch 2/2 (step 5)" in logs
    assert relaunched.state.step == 8 and len(relaunched.step_seconds) == 3


# --------------------------------------------------------------------------
# early stop (the JAX package's tests, ported)

TINY = dict(num_layers=1, d_model=16, num_heads=2, dff=32, input_vocab_size=30,
            target_vocab_size=30, max_position=32, dtype="float32", dropout_rate=0.0)


class _Fixed:
    """The same batch ``n`` times an epoch."""

    def __init__(self, n=4, seed=0):
        rng = np.random.default_rng(seed)
        self.n = n
        self.src, self.tgt = (rng.integers(1, 30, (4, 8)).astype(np.int32) for _ in range(2))

    def __len__(self):
        return self.n

    def batches(self, epoch=0):
        for _ in range(self.n):
            yield self.src, self.tgt


def _tiny_fit(tmp_path, epochs, train, test, max_to_keep=2, **kw):
    cfg = ModelConfig(**TINY)
    tcfg = TrainConfig(batch_size=4, sequence_length=8, epochs=epochs, eval_every_steps=0,
                       log_every_steps=0, **kw)
    mgr = None if tmp_path is None else CheckpointManager(str(tmp_path), max_to_keep=max_to_keep)
    logs = []
    trainer = Trainer(cfg, tcfg, create_train_state(cfg, tcfg, device="cpu"),
                      log_fn=logs.append, checkpoint=mgr)
    trainer.fit(train, test)
    return trainer, logs, mgr


def test_stops_when_eval_plateaus():
    _, logs, _ = _tiny_fit(None, 40, _Fixed(8, 0), _Fixed(2, 7), warmup_steps=10,
                           early_stop_patience=2)
    assert any("early stop" in ln for ln in logs), logs[-3:]
    assert len([ln for ln in logs if "done in" in ln]) < 40


def test_early_stop_marker_blocks_relaunch(tmp_path):
    kw = dict(warmup_steps=10, early_stop_patience=2, checkpoint_every_epochs=1)
    _, logs, mgr = _tiny_fit(tmp_path, 40, _Fixed(8, 0), _Fixed(2, 7), **kw)
    assert any("early stop" in ln for ln in logs)
    assert (tmp_path / "EARLY_STOPPED").exists()
    saved = mgr.all_steps()
    _, logs, mgr = _tiny_fit(tmp_path, 40, _Fixed(8, 0), _Fixed(2, 7), **kw)
    assert any("marker present" in ln for ln in logs)
    assert not any("done in" in ln for ln in logs)
    assert mgr.all_steps() == saved


def test_plateau_window_survives_resume(tmp_path):
    # A warmup so long the learning rate is ~0: every epoch's eval loss is
    # the same, so epoch 1 sets the best and every later epoch plateaus.
    kw = dict(warmup_steps=10**9, early_stop_patience=2, checkpoint_every_epochs=1)
    _, logs, _ = _tiny_fit(tmp_path, 2, _Fixed(2, 0), _Fixed(1, 7), **kw)
    assert not any("early stop" in ln for ln in logs)
    assert (tmp_path / "plateau.json").exists()
    _, logs, _ = _tiny_fit(tmp_path, 40, _Fixed(2, 0), _Fixed(1, 7), **kw)
    assert any("resumed early-stop window" in ln for ln in logs), logs[:3]
    assert len([ln for ln in logs if "done in" in ln]) == 1, logs  # one more plateau epoch
    assert any("early stop" in ln for ln in logs)


def test_epoch_callback_stop_saves_without_the_marker(tmp_path):
    cfg, tcfg = ModelConfig(**TINY), TrainConfig(batch_size=4, sequence_length=8, epochs=5,
                                                  eval_every_steps=0, log_every_steps=0)
    mgr, logs, seen = CheckpointManager(str(tmp_path)), [], []
    trainer = Trainer(cfg, tcfg, create_train_state(cfg, tcfg, device="cpu"),
                      log_fn=logs.append, checkpoint=mgr)
    trainer.fit(_Fixed(3, 0), _Fixed(1, 7),
                epoch_callback=lambda epoch, t: seen.append(epoch) or epoch == 1)
    assert seen == [0, 1] and mgr.all_steps() == [6]  # the cadence (5) alone saves nothing
    assert "stop requested by epoch callback after epoch 2" in logs
    assert not (tmp_path / "EARLY_STOPPED").exists()


def test_empty_eval_gives_no_signal():
    class _Empty:
        def __len__(self):
            return 0

        def batches(self, epoch=0):
            return iter(())

    _, logs, _ = _tiny_fit(None, 4, _Fixed(2, 0), _Empty(), warmup_steps=10,
                           early_stop_patience=1)
    assert len([ln for ln in logs if "done in" in ln]) == 4
    assert not any("early stop" in ln for ln in logs)


# --------------------------------------------------------------------------
# the CLIs


def _corpus(path, train_lines=200, test_lines=40):
    for split, n in (("train", train_lines), ("test", test_lines)):
        for side in ("src", "tgt"):
            with open(os.path.join(ROOT, "data", f"{side}-{split}.txt"), encoding="utf-8") as f:
                head = [next(f) for _ in range(n)]
            (path / f"{side}-{split}.txt").write_text("".join(head), encoding="utf-8")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("corpus")
    _corpus(path)
    from transformer_tpu_torch.data.tokenizer import SubwordTokenizer

    for side in ("src", "tgt"):
        lines = (path / f"{side}-train.txt").read_text(encoding="utf-8").splitlines()
        SubwordTokenizer.build_from_corpus(lines, target_vocab_size=1000).save(
            str(path / f"{side}.subwords"))
    return path


def _model_flags(corpus, *extra):
    return ["--device", "cpu", "--dataset_path", str(corpus),
            "--src_vocab_file", str(corpus / "src.subwords"),
            "--tgt_vocab_file", str(corpus / "tgt.subwords"), "--num_layers", "1",
            "--d_model", "32", "--dff", "64", "--num_heads", "4", "--sequence_length", "64",
            "--batch_size", "16", *extra]


def test_cli_resume_and_export_average_int8(corpus, tmp_path):
    from transformer_tpu_torch.cli import export, train

    ckpt = str(tmp_path / "ckpt")
    flags = _model_flags(corpus, "--ckpt_path", ckpt, "--eval_bleu", "false",
                         "--export_path", str(tmp_path / "fp32"))
    first = train.main([*flags, "--epochs", "1"], log_fn=lambda _: None)
    n = first.state.step
    logs = []
    second = train.main([*flags, "--epochs", "2"], log_fn=logs.append)
    assert f"resuming at epoch 2/2 (step {n})" in logs and second.state.step == 2 * n
    logs = []
    third = train.main([*flags, "--epochs", "2"], log_fn=logs.append)  # a finished run
    assert f"resuming at epoch 3/2 (step {2 * n})" in logs
    assert not third.step_seconds and any(ln.startswith("exported params") for ln in logs)
    assert params_digest(third.state.params) == params_digest(second.state.params)

    q8 = str(tmp_path / "q8")
    assert export.main([*flags, "--average_last", "2", "--quantize", "int8",
                        "--export_path", q8], log_fn=lambda _: None) == [n, 2 * n]
    template = second.state
    want = flatten(average_checkpoints(CheckpointManager(ckpt), template, [n, 2 * n]))
    got, cfg = load_export(q8, device="cpu")
    assert cfg == second.model_cfg
    quantized = 0
    for key, g in flatten(got).items():
        w = want[key].numpy()
        if w.ndim < 2 or w.size < 1024 or key.endswith("/bias"):
            assert np.array_equal(g.numpy(), w), key
        else:
            quantized += 1
            step = np.max(np.abs(w), axis=_q8_group_axes(key, w), keepdims=True) / 127.0
            assert np.all(np.abs(w - g.numpy()) <= step * 0.5 + 1e-8), key
    assert quantized > 0
    size = lambda d: os.path.getsize(os.path.join(d, "params.npz"))  # noqa: E731
    assert size(q8) < size(str(tmp_path / "fp32")) / 2.5

    with pytest.raises(ValueError, match="--quantize"):  # before any restore
        export.main([*flags, "--quantize", "int4", "--ckpt_path", str(tmp_path / "none")])
    assert not (tmp_path / "none").exists()
    with pytest.raises(ValueError, match=rf"available: \[{n}, {2 * n}\]"):
        export.main([*flags, "--step", "999", "--export_path", str(tmp_path / "x")])


def test_cli_checkpoints_to_model_dist_in_the_working_directory(corpus, tmp_path, monkeypatch):
    """The default ``--ckpt_path`` is ``model_dist``, relative to the
    working directory, as the JAX CLI has it; every CLI run of the tests
    passes its own, so none writes one into the repository root."""
    from transformer_tpu_torch.cli import train

    monkeypatch.chdir(tmp_path)
    train.main(_model_flags(corpus, "--epochs", "1", "--eval_bleu", "false",
                            "--export_path", str(tmp_path / "export")), log_fn=lambda _: None)
    assert CheckpointManager(str(tmp_path / "model_dist")).all_steps() != []
    assert not os.path.exists(os.path.join(ROOT, "model_dist"))


def test_distributed_micro_batch_must_split_over_data():
    from test_torch_distributed import _fake_mesh
    from transformer_tpu_torch.config import MeshConfig
    from transformer_tpu_torch.parallel.distributed import DistributedTrainer

    cfg = ModelConfig(**{**MODEL, "decoder_only": True})
    with pytest.raises(ValueError, match="micro-batch of 1 rows"):
        DistributedTrainer(cfg, TrainConfig(**{**TRAIN, "grad_accum_steps": 4}),
                           _fake_mesh(MeshConfig(data=2)))


def _torchrun_start(corpus, ckpt, epochs, report, export):
    """``cli.distributed_train`` on 2 processes under ``torch.distributed
    .run``, started; ``_torchrun_wait`` waits for it."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(name, None)
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "transformer_tpu_torch.cli.distributed_train", "--device", "cpu",
         "--decoder_only", "--target_vocab_size", "400", "--num_layers", "1", "--d_model", "32",
         "--dff", "64", "--num_heads", "4", "--sequence_length", "64", "--batch_size", "8",
         "--dropout_rate", "0.1", "--dataset_path", str(corpus),
         "--tgt_vocab_file", str(corpus / "tgt.subwords"), "--epochs", str(epochs),
         "--ckpt_path", str(ckpt), "--export_path", str(export),
         "--metrics_json", str(report)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT,
    )


def _torchrun_wait(proc, report):
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stdout[-3000:] + stderr[-3000:]
    return stdout, json.loads(report.read_text())["ranks"]


def test_distributed_train_rank0_writes_and_resumes_over_gloo(corpus, tmp_path):
    # U (two epochs) and R's first epoch run side by side, then R resumes
    u = _torchrun_start(corpus, tmp_path / "u", 2, tmp_path / "u.json", tmp_path / "u_export")
    r1 = _torchrun_start(corpus, tmp_path / "r", 1, tmp_path / "r1.json", tmp_path / "r_export")
    _, whole = _torchrun_wait(u, tmp_path / "u.json")
    _, first = _torchrun_wait(r1, tmp_path / "r1.json")
    out, resumed = _torchrun_wait(
        _torchrun_start(corpus, tmp_path / "r", 2, tmp_path / "r2.json", tmp_path / "r_export"),
        tmp_path / "r2.json")
    n = first[0]["step"]
    assert f"resuming at epoch 2/2 (step {n})" in out
    assert [r["checkpoint_writer"] for r in resumed] == [True, False]
    assert {r["params_sha256"] for r in resumed} == {r["params_sha256"] for r in whole}
    assert len({r["params_sha256"] for r in whole}) == 1 and resumed[0]["step"] == 2 * n
    assert CheckpointManager(str(tmp_path / "r")).all_steps() == [n, 2 * n]
