"""``steps_per_dispatch``: the port's K-step dispatch against the JAX
package's ``make_multistep_train_step`` and against K single steps.

- The K-step dispatch (K 4, stacked (K, B, S) seq2seq batches, tiny
  model, weights converted from a JAX init, dropout 0) against jitted
  JAX ``make_multistep_train_step`` over JAX's step, with
  ``loss_normalization`` "tokens" and "batch": params within rtol 1e-5 /
  atol 1e-6, metric sums within 1e-5 relative. The attention key biases
  are held to 2x the summed learning rate instead: the softmax cancels
  them, so their gradient is rounding noise and Adam moves them by about
  ±lr whatever its sign (``tests/test_torch_train.py``).
- The K-step dispatch equals K single port steps bit for bit, with
  dropout 0.1, with remat on, and with ``grad_accum_steps`` 2.
- ``Trainer.fit`` at K 3 over 7 batches whose last is narrower (groups of
  3 + 3 + 1, the width change flushing a group) against K 1: params bit
  for bit, epoch loss and accuracy within 1e-6 (the sums add in another
  order). The boundary-crossing log and eval of ``tests/test_train.py``'s
  K-step test. K > 1 with ``enable_function=False`` raises. A run resumed
  at K 3 ends with an uninterrupted K 3 run's parameters.
- ``stage`` packs batches and fp32 scalars into one buffer and back.
- On the card (``cuda`` marker; skips here): the captured graph's replays
  against the eager steps, params bit for bit, and the launch counters
  after the replays equal to the eager run's.

On the CPU the K-step dispatch runs uncaptured, the same code the card
runs around its graph replays. Every case carries its own time limit.
JAX is imported inside the cases that use it, so that the ``cuda`` case
runs on a machine without JAX:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_dispatch.py -m cuda``.
"""

import dataclasses
import functools
import signal

import numpy as np
import pytest
import torch

from transformer_tpu_torch.config import ModelConfig, TrainConfig
from transformer_tpu_torch.convert import params_digest, params_from_numpy
from transformer_tpu_torch.models.transformer import flatten
from transformer_tpu_torch.train.checkpoint import CheckpointManager
from transformer_tpu_torch.train.state import create_train_state
from transformer_tpu_torch.train.trainer import (
    Trainer,
    _dispatch_groups,
    make_multistep_train_step,
    make_train_step,
    stage,
)

TINY = dict(
    num_layers=1, d_model=16, num_heads=2, dff=32, input_vocab_size=30,
    target_vocab_size=30, max_position=32, dtype="float32", dropout_rate=0.0,
)
TCFG = dict(batch_size=4, sequence_length=8, epochs=1, warmup_steps=100)
K = 4


def within(seconds: int):
    """Fail the test if it runs longer than ``seconds`` (SIGALRM)."""

    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            def expire(signum, frame):
                raise TimeoutError(f"{fn.__name__} took more than {seconds} s")

            old = signal.signal(signal.SIGALRM, expire)
            signal.alarm(seconds)
            try:
                return fn(*args, **kwargs)
            finally:
                signal.alarm(0)
                signal.signal(signal.SIGALRM, old)

        return run

    return wrap


def _stacked(k=K, b=4, s=8, seed=1):
    """(k, b, s) src and tgt batches in 1..29 with PAD tails."""
    rng = np.random.default_rng(seed)
    src = rng.integers(1, 30, size=(k, b, s)).astype(np.int32)
    tgt = rng.integers(1, 30, size=(k, b, s)).astype(np.int32)
    src[:, 1, 6:] = 0
    tgt[:, 2, 5:] = 0
    return src, tgt


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


# --------------------------------------------------------------------------
# against the JAX package


@pytest.mark.parametrize("normalization", ["tokens", "batch"])
@within(180)
def test_multistep_matches_jax(normalization):
    import jax

    from transformer_tpu.config import ModelConfig as JConfig
    from transformer_tpu.config import TrainConfig as JTrain
    from transformer_tpu.train.checkpoint import _flatten
    from transformer_tpu.train.schedule import noam_schedule as j_noam
    from transformer_tpu.train.state import create_train_state as j_create_state
    from transformer_tpu.train.trainer import make_multistep_train_step as j_multistep
    from transformer_tpu.train.trainer import make_train_step as j_make_train_step

    tkw = dict(TCFG, loss_normalization=normalization)
    jcfg, jtcfg = JConfig(**TINY), JTrain(**tkw)
    src, tgt = _stacked()
    jstate = j_create_state(jax.random.PRNGKey(0), jcfg, jtcfg)
    init = {k: np.asarray(v) for k, v in _flatten(jstate.params).items()}
    multi = jax.jit(j_multistep(j_make_train_step(jcfg, jtcfg),
                                loss_normalization=normalization, batch_size=4))
    jstate, jm = multi(jstate, src, tgt, jax.random.PRNGKey(3))
    want = {k: np.asarray(v) for k, v in _flatten(jstate.params).items()}

    cfg, tcfg = ModelConfig(**TINY), TrainConfig(**tkw)
    state = create_train_state(cfg, tcfg, params=params_from_numpy(init, cfg, device="cpu"))
    step = make_train_step(cfg, tcfg)
    state, m = make_multistep_train_step(step, normalization, 4)(state, src, tgt)

    assert state.step == int(jstate.step) == K and state.opt_state.count == K
    lr_sum = sum(float(j_noam(16, 100)(s)) for s in range(K))
    for key, got in flatten(state.params).items():
        got = got.detach().numpy()
        if key.endswith("mha/key/bias"):
            assert np.abs(got - want[key]).max() <= 2 * lr_sum, key
        else:
            np.testing.assert_allclose(got, want[key], rtol=1e-5, atol=1e-6, err_msg=key)
    for key in ("loss_sum", "weight", "correct", "loss", "grad_norm"):
        assert _rel(m[key], jm[key]) <= 1e-5, (key, float(m[key]), float(jm[key]))


# --------------------------------------------------------------------------
# against K single port steps


@pytest.mark.parametrize(
    "model_kw, train_kw",
    [
        (dict(dropout_rate=0.1), {}),
        (dict(dropout_rate=0.1, remat=True, attention_impl="flash"), {}),
        (dict(dropout_rate=0.1, remat=True, remat_policy="dots"), {}),
        (dict(dropout_rate=0.1), dict(grad_accum_steps=2, loss_normalization="batch")),
    ],
    ids=["dropout", "dropout_remat_flash", "dropout_remat_dots", "grad_accum"],
)
@within(120)
def test_multistep_equals_single_steps(model_kw, train_kw):
    cfg = ModelConfig(**{**TINY, **model_kw})
    tcfg = TrainConfig(**TCFG, **train_kw)
    src, tgt = _stacked()
    single = create_train_state(cfg, tcfg, device="cpu")
    step = make_train_step(cfg, tcfg)
    sums = {"loss_sum": 0.0, "weight": 0.0, "correct": 0.0}
    norms = []
    for i in range(K):
        single, m = step(single, src[i], tgt[i])
        for key in sums:
            sums[key] += float(m[key])
        norms.append(float(m["grad_norm"]))
    multi = create_train_state(cfg, tcfg, device="cpu")
    multi, mm = make_multistep_train_step(step, tcfg.loss_normalization, 4)(multi, src, tgt)
    assert multi.step == single.step == K
    for (key, a), b in zip(flatten(single.params).items(), flatten(multi.params).values()):
        assert torch.equal(a, b), key
    for key, mu in single.opt_state.mu.items():
        assert torch.equal(mu, multi.opt_state.mu[key]) and torch.equal(
            single.opt_state.nu[key], multi.opt_state.nu[key]), key
    for key, want in sums.items():
        assert _rel(mm[key], want) <= 1e-6, key
    assert _rel(mm["grad_norm"], np.mean(norms)) <= 1e-6


@within(30)
def test_stage_round_trips_batches_and_scalars():
    src, tgt = _stacked(k=3)
    scalars = np.asarray([[0.5, 1e-9, -3.25]] * 3, np.float32)
    got_tgt, got_src, got_scalars = stage([tgt, src], scalars, "cpu")
    assert got_tgt.dtype == torch.int32 and got_scalars.dtype == torch.float32
    assert np.array_equal(got_tgt.numpy(), tgt) and np.array_equal(got_src.numpy(), src)
    assert np.array_equal(got_scalars.numpy(), scalars)


@within(30)
def test_dispatch_groups_flush_on_shape_change_and_tail():
    a, b = np.zeros((4, 8), np.int32), np.zeros((4, 6), np.int32)
    batches = [(a, a)] * 5 + [(b, b)] * 2 + [(a, a)]
    got = [(k, tgt.shape) for _, tgt, k in _dispatch_groups(batches, 3)]
    assert got == [(3, (3, 4, 8)), (2, (2, 4, 8)), (2, (2, 4, 6)), (1, (4, 8))]


# --------------------------------------------------------------------------
# through Trainer.fit


class _VariedBatches:
    """``n`` distinct batches an epoch (keyed on (seed, epoch, i)), the
    last ``narrow`` columns wide when given."""

    def __init__(self, n=7, seed=5, narrow=0):
        self.n, self.seed, self.narrow = n, seed, narrow

    def __len__(self):
        return self.n

    def batches(self, epoch=0):
        for i in range(self.n):
            rng = np.random.default_rng([self.seed, epoch, i])
            w = self.narrow if self.narrow and i == self.n - 1 else 8
            yield (rng.integers(1, 30, size=(4, w)).astype(np.int32),
                   rng.integers(1, 30, size=(4, w)).astype(np.int32))


def _fit(spd, data, epochs=2, ckpt=None, test=None, log=None, **train_kw):
    cfg = ModelConfig(**{**TINY, "dropout_rate": 0.1})
    tcfg = TrainConfig(**{**TCFG, "epochs": epochs, "warmup_steps": 10,
                          "steps_per_dispatch": spd, "eval_every_steps": 0,
                          "log_every_steps": 0, **train_kw})
    trainer = Trainer(cfg, tcfg, create_train_state(cfg, tcfg, device="cpu"),
                      log_fn=(log.append if log is not None else lambda *_: None),
                      checkpoint=ckpt)
    trainer.fit(data, test)
    return trainer


@within(120)
def test_trainer_trajectory_parity():
    ref = _fit(1, _VariedBatches(narrow=6))
    multi = _fit(3, _VariedBatches(narrow=6))
    assert multi.state.step == ref.state.step == 14
    assert [k for k, _ in multi.dispatches] == [3, 3, 1] * 2
    assert len(multi.step_seconds) == 14 and multi.tokens == ref.tokens
    assert params_digest(multi.state.params) == params_digest(ref.state.params)
    assert _rel(multi.train_metrics.loss, ref.train_metrics.loss) <= 1e-6
    assert _rel(multi.train_metrics.accuracy, ref.train_metrics.accuracy) <= 1e-6


@within(60)
def test_log_eval_boundary_crossing():
    logs = []
    fixed = _VariedBatches(n=1, seed=0)
    batch = next(fixed.batches(0))

    class _Six:
        def __len__(self):
            return 6

        def batches(self, epoch=0):
            yield from [batch] * 6

    _fit(3, _Six(), epochs=1, test=fixed, log=logs, log_every_steps=5, eval_every_steps=5,
         eval_max_batches=1)
    # Dispatches end at steps 3 and 6: step 5 is never hit, but 3 -> 6 crosses it.
    assert any(ln.startswith("epoch 1 step 6 ") for ln in logs), logs
    assert any("eval loss" in ln for ln in logs), logs


@within(30)
def test_multistep_needs_enable_function():
    with pytest.raises(ValueError, match="enable_function"):
        _fit(2, _VariedBatches(), enable_function=False)


@within(180)
def test_resume_at_k3_equals_uninterrupted(tmp_path):
    whole = _fit(3, _VariedBatches(), ckpt=CheckpointManager(str(tmp_path / "u")))
    _fit(3, _VariedBatches(), epochs=1, ckpt=CheckpointManager(str(tmp_path / "r")))
    logs = []
    resumed = _fit(3, _VariedBatches(), ckpt=CheckpointManager(str(tmp_path / "r")), log=logs)
    assert "restored checkpoint at step 7" in logs and "resuming at epoch 2/2 (step 7)" in logs
    assert resumed.state.step == whole.state.step == 14
    assert [k for k, _ in resumed.dispatches] == [3, 3, 1]
    assert params_digest(resumed.state.params) == params_digest(whole.state.params)


# --------------------------------------------------------------------------
# on the card


@pytest.mark.cuda
@within(600)
def test_graph_replay_equals_eager_steps_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from transformer_tpu_torch.kernels import launch_counts
    from transformer_tpu_torch.train.graph import CapturedStep

    cfg = ModelConfig(num_layers=2, d_model=128, num_heads=4, dff=256, input_vocab_size=64,
                      target_vocab_size=64, max_position=64, attention_impl="flash",
                      dropout_rate=0.1, remat=True, dtype="bfloat16")
    tcfg = TrainConfig(batch_size=8, sequence_length=32, warmup_steps=4)
    rng = np.random.default_rng(0)
    src = rng.integers(1, 64, size=(6, 8, 32)).astype(np.int32)
    tgt = rng.integers(1, 64, size=(6, 8, 32)).astype(np.int32)
    tgt[:, 3, 20:] = 0

    def run(captured):
        state = create_train_state(cfg, tcfg, device="cuda")
        step = make_train_step(cfg, tcfg)
        before = launch_counts()
        if captured:
            graph = CapturedStep(step.core, tcfg.seed, torch.device("cuda"))
            multi = make_multistep_train_step(step, run=graph)
            state, m = multi(state, src[:4], tgt[:4])
            state, m = multi(state, src[4:], tgt[4:])
            assert len(graph.captures) == 1
        else:
            for i in range(6):
                state, m = step(state, src[i], tgt[i])
        torch.cuda.synchronize()
        after = launch_counts()
        return state, {k: after[k] - before[k] for k in after}

    eager, eager_launches = run(False)
    replayed, replay_launches = run(True)
    assert replay_launches == eager_launches and eager_launches["flash_fwd"] > 0
    for (key, a), b in zip(flatten(eager.params).items(), flatten(replayed.params).values()):
        assert torch.equal(a, b), key
