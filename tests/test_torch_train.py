"""Training slice: the port against the JAX package on the same inputs.

- ``masked_cross_entropy`` against JAX's (label smoothing 0 and 0.1, both
  normalisations, PAD targets): loss and sums within 1e-6 relative.
- The three schedules at steps 0-20: within 1e-7 relative (both fp32).
- One Adam update, with and without clipping, against optax on the same
  grads: within 1e-6 relative plus 1e-12 absolute.
- Train steps against JAX ``make_train_step`` from converted JAX params
  (2 layers, d 64, 4 heads, dff 128, S 64, flash attention, dropout 0,
  warmup 4): fp32 loss per step within 1e-5 relative, first-step
  gradients within 1e-4 of ||Δ||/||want|| per leaf (the key biases'
  below 1e-7 on both sides, see below), params after three
  steps in units of the summed learning rate: within 1e-5 of it on average
  per element and 1e-2 at worst, except the key biases; every element of
  every leaf within 2x it. (Adam moves an element by about lr·sign(g)
  whatever |g|, so a gradient that rounding flips across zero moves it by
  up to 2·lr. The key bias adds the same q·b to every score of a row,
  which the softmax cancels: its gradient is zero up to rounding, all of
  it such noise.) Remat on and off. bf16: loss per step within 1e-2
  relative.
- ``mha_apply`` (cache-free, causal, padding mask) against JAX's, xla and
  flash, with and without rope, a window of 8 on flash: fp32 within 1e-5.
- Dropout under remat: dropout 0.1, the same seed, remat on and off give
  bit-identical gradients (each site's generator is keyed, so the
  recompute draws the forward's masks).
- LM batches equal JAX ``make_lm_dataset``'s (np.array_equal) for epochs
  0 and 1, shuffled and not, with and without ``drop_remainder``.
- ``cli.train --device=cpu`` trains one epoch on 200 corpus lines and
  writes an export that ``convert.load_export`` and ``cli.serve`` read.
"""

import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_tpu.config import ModelConfig as JConfig
from transformer_tpu.config import TrainConfig as JTrain
from transformer_tpu.data.pipeline import make_lm_dataset as j_make_lm_dataset
from transformer_tpu.data.tokenizer import SubwordTokenizer as JTokenizer
from transformer_tpu.models import transformer_apply as j_transformer_apply
from transformer_tpu.train.checkpoint import _flatten
from transformer_tpu.train.loss import masked_cross_entropy as j_masked_ce
from transformer_tpu.train.schedule import (
    constant_schedule as j_constant,
    cosine_schedule as j_cosine,
    noam_schedule as j_noam,
)
from transformer_tpu.train.state import create_train_state as j_create_state
from transformer_tpu.train.state import make_optimizer as j_make_optimizer
from transformer_tpu.train.trainer import make_train_step as j_make_train_step
from transformer_tpu_torch.config import ModelConfig, TrainConfig
from transformer_tpu_torch.convert import load_export, params_from_numpy
from transformer_tpu_torch.data.pipeline import make_lm_dataset
from transformer_tpu_torch.data.tokenizer import SubwordTokenizer
from transformer_tpu_torch.models.transformer import flatten, transformer_apply, unflatten
from transformer_tpu_torch.train.loss import masked_cross_entropy
from transformer_tpu_torch.train.schedule import (
    constant_schedule,
    cosine_schedule,
    noam_schedule,
)
from transformer_tpu_torch.train.state import create_train_state, make_optimizer
from transformer_tpu_torch.train.trainer import make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 96
MODEL = dict(
    num_layers=2, d_model=64, num_heads=4, dff=128, input_vocab_size=VOCAB,
    target_vocab_size=VOCAB, max_position=64, decoder_only=True,
    attention_impl="flash", dropout_rate=0.0, dtype="float32",
)
TRAIN = dict(batch_size=2, sequence_length=64, warmup_steps=4)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _batches(n, seed=0, b=2, s=64):
    """LM windows with PAD tails in the second row."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tgt = rng.integers(1, VOCAB, size=(b, s)).astype(np.int32)
        tgt[1, s - 9:] = 0
        out.append(tgt)
    return out


# --------------------------------------------------------------------------
# loss, schedules, optimizer


@pytest.mark.parametrize("normalization", ["tokens", "batch"])
@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
def test_masked_cross_entropy_matches_jax(label_smoothing, normalization):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 3).astype(np.float32)
    targets = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    targets[2, 4:] = 0  # PAD
    kw = dict(label_smoothing=label_smoothing, normalization=normalization, batch_size=3)
    want_loss, want = j_masked_ce(jnp.asarray(logits), jnp.asarray(targets), **kw)
    loss, got = masked_cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets), **kw)
    assert _rel(float(loss), float(want_loss)) <= 1e-6
    for key in ("loss_sum", "weight", "correct"):
        assert _rel(float(got[key]), float(want[key])) <= 1e-6, key


@pytest.mark.parametrize("name", ["noam", "cosine", "constant"])
def test_schedules_match_jax(name):
    port, ref = {
        "noam": (noam_schedule(64, 8), j_noam(64, 8)),
        "cosine": (cosine_schedule(1e-3, 5, 15), j_cosine(1e-3, 5, 15)),
        "constant": (constant_schedule(2e-3, 6), j_constant(2e-3, 6)),
    }[name]
    for step in range(21):
        assert _rel(port(step), float(ref(step))) <= 1e-7, step


@pytest.mark.parametrize("max_grad_norm", [0.0, 0.5])
def test_adam_update_matches_optax(max_grad_norm):
    cfg = ModelConfig(**MODEL)
    tcfg = TrainConfig(**TRAIN, max_grad_norm=max_grad_norm)
    jtx = j_make_optimizer(JConfig(**MODEL), JTrain(**TRAIN, max_grad_norm=max_grad_norm))
    tx = make_optimizer(cfg, tcfg)
    rng = np.random.default_rng(1)
    params = {"a": rng.standard_normal((4, 5)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32)}
    jstate = jtx.init({k: jnp.asarray(v) for k, v in params.items()})
    state = tx.init({k: torch.from_numpy(v) for k, v in params.items()})
    for step in range(3):  # the third update reads moments and count of the first two
        grads = {k: (rng.standard_normal(v.shape) * 10 ** (step - 1)).astype(np.float32)
                 for k, v in params.items()}
        grads["b"][0] = 1e-12  # an update of about lr·sign(g)
        jup, jstate = jtx.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate)
        up, state = tx.update({k: torch.from_numpy(v) for k, v in grads.items()}, state)
        for k in params:
            np.testing.assert_allclose(up[k].numpy(), np.asarray(jup[k]), rtol=1e-6, atol=1e-12)


# --------------------------------------------------------------------------
# attention and train steps against JAX


@pytest.mark.parametrize(
    "impl, rope, window",
    [("xla", False, 0), ("xla", True, 0), ("flash", False, 0), ("flash", True, 8)],
)
def test_mha_apply_matches_jax(impl, rope, window):
    from transformer_tpu.ops.attention import mha_apply as j_mha_apply
    from transformer_tpu_torch.ops.attention import mha_apply
    from transformer_tpu_torch.ops.masks import make_padding_mask

    rng = np.random.default_rng(4)
    d, h, hd = 32, 4, 8
    params = {name: {"kernel": (rng.standard_normal((d, h, hd)) * 0.2).astype(np.float32),
                     "bias": (rng.standard_normal((h, hd)) * 0.1).astype(np.float32)}
              for name in ("query", "key", "value")}
    params["out"] = {"kernel": (rng.standard_normal((h, hd, d)) * 0.2).astype(np.float32),
                     "bias": (rng.standard_normal((d,)) * 0.1).astype(np.float32)}
    x = rng.standard_normal((2, 24, d)).astype(np.float32)
    ids = np.ones((2, 24), np.int32)
    ids[1, 19:] = 0
    kw = dict(impl=impl, causal=True, window=window, rope=rope)
    jmask = (jnp.asarray(ids) != 0)[:, None, None, :]
    want, _, _ = j_mha_apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                             jnp.asarray(x), jmask, **kw)
    tparams = {k: {n: torch.from_numpy(a) for n, a in v.items()} for k, v in params.items()}
    got = mha_apply(tparams, torch.from_numpy(x), torch.from_numpy(x),
                    make_padding_mask(torch.from_numpy(ids)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)



def _jax_run(model_kw, train_kw, batches):
    jcfg, jtcfg = JConfig(**model_kw), JTrain(**train_kw)
    state = j_create_state(jax.random.PRNGKey(0), jcfg, jtcfg)
    init = _flatten(state.params)
    step = jax.jit(j_make_train_step(jcfg, jtcfg))
    rng = jax.random.PRNGKey(0)
    losses, norms = [], []
    for tgt in batches:
        state, m = step(state, jnp.asarray(tgt), jnp.asarray(tgt), rng)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return init, losses, norms, _flatten(state.params)


def _port_run(model_kw, train_kw, init, batches):
    cfg, tcfg = ModelConfig(**model_kw), TrainConfig(**train_kw)
    params = params_from_numpy(init, cfg, device="cpu")
    state = create_train_state(cfg, tcfg, params=params)
    step = make_train_step(cfg, tcfg)
    losses, norms = [], []
    for tgt in batches:
        state, m = step(state, tgt, tgt)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, {k: v.detach().numpy() for k, v in flatten(state.params).items()}


@pytest.fixture(scope="module")
def jax_fp32_run():
    return _jax_run(MODEL, TRAIN, _batches(3))


@pytest.mark.parametrize("remat", [False, True], ids=["remat_off", "remat_on"])
def test_train_steps_match_jax(jax_fp32_run, remat):
    init, want_losses, want_norms, want_params = jax_fp32_run
    losses, norms, params = _port_run({**MODEL, "remat": remat}, TRAIN, init, _batches(3))
    for got, want in zip(losses, want_losses):
        assert _rel(got, want) <= 1e-5, (losses, want_losses)
    for got, want in zip(norms, want_norms):
        assert _rel(got, want) <= 1e-4, (norms, want_norms)
    sched = j_noam(MODEL["d_model"], TRAIN["warmup_steps"])
    lr_sum = sum(float(sched(s)) for s in range(3))
    for key, want in want_params.items():
        diff = np.abs(params[key] - np.asarray(want)) / lr_sum
        assert diff.max() <= 2.0, key
        if not key.endswith("self_mha/key/bias"):
            assert diff.mean() <= 1e-5 and diff.max() <= 1e-2, (key, diff.mean(), diff.max())


def test_first_step_gradients_match_jax(jax_fp32_run):
    init = jax_fp32_run[0]
    tgt = _batches(1, seed=5)[0]
    jcfg, cfg = JConfig(**MODEL), ModelConfig(**MODEL)

    def j_loss(p):
        logits, _ = j_transformer_apply(p, None, jnp.asarray(tgt[:, :-1]), jcfg)
        return j_masked_ce(logits, jnp.asarray(tgt[:, 1:]))[0]

    jparams = jax.tree.map(jnp.asarray, unflatten(init))  # the same tree in both packages
    want = _flatten(jax.grad(j_loss)(jparams))
    params = params_from_numpy(init, cfg, device="cpu")
    leaves = flatten(params)
    for p in leaves.values():
        p.requires_grad_(True)
    logits = transformer_apply(params, None, torch.from_numpy(tgt[:, :-1]).long(), cfg)
    loss, _ = masked_cross_entropy(logits, torch.from_numpy(tgt[:, 1:]))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for key, g in zip(leaves, grads):
        if key.endswith("self_mha/key/bias"):  # zero up to rounding on both sides
            assert np.abs(g.numpy()).max() <= 1e-7 and np.abs(want[key]).max() <= 1e-7
        else:
            assert _rel(g.numpy(), want[key]) <= 1e-4, (key, _rel(g.numpy(), want[key]))


def test_bf16_train_steps_match_jax():
    model = {**MODEL, "dtype": "bfloat16", "remat": True}
    init, want_losses, _, _ = _jax_run(model, TRAIN, _batches(2, seed=2))
    losses, _, _ = _port_run(model, TRAIN, init, _batches(2, seed=2))
    for got, want in zip(losses, want_losses):
        assert _rel(got, want) <= 1e-2, (losses, want_losses)


def test_dropout_under_remat_gives_identical_gradients():
    model = {**MODEL, "dropout_rate": 0.1}
    tgt = torch.from_numpy(_batches(1, seed=3)[0]).long()
    grads = []
    for remat in (False, True):
        cfg = ModelConfig(**model, remat=remat)
        jstate = j_create_state(jax.random.PRNGKey(0), JConfig(**MODEL), JTrain(**TRAIN))
        params = params_from_numpy(_flatten(jstate.params), cfg, device="cpu")
        leaves = flatten(params)
        for p in leaves.values():
            p.requires_grad_(True)
        logits = transformer_apply(params, None, tgt[:, :-1], cfg, key=(0, 7),
                                   deterministic=False)
        loss, _ = masked_cross_entropy(logits, tgt[:, 1:])
        grads.append(torch.autograd.grad(loss, list(leaves.values())))
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    # ...and dropout did act: the deterministic forward differs.
    cfg = ModelConfig(**model)
    with torch.no_grad():
        det = transformer_apply(params, None, tgt[:, :-1], cfg)
        drop = transformer_apply(params, None, tgt[:, :-1], cfg, key=(0, 7), deterministic=False)
    assert not torch.equal(det, drop)


# --------------------------------------------------------------------------
# data and CLI


@pytest.fixture(scope="module")
def corpus_and_vocab(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm")
    with open(os.path.join(ROOT, "data", "tgt-train.txt"), encoding="utf-8") as f:
        lines = [next(f).rstrip("\n") for _ in range(300)]
    path = str(tmp / "vocab.subwords")
    SubwordTokenizer.build_from_corpus(lines, target_vocab_size=600).save(path)
    return lines, path


@pytest.mark.parametrize("shuffle, drop_remainder", [(True, True), (False, False), (True, False)])
def test_lm_batches_equal_jax(corpus_and_vocab, shuffle, drop_remainder):
    lines, vocab = corpus_and_vocab
    kw = dict(batch_size=3, sequence_length=32, seed=5, shuffle=shuffle,
              drop_remainder=drop_remainder)
    got_ds = make_lm_dataset(lines, SubwordTokenizer.load(vocab), **kw)
    want_ds = j_make_lm_dataset(lines, JTokenizer.load(vocab), **kw)
    assert len(got_ds) == len(want_ds)
    for epoch in (0, 1):
        got, want = list(got_ds.batches(epoch)), list(want_ds.batches(epoch))
        assert len(got) == len(want) > 0
        for (gs, gt), (ws, wt) in zip(got, want):
            assert np.array_equal(gs, ws) and np.array_equal(gt, wt)
            assert gt.dtype == wt.dtype


def test_cli_train_exports_a_servable_model(tmp_path):
    from transformer_tpu_torch.cli import serve, train

    for split, n in (("train", 200), ("test", 60)):
        for side in ("src", "tgt"):
            with open(os.path.join(ROOT, "data", f"{side}-{split}.txt"), encoding="utf-8") as f:
                head = [next(f) for _ in range(n)]
            (tmp_path / f"{side}-{split}.txt").write_text("".join(head), encoding="utf-8")
    export, vocab = str(tmp_path / "export"), str(tmp_path / "v.subwords")
    logs = []
    trainer = train.main([
        "--device=cpu", "--decoder_only", "--dataset_path", str(tmp_path),
        "--tgt_vocab_file", vocab, "--target_vocab_size", "400", "--num_layers", "1",
        "--d_model", "32", "--dff", "64", "--num_heads", "4", "--sequence_length", "64",
        "--batch_size", "8", "--epochs", "1", "--attention_impl", "flash", "--remat",
        "--export_path", export, "--ckpt_path", str(tmp_path / "ckpt"),
    ], log_fn=logs.append)
    assert trainer.state.step == len(trainer.step_seconds) > 0
    assert any(line.startswith("eval loss") for line in logs), logs
    params, cfg = load_export(export, device="cpu")
    assert cfg.decoder_only and cfg.attention_impl == "flash" and cfg.max_position == 64
    out = io.StringIO()
    serve.main(["--export_path", export, "--tgt_vocab_file", vocab, "--serve_slots", "2",
                "--prefix_block", "4", "--max_len", "4", "--kv_layout", "paged",
                "--decode_kernel", "paged_flash", "--device=cpu"],
               stdin=io.StringIO('{"prompt": "the house"}\n'), stdout=out)
    answer = json.loads(out.getvalue())
    assert "continuation" in answer, answer
