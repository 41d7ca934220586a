"""Length buckets, ``exclude_test_overlap`` and the "dots" remat policy:
the port against the JAX package.

- ``Seq2SeqDataset`` with ``length_buckets`` yields the JAX twin's
  batches (``np.array_equal``: widths, rows and order) for epochs 0-2,
  shuffled or not, with and without ``drop_remainder``; both refuse an
  example longer than the largest bucket, and a bucket wider than the
  dataset, with the same message.
- ``load_dataset(length_buckets=...)`` on corpus lines equals JAX's;
  ``exclude_test_overlap`` keeps the same train pairs as JAX's, in order.
- ``remat_policy="dots"``: the LM's first-step gradients (2 layers, d 64,
  flash, fp32, converted JAX weights) equal the port's "full" remat bit
  for bit, and JAX's "dots" within ``tests/test_torch_train.py``'s limits
  (1e-4 of ||Δ||/||want|| per leaf; the key biases, zero up to rounding,
  below 1e-7 on both sides).
- What "dots" recomputes: a ``TorchDispatchMode`` counting the products
  the backward runs (xla attention, whose scores are batched products)
  sees no more ``mm``/``addmm`` than without remat (none recomputed),
  and more ``bmm`` over a batch above 1 (attention's, recomputed); "full"
  re-runs the ``mm``s too.
- ``cli.train --device=cpu --length_buckets 16,32,48,64
  --steps_per_dispatch 2`` trains a tiny translator an epoch; with
  ``--decoder_only`` the flag raises.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from test_torch_dispatch import within
from transformer_tpu.config import ModelConfig as JConfig
from transformer_tpu.config import TrainConfig as JTrain
from transformer_tpu.data.pipeline import Seq2SeqDataset as JDataset
from transformer_tpu.data.pipeline import load_dataset as j_load_dataset
from transformer_tpu.models import transformer_apply as j_transformer_apply
from transformer_tpu.train.checkpoint import _flatten
from transformer_tpu.train.loss import masked_cross_entropy as j_masked_ce
from transformer_tpu.train.state import create_train_state as j_create_state
from transformer_tpu_torch.config import ModelConfig
from transformer_tpu_torch.convert import params_from_numpy
from transformer_tpu_torch.data.pipeline import Seq2SeqDataset, load_dataset
from transformer_tpu_torch.models.transformer import (
    flatten,
    init_params,
    transformer_apply,
    unflatten,
)
from transformer_tpu_torch.train.loss import masked_cross_entropy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _examples(n=53, seed=0, longest=16):
    """``n`` pairs of a random length in 2..longest, the target one shorter
    or as long."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, longest + 1, size=n)
    src = [rng.integers(1, 90, size=n_).astype(np.int32) for n_ in lengths]
    tgt = [rng.integers(1, 90, size=n_ - rng.integers(0, 2)).astype(np.int32) for n_ in lengths]
    return src, tgt


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_remainder", [True, False])
@within(60)
def test_bucketed_batches_equal_jax(shuffle, drop_remainder):
    src, tgt = _examples()
    kw = dict(batch_size=4, src_len=16, tgt_len=16, shuffle=shuffle, seed=3,
              drop_remainder=drop_remainder, length_buckets=(12, 4, 8, 16))
    got_ds, want_ds = Seq2SeqDataset(src, tgt, **kw), JDataset(src, tgt, **kw)
    assert len(got_ds) == len(want_ds) > 0
    widths = set()
    for epoch in (0, 1, 2):
        got, want = list(got_ds.batches(epoch)), list(want_ds.batches(epoch))
        assert len(got) == len(want) == len(got_ds)
        for (gs, gt), (ws, wt) in zip(got, want):
            assert np.array_equal(gs, ws) and np.array_equal(gt, wt)
            assert gs.dtype == ws.dtype == np.int32
            widths.add(gs.shape[1])
    assert widths == {4, 8, 12, 16}


@within(30)
def test_bucket_errors_match_jax():
    src, tgt = _examples(longest=16)
    for kw, match in (
        (dict(src_len=16, tgt_len=16, length_buckets=(4, 8, 12)), "exceed the largest length bucket"),
        (dict(src_len=16, tgt_len=16, length_buckets=(8, 20)), "exceeds the dataset width"),
    ):
        for cls in (Seq2SeqDataset, JDataset):
            with pytest.raises(ValueError, match=match):
                cls(src, tgt, batch_size=4, **kw)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The first 200 train pairs, the first 60 test pairs appended to them
    (an in-sample test split, as the bundled one is), and those 60."""
    tmp = tmp_path_factory.mktemp("buckets")
    for side in ("src", "tgt"):
        with open(os.path.join(ROOT, "data", f"{side}-train.txt"), encoding="utf-8") as f:
            train = [next(f) for _ in range(200)]
        with open(os.path.join(ROOT, "data", f"{side}-test.txt"), encoding="utf-8") as f:
            test = [next(f) for _ in range(60)]
        (tmp / f"{side}-train.txt").write_text("".join(train + test), encoding="utf-8")
        (tmp / f"{side}-test.txt").write_text("".join(test), encoding="utf-8")
    return tmp


@pytest.mark.parametrize("exclude", [False, True], ids=["all_pairs", "exclude_test_overlap"])
@within(120)
def test_load_dataset_buckets_and_overlap_equal_jax(corpus, exclude):
    vocab = [str(corpus / f"{side}.subwords") for side in ("src", "tgt")]
    kw = dict(batch_size=8, sequence_length=64, target_vocab_size=400, seed=2,
              length_buckets=(16, 32, 48, 64), exclude_test_overlap=exclude)
    got = load_dataset(str(corpus), *vocab, **kw)[0]
    want = j_load_dataset(str(corpus), *vocab, **kw)[0]
    assert got.num_examples == want.num_examples > 0
    for a, b in zip(got.src + got.tgt, want.src + want.tgt):
        assert np.array_equal(a, b)
    for epoch in (0, 1):
        pairs = list(zip(got.batches(epoch), want.batches(epoch)))
        assert len(pairs) == len(got) == len(want) > 0
        for (gs, gt), (ws, wt) in pairs:
            assert np.array_equal(gs, ws) and np.array_equal(gt, wt)
    if exclude:
        whole = load_dataset(str(corpus), *vocab, **{**kw, "exclude_test_overlap": False})[0]
        assert got.num_examples < whole.num_examples


# --------------------------------------------------------------------------
# the "dots" remat policy


VOCAB = 96
LM = dict(
    num_layers=2, d_model=64, num_heads=4, dff=128, input_vocab_size=VOCAB,
    target_vocab_size=VOCAB, max_position=64, decoder_only=True,
    attention_impl="flash", dropout_rate=0.0, dtype="float32", remat=True,
)


def _lm_batch(seed=5, b=2, s=64):
    rng = np.random.default_rng(seed)
    tgt = rng.integers(1, VOCAB, size=(b, s)).astype(np.int32)
    tgt[1, s - 9:] = 0
    return tgt


def _port_grads(model_kw, init, tgt):
    cfg = ModelConfig(**model_kw)
    leaves = flatten(params_from_numpy(init, cfg, device="cpu"))
    for p in leaves.values():
        p.requires_grad_(True)
    params = unflatten(leaves)
    t = torch.from_numpy(tgt).long()
    logits = transformer_apply(params, None, t[:, :-1], cfg)
    loss, _ = masked_cross_entropy(logits, t[:, 1:])
    return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


@within(180)
def test_dots_gradients_equal_full_and_jax():
    jcfg = JConfig(**{**LM, "remat_policy": "dots"})
    state = j_create_state(jax.random.PRNGKey(0), jcfg, JTrain(batch_size=2, sequence_length=64))
    init = {k: np.asarray(v) for k, v in _flatten(state.params).items()}
    tgt = _lm_batch()

    def j_loss(p):
        logits, _ = j_transformer_apply(p, None, jnp.asarray(tgt[:, :-1]), jcfg)
        return j_masked_ce(logits, jnp.asarray(tgt[:, 1:]))[0]

    want = {k: np.asarray(v) for k, v in _flatten(jax.grad(j_loss)(state.params)).items()}
    dots = _port_grads({**LM, "remat_policy": "dots"}, init, tgt)
    full = _port_grads({**LM, "remat_policy": "full"}, init, tgt)
    for key, g in dots.items():
        assert torch.equal(g, full[key]), key
        got = g.numpy()
        if key.endswith("self_mha/key/bias"):  # zero up to rounding on both sides
            assert np.abs(got).max() <= 1e-7 and np.abs(want[key]).max() <= 1e-7, key
        else:
            rel = np.linalg.norm(got - want[key]) / max(np.linalg.norm(want[key]), 1e-30)
            assert rel <= 1e-4, (key, rel)


class _Products(TorchDispatchMode):
    """Counts the matrix products that run: ``mm``/``addmm``, and ``bmm``
    over a batch above 1."""

    def __init__(self):
        super().__init__()
        self.counts = {"mm": 0, "batched": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.counts["mm"] += 1
        elif func is torch.ops.aten.bmm.default and args[0].shape[0] > 1:
            self.counts["batched"] += 1
        return func(*args, **(kwargs or {}))


@within(60)
def test_dots_recomputes_batched_products_but_no_dense_ones():
    rng = np.random.default_rng(0)
    backward = {}
    for policy, remat in (("none", False), ("full", True), ("dots", True)):
        cfg = ModelConfig(**{**LM, "attention_impl": "xla", "remat": remat,
                             "remat_policy": "full" if policy == "none" else policy})
        params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        leaves = flatten(params)
        for p in leaves.values():
            p.requires_grad_(True)
        t = torch.from_numpy(rng.integers(1, VOCAB, size=(2, 33))).long()
        loss, _ = masked_cross_entropy(transformer_apply(params, None, t[:, :-1], cfg), t[:, 1:])
        with _Products() as mode:
            torch.autograd.grad(loss, list(leaves.values()))
        backward[policy] = mode.counts
    none, full, dots = backward["none"], backward["full"], backward["dots"]
    assert dots["mm"] == none["mm"] < full["mm"], backward  # no dense product re-runs
    assert dots["batched"] == full["batched"] > none["batched"], backward  # attention's do


# --------------------------------------------------------------------------
# the CLI


@within(300)
def test_cli_trains_with_buckets_and_dispatch(corpus, tmp_path):
    from transformer_tpu_torch.cli import train

    flags = [
        "--device=cpu", f"--dataset_path={corpus}",
        f"--src_vocab_file={tmp_path / 's.subwords'}",
        f"--tgt_vocab_file={tmp_path / 't.subwords'}", "--target_vocab_size=2000",
        "--num_layers=1", "--d_model=32", "--dff=64", "--num_heads=4",
        "--sequence_length=64", "--batch_size=8", "--epochs=1", "--eval_bleu=false",
        f"--ckpt_path={tmp_path / 'ckpt'}", f"--export_path={tmp_path / 'export'}",
    ]
    logs = []
    trainer = train.main(flags + ["--length_buckets=16,32,48,64", "--steps_per_dispatch=2"],
                         log_fn=logs.append)
    assert trainer.state.step == sum(k for k, _ in trainer.dispatches) > 0
    assert np.isfinite(trainer.train_metrics.loss) and trainer.graph is None  # CPU: uncaptured
    assert any(ln.startswith("epoch 1/1 done") for ln in logs), logs
    with pytest.raises(ValueError, match="seq2seq pipeline only"):
        train.main(flags + ["--decoder_only", "--length_buckets=16,64"], log_fn=logs.append)
