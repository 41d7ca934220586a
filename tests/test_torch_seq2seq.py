"""Seq2seq slice: the port's encoder-decoder model against the JAX package.

Weights come from a JAX init through ``convert.params_from_numpy``; the
same inputs go through both packages (JAX's flash attention in Pallas
interpret mode, as its own tests run it on the CPU).

- Parameter layout: for untied, tied and pre-LN seq2seq configs the port's
  ``param_spec`` keys and shapes equal JAX ``_flatten``'s, and numpy ->
  port -> numpy is byte-identical. A JAX export loads byte-identically in
  the port; the port's export loads in the JAX ``cli/translate.py``
  ``load_export``, byte-identically.
- Forward: ``encoder_apply`` and the seq2seq ``transformer_apply`` (2
  layers, d 64, 4 heads, dff 128, S 32, padded source and target rows, one
  source row all PAD) against JAX's in fp32: max |got - want| within 1e-5,
  xla and flash, post-LN and pre-LN, tied and untied. Cross-attention with
  GQA (``num_kv_heads=2``, S_q != S_k, ``precomputed_kv``) within 1e-5.
- Train steps: three steps against JAX ``make_train_step`` from a
  converted init, label smoothing 0.1, dropout 0, at the LM test's batch
  shape (B 2, S 64), with the limits of ``tests/test_torch_train.py``:
  loss per step within 1e-5 relative, grad norm within 1e-4 relative;
  params after three steps in units of the summed learning rate within
  1e-5 on average per element and 1e-2 at worst, except the attention key biases (zero gradient up to rounding:
  the softmax cancels a bias a row's keys share); every element of every
  leaf within 2x. xla, flash and the tied config; in the tied config the
  encoder and decoder tables start equal and drift apart, in both
  packages, each within the limits of its JAX twin. (The per-element
  mean reads Adam's amplification of rounding: at B 3, S 32 it ran from
  2e-6 to 1.4e-5 with the batch seed, JAX's own flash and xla paths
  apart by as much, while at B 2, S 64 eight runs read at most 6.7e-6.)
- Dropout under remat: dropout 0.1, remat on and off give bit-identical
  gradients (every site's generator is keyed, the encoder's apart from
  the decoder's).
- Batches: ``load_dataset``'s train batches (epochs 0 and 1) and test
  batches are ``np.array_equal`` to JAX's on 200 corpus lines.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_tpu.cli.translate import load_export as j_load_export
from transformer_tpu.config import ModelConfig as JConfig
from transformer_tpu.config import TrainConfig as JTrain
from transformer_tpu.data.pipeline import load_dataset as j_load_dataset
from transformer_tpu.models import transformer_apply as j_transformer_apply
from transformer_tpu.models import transformer_init
from transformer_tpu.models.encoder import encoder_apply as j_encoder_apply
from transformer_tpu.ops.masks import make_padding_mask as j_padding_mask
from transformer_tpu.train.checkpoint import _flatten, export_params as j_export_params
from transformer_tpu.train.schedule import noam_schedule as j_noam
from transformer_tpu.train.state import create_train_state as j_create_state
from transformer_tpu.train.trainer import make_train_step as j_make_train_step
from transformer_tpu_torch.config import ModelConfig, TrainConfig
from transformer_tpu_torch.convert import export_params, load_export, params_from_numpy
from transformer_tpu_torch.convert import params_to_numpy
from transformer_tpu_torch.data.pipeline import load_dataset
from transformer_tpu_torch.models.encoder import encoder_apply
from transformer_tpu_torch.models.transformer import (
    flatten,
    param_spec,
    transformer_apply,
)
from transformer_tpu_torch.ops.masks import make_padding_mask
from transformer_tpu_torch.train.loss import masked_cross_entropy
from transformer_tpu_torch.train.state import create_train_state
from transformer_tpu_torch.train.trainer import make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_VOCAB, TGT_VOCAB, S = 50, 60, 32
MODEL = dict(
    num_layers=2, d_model=64, num_heads=4, dff=128, input_vocab_size=SRC_VOCAB,
    target_vocab_size=TGT_VOCAB, max_position=64, dropout_rate=0.0, dtype="float32",
)
TIED = dict(input_vocab_size=TGT_VOCAB, tie_embeddings=True, tie_output=True)
VARIANTS = {"untied": {}, "tied": TIED, "pre": dict(norm_scheme="pre")}
TRAIN = dict(batch_size=2, sequence_length=64, warmup_steps=4, label_smoothing=0.1)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _jax_init(model_kw, seed=0):
    return _flatten(transformer_init(jax.random.PRNGKey(seed), JConfig(**model_kw)))


def _pairs(seed=0, b=3, s=S, src_vocab=SRC_VOCAB, tgt_vocab=TGT_VOCAB, empty_row=False):
    """Random (src, tgt) id batches, each row padded after its own length;
    with ``empty_row`` the last source row is all PAD."""
    rng = np.random.default_rng(seed)
    src = rng.integers(1, src_vocab, size=(b, s)).astype(np.int32)
    tgt = rng.integers(1, tgt_vocab, size=(b, s)).astype(np.int32)
    for row in range(b):
        src[row, s - 3 * row - 1:] = 0
        tgt[row, s - 5 * row - 2:] = 0
    if empty_row:
        src[-1] = 0
    return src, tgt


def _port_params(flat, model_kw):
    return params_from_numpy(flat, ModelConfig(**model_kw), device="cpu")


# --------------------------------------------------------------------------
# parameter layout and exports


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_param_layout_matches_jax(variant):
    kw = {**MODEL, **VARIANTS[variant]}
    flat = _jax_init(kw)
    spec = param_spec(ModelConfig(**kw))
    assert {k: v[0] for k, v in spec.items()} == {k: v.shape for k, v in flat.items()}
    back = params_to_numpy(_port_params(flat, kw))
    assert back.keys() == flat.keys()
    for key, arr in flat.items():
        assert back[key].dtype == arr.dtype and back[key].tobytes() == arr.tobytes(), key


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_exports_load_both_ways(tmp_path, variant):
    kw = {**MODEL, **VARIANTS[variant]}
    jcfg = JConfig(**kw)
    jparams = transformer_init(jax.random.PRNGKey(3), jcfg)
    want = _flatten(jparams)
    j_export_params(jparams, jcfg, str(tmp_path / "jax"))
    params, cfg = load_export(str(tmp_path / "jax"), device="cpu")
    assert cfg == ModelConfig(**kw)
    got = params_to_numpy(params)
    assert all(got[k].tobytes() == want[k].tobytes() for k in want)
    # The port's export, read by the JAX package's loader.
    export_params(params, cfg, str(tmp_path / "port"))
    back, back_cfg = j_load_export(str(tmp_path / "port"))
    assert back_cfg == jcfg
    back = _flatten(back)
    assert back.keys() == want.keys()
    assert all(back[k].tobytes() == want[k].tobytes() for k in want)


# --------------------------------------------------------------------------
# forward


@pytest.mark.parametrize("norm", ["post", "pre"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_encoder_apply_matches_jax(impl, norm):
    kw = {**MODEL, "attention_impl": impl, "norm_scheme": norm}
    flat = _jax_init(kw)
    src, _ = _pairs(seed=1, empty_row=True)
    jparams = jax.tree.map(jnp.asarray, flat)
    from transformer_tpu_torch.models.transformer import unflatten

    jparams = unflatten(jparams)
    jsrc = jnp.asarray(src)
    want, _ = j_encoder_apply(jparams["encoder"], jsrc, j_padding_mask(jsrc), JConfig(**kw))
    tsrc = torch.from_numpy(src).long()
    got = encoder_apply(_port_params(flat, kw)["encoder"], tsrc, make_padding_mask(tsrc),
                        ModelConfig(**kw))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5


@pytest.mark.parametrize("variant", ["untied", "tied"])
@pytest.mark.parametrize("norm", ["post", "pre"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_seq2seq_forward_matches_jax(impl, norm, variant):
    kw = {**MODEL, **VARIANTS[variant], "attention_impl": impl, "norm_scheme": norm}
    flat = _jax_init(kw, seed=1)
    src, tgt = _pairs(seed=2, src_vocab=kw["input_vocab_size"], empty_row=True)
    from transformer_tpu_torch.models.transformer import unflatten

    jparams = unflatten(jax.tree.map(jnp.asarray, flat))
    want, _ = j_transformer_apply(jparams, jnp.asarray(src), jnp.asarray(tgt), JConfig(**kw))
    got = transformer_apply(_port_params(flat, kw), torch.from_numpy(src).long(),
                            torch.from_numpy(tgt).long(), ModelConfig(**kw))
    assert got.shape == (3, S, TGT_VOCAB)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5


def test_cross_attention_gqa_matches_jax():
    from transformer_tpu.ops.attention import mha_apply as j_mha_apply
    from transformer_tpu.ops.attention import project_kv as j_project_kv
    from transformer_tpu_torch.ops.attention import mha_apply, project_kv

    rng = np.random.default_rng(4)
    d, h, h_kv, hd = 32, 4, 2, 8
    params = {name: {"kernel": (rng.standard_normal((d, n, hd)) * 0.2).astype(np.float32),
                     "bias": (rng.standard_normal((n, hd)) * 0.1).astype(np.float32)}
              for name, n in (("query", h), ("key", h_kv), ("value", h_kv))}
    params["out"] = {"kernel": (rng.standard_normal((h, hd, d)) * 0.2).astype(np.float32),
                     "bias": (rng.standard_normal((d,)) * 0.1).astype(np.float32)}
    x_q = rng.standard_normal((2, 5, d)).astype(np.float32)
    x_kv = rng.standard_normal((2, 17, d)).astype(np.float32)
    ids = np.ones((2, 17), np.int32)
    ids[1, 11:] = 0
    jp = jax.tree.map(jnp.asarray, params)
    tp = {k: {n: torch.from_numpy(a) for n, a in v.items()} for k, v in params.items()}
    jmask = (jnp.asarray(ids) != 0)[:, None, None, :]
    tmask = make_padding_mask(torch.from_numpy(ids))
    want, _, _ = j_mha_apply(jp, jnp.asarray(x_q), jnp.asarray(x_kv), jmask)
    got = mha_apply(tp, torch.from_numpy(x_q), torch.from_numpy(x_kv), tmask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    jkv = j_project_kv(jp, jnp.asarray(x_kv))
    want_pre, _, _ = j_mha_apply(jp, jnp.asarray(x_q), None, jmask, precomputed_kv=jkv)
    kv = project_kv(tp, torch.from_numpy(x_kv))
    got_pre = mha_apply(tp, torch.from_numpy(x_q), None, tmask, precomputed_kv=kv)
    np.testing.assert_allclose(got_pre.numpy(), np.asarray(want_pre), rtol=0, atol=1e-5)
    assert torch.equal(got_pre, got)


# --------------------------------------------------------------------------
# train steps


def _jax_run(model_kw, train_kw, batches):
    jcfg, jtcfg = JConfig(**model_kw), JTrain(**train_kw)
    state = j_create_state(jax.random.PRNGKey(0), jcfg, jtcfg)
    init = _flatten(state.params)
    step = jax.jit(j_make_train_step(jcfg, jtcfg))
    losses, norms = [], []
    for src, tgt in batches:
        state, m = step(state, jnp.asarray(src), jnp.asarray(tgt), jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return init, losses, norms, _flatten(state.params)


def _port_run(model_kw, train_kw, init, batches):
    cfg, tcfg = ModelConfig(**model_kw), TrainConfig(**train_kw)
    state = create_train_state(cfg, tcfg, params=params_from_numpy(init, cfg, device="cpu"))
    step = make_train_step(cfg, tcfg)
    losses, norms = [], []
    for src, tgt in batches:
        state, m = step(state, src, tgt)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, {k: v.detach().numpy() for k, v in flatten(state.params).items()}


@pytest.mark.parametrize("case", ["xla", "flash", "tied"])
def test_seq2seq_train_steps_match_jax(case):
    kw = {**MODEL, "attention_impl": "xla" if case == "xla" else "flash"}
    if case == "tied":
        kw.update(TIED)
    batches = [_pairs(seed=10 + i, b=2, s=64, src_vocab=kw["input_vocab_size"])
               for i in range(3)]
    init, want_losses, want_norms, want_params = _jax_run(kw, TRAIN, batches)
    losses, norms, params = _port_run(kw, TRAIN, init, batches)
    for got, want in zip(losses, want_losses):
        assert _rel(got, want) <= 1e-5, (losses, want_losses)
    for got, want in zip(norms, want_norms):
        assert _rel(got, want) <= 1e-4, (norms, want_norms)
    sched = j_noam(MODEL["d_model"], TRAIN["warmup_steps"])
    lr_sum = sum(float(sched(s)) for s in range(3))
    assert params.keys() == want_params.keys()
    for key, want in want_params.items():
        diff = np.abs(params[key] - np.asarray(want)) / lr_sum
        assert diff.max() <= 2.0, key
        if not key.endswith("mha/key/bias"):
            assert diff.mean() <= 1e-5 and diff.max() <= 1e-2, (key, diff.mean(), diff.max())
    if case == "tied":
        enc, dec = "encoder/embedding/table", "decoder/embedding/table"
        assert np.array_equal(init[enc], init[dec])
        for tables in (params, want_params):
            assert np.abs(np.asarray(tables[enc]) - np.asarray(tables[dec])).max() > 1e-4


def test_seq2seq_dropout_under_remat_gives_identical_gradients():
    kw = {**MODEL, "dropout_rate": 0.1, "attention_impl": "flash"}
    flat = _jax_init(kw)
    src, tgt = (torch.from_numpy(a).long() for a in _pairs(seed=3))
    grads, logits = [], []
    for remat in (False, True):
        cfg = ModelConfig(**kw, remat=remat)
        params = params_from_numpy(flat, cfg, device="cpu")
        leaves = flatten(params)
        for p in leaves.values():
            p.requires_grad_(True)
        out = transformer_apply(params, src, tgt[:, :-1], cfg, key=(0, 7), deterministic=False)
        loss, _ = masked_cross_entropy(out, tgt[:, 1:])
        grads.append(torch.autograd.grad(loss, list(leaves.values())))
        logits.append(out.detach())
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    with torch.no_grad():
        det = transformer_apply(params, src, tgt[:, :-1], ModelConfig(**kw))
    assert not torch.equal(det, logits[0])  # dropout did act


# --------------------------------------------------------------------------
# data


@pytest.fixture(scope="module")
def small_corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pairs")
    for split, n in (("train", 200), ("test", 60)):
        for side in ("src", "tgt"):
            with open(os.path.join(ROOT, "data", f"{side}-{split}.txt"), encoding="utf-8") as f:
                head = [next(f) for _ in range(n)]
            (tmp / f"{side}-{split}.txt").write_text("".join(head), encoding="utf-8")
    return tmp


def test_seq2seq_batches_equal_jax(small_corpus):
    kw = dict(batch_size=8, sequence_length=40, target_vocab_size=500, seed=5)
    vocab = [str(small_corpus / f"{side}.subwords") for side in ("src", "tgt")]
    got_train, got_test, got_src, got_tgt = load_dataset(str(small_corpus), *vocab, **kw)
    want_train, want_test, want_src, want_tgt = j_load_dataset(str(small_corpus), *vocab, **kw)
    assert got_src.vocab_size == want_src.vocab_size and got_tgt.vocab_size == want_tgt.vocab_size
    assert got_train.num_examples == want_train.num_examples < 200  # the length filter acted
    assert len(got_train) == len(want_train) > 0
    for epoch in (0, 1):
        got, want = list(got_train.batches(epoch)), list(want_train.batches(epoch))
        assert len(got) == len(want)
        for (gs, gt), (ws, wt) in zip(got, want):
            assert np.array_equal(gs, ws) and np.array_equal(gt, wt)
            assert gs.dtype == ws.dtype and gt.dtype == wt.dtype
    got, want = list(got_test.batches(0)), list(want_test.batches(0))
    assert len(got) == len(want) > 0
    for (gs, gt), (ws, wt) in zip(got, want):
        assert np.array_equal(gs, ws) and np.array_equal(gt, wt)
