"""The port's native data path (``transformer_tpu_torch/native``) against
the JAX package's.

- BPE trainer: the port's native and Python trainers give the JAX
  package's vocabulary piece for piece, on JAX's test corpus at its test
  sizes (500 and 100 pieces) and on the bundled corpus.
- Encoder: native encode equals Python encode on JAX's test strings and
  on random text (escapes, unseen characters, byte fallback).
- ``NativeBatchLoader``: the port's batches equal JAX's ``np.array_equal``
  (unshuffled and shuffled epochs, two epochs, sharded halves, an
  abandoned epoch, bucketed plans, asymmetric lengths).
- ``load_dataset(prefetch=True)`` equals JAX's batch for batch; without
  the library (``TRANSFORMER_TPU_NO_NATIVE``) it warns and takes the
  numpy order.
- The library builds under ``build/native/<hash>/`` and nothing under
  ``transformer_tpu/`` changes.
- The default command line end to end: ``cli.train`` (fp32, dropout 0,
  the native loader by default) restored from a JAX init trains three
  steps on JAX's default batch sequence, held to JAX's steps with the
  limits of ``tests/test_torch_seq2seq.py``.
"""

import os
import random
import warnings
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_dispatch import within
from transformer_tpu import native as j_native
from transformer_tpu.config import ModelConfig as JConfig
from transformer_tpu.config import TrainConfig as JTrain
from transformer_tpu.data.pipeline import Seq2SeqDataset as JDataset
from transformer_tpu.data.pipeline import load_dataset as j_load_dataset
from transformer_tpu.data.tokenizer import SubwordTokenizer as JTokenizer
from transformer_tpu.train.checkpoint import CheckpointManager as JCheckpointManager
from transformer_tpu.train.checkpoint import _flatten
from transformer_tpu.train.schedule import noam_schedule as j_noam
from transformer_tpu.train.state import create_train_state as j_create_state
from transformer_tpu.train.trainer import make_train_step as j_make_train_step
from transformer_tpu_torch import native
from transformer_tpu_torch.data.pipeline import Seq2SeqDataset, load_dataset
from transformer_tpu_torch.data.tokenizer import SubwordTokenizer, _word_to_symbols
from transformer_tpu_torch.models.transformer import flatten

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX's tests/test_native.py corpus.
CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "she sells sea shells by the sea shore",
    "ein Haus am See mit Blick über den Fluß",
    "underscores _like_ this and back\\slashes and <angle> brackets",
    "unicode: Ω μῆνιν ἄειδε θεά 真真好 émigré",
    "numbers 12345 and <0x41> literal byte token text",
] * 3
TEXTS = [
    "the quick brown fox",
    "completely unseen zebra words xylophone",
    "unicode Ω 真好 μῆνιν mixed with ascii",
    "under_score \\backslash <angle <0x41> literal",
    "",
    "   ",
    "a",
    "ein Haus am See",
]


@pytest.fixture(scope="module")
def lib():
    if native.get_lib() is None or j_native.get_lib() is None:
        pytest.skip("a native library does not build here (no g++?)")
    return native.get_lib()


def _without(module):
    """A context that turns one package's library off."""

    class Off:
        def __enter__(self):
            self.saved, module._lib = module._lib, False

        def __exit__(self, *exc):
            module._lib = self.saved

    return Off()


def _bundled(n: int) -> list[str]:
    with open(os.path.join(ROOT, "data", "src-train.txt"), encoding="utf-8") as f:
        return [next(f).rstrip("\n") for _ in range(n)]


# --------------------------------------------------------------------------
# BPE trainer and encoder


@pytest.mark.parametrize("corpus,size", [("jax", 500), ("jax", 100), ("bundled", 3000)])
def test_bpe_trainer_gives_jax_vocabulary(lib, corpus, size):
    lines = CORPUS if corpus == "jax" else _bundled(2000)
    native_tok = SubwordTokenizer.build_from_corpus(lines, target_vocab_size=size)
    with _without(native):
        python_tok = SubwordTokenizer.build_from_corpus(lines, target_vocab_size=size)
    with _without(j_native):
        want = JTokenizer.build_from_corpus(lines, target_vocab_size=size).subwords
    assert native_tok.subwords == python_tok.subwords == want
    assert JTokenizer.build_from_corpus(lines, target_vocab_size=size).subwords == want
    word_freq = Counter(w for line in lines for w in line.split())
    assert native.NativeTokenizer.train(word_freq, size, 2).pieces() == want


@pytest.fixture(scope="module")
def tok(lib):
    return SubwordTokenizer.build_from_corpus(CORPUS, target_vocab_size=500)


def _python_encode(tok, text):
    return [i for w in text.split() for i in tok._encode_symbols(_word_to_symbols(w))]


@pytest.mark.parametrize("text", TEXTS)
def test_native_encode_equals_python_and_jax(tok, text):
    assert tok._native_encoder() is not None  # the fast path engages
    got = tok.encode(text)
    assert got == _python_encode(tok, text) == JTokenizer(tok.subwords).encode(text)
    assert tok.decode(got) == " ".join(text.split())


def test_native_encode_random_text(tok):
    rng = random.Random(0)
    pool = "abcdefghijklmnopqrstuvwxyz_\\<>ΩµßüéА真 0123456789"
    text = " ".join(
        "".join(rng.choice(pool) for _ in range(rng.randrange(1, 12))) for _ in range(500)
    )
    nat = native.NativeTokenizer.from_pieces(tok.subwords)
    assert nat.encode_words(text.split()) == _python_encode(tok, text)
    assert nat.encode_words(text.split()) == j_native.NativeTokenizer.from_pieces(
        tok.subwords).encode_words(text.split())


def test_incomplete_vocab_keeps_the_python_encoder(lib):
    """A hand-built vocabulary without the <0xNN> pieces never engages the
    C++ encoder, whose byte fallback cannot raise as Python's does."""
    t = SubwordTokenizer(["ab", "_"])
    assert t._native_encoder() is None
    with pytest.raises(KeyError):
        t.encode("xy")


def test_tokenizer_pickles_without_its_handle(tok):
    import pickle

    tok.encode("the fox")
    back = pickle.loads(pickle.dumps(tok))
    assert back._native is None and back.encode("the fox") == tok.encode("the fox")


# --------------------------------------------------------------------------
# the batch loader


def _examples(n=37, seed=0):
    rng = np.random.default_rng(seed)
    src = [rng.integers(1, 50, size=rng.integers(2, 14), dtype=np.int32) for _ in range(n)]
    tgt = [rng.integers(1, 50, size=rng.integers(2, 12), dtype=np.int32) for _ in range(n)]
    return src, tgt


def _same(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for (gs, gt), (ws, wt) in zip(got, want):
        assert gs.dtype == ws.dtype == np.int32
        assert np.array_equal(gs, ws) and np.array_equal(gt, wt)
    return got


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_remainder", [True, False])
def test_loader_batches_equal_jax(lib, shuffle, drop_remainder):
    src, tgt = _examples()
    kw = dict(batch_size=8, src_len=10, tgt_len=10, seed=3, shuffle=shuffle,
              drop_remainder=drop_remainder, prefetch=True)
    got_ds, want_ds = Seq2SeqDataset(src, tgt, **kw), JDataset(src, tgt, **kw)
    epochs = [_same(got_ds.batches(e), want_ds.batches(e)) for e in (0, 1)]
    assert got_ds.native_loader().epochs == 2
    assert got_ds.native_loader().batches == sum(len(e) for e in epochs)
    if shuffle:
        assert [s.tolist() for s, _ in epochs[0]] != [s.tolist() for s, _ in epochs[1]]
    else:  # the unshuffled order is the numpy path's
        plain = Seq2SeqDataset(src, tgt, **{**kw, "prefetch": False})
        _same(got_ds.batches(0), plain.batches(0))


def test_loader_sharded_halves_equal_jax(lib):
    """Each process's rows (``lo``) of every global batch: the port's
    ``NativeBatchLoader`` against JAX's, and the halves make the whole."""
    src, tgt = _examples()
    whole = list(native.NativeBatchLoader.create(src, tgt, 8, 8, 0, 10, 10).epoch(7, True,
                                                                                   False))
    for lo in (0, 4):
        got = native.NativeBatchLoader.create(src, tgt, 8, 4, lo, 10, 10)
        want = j_native.NativeBatchLoader.create(src, tgt, 8, 4, lo, 10, 10)
        half = _same(got.epoch(7, True, False), want.epoch(7, True, False))
        for (h, _), (w, _) in zip(half, whole):
            assert np.array_equal(h, w[lo : lo + 4])


def test_loader_abandoned_epoch_then_the_next_equals_jax(lib):
    src, tgt = _examples()
    kw = dict(batch_size=8, src_len=10, tgt_len=10, seed=3, drop_remainder=False,
              prefetch=True)
    got_ds, want_ds = Seq2SeqDataset(src, tgt, **kw), JDataset(src, tgt, **kw)
    it = got_ds.batches(0)
    next(it)
    del it  # the consumer walks away with batches still queued
    got = _same(got_ds.batches(1), want_ds.batches(1))
    assert len(got) == len(got_ds)


@pytest.mark.parametrize("lens", [(14, 14), (8, 14)])
def test_loader_bucketed_plan_equals_jax(lib, lens):
    """Bucketed plans (members, then the plan, in splitmix64 order), and
    asymmetric lengths whose bucket is wider than the narrower side."""
    src, tgt = _examples()
    buckets = (6, 8, 14) if lens == (14, 14) else (6, 14)
    kw = dict(batch_size=8, src_len=lens[0], tgt_len=lens[1], seed=3, drop_remainder=False,
              length_buckets=buckets, prefetch=True)
    got_ds, want_ds = Seq2SeqDataset(src, tgt, **kw), JDataset(src, tgt, **kw)
    widths = set()
    for epoch in (0, 1):
        for s, t in _same(got_ds.batches(epoch), want_ds.batches(epoch)):
            assert s.shape[1] == t.shape[1] in buckets
            widths.add(s.shape[1])
    assert len(widths) > 1


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("native_corpus")
    for split, n in (("train", 300), ("test", 40)):
        for side in ("src", "tgt"):
            with open(os.path.join(ROOT, "data", f"{side}-{split}.txt"), encoding="utf-8") as f:
                (d / f"{side}-{split}.txt").write_text("".join(next(f) for _ in range(n)),
                                                        encoding="utf-8")
    return d


@pytest.mark.parametrize("buckets", [(), (16, 32, 48, 64)])
@within(120)
def test_load_dataset_prefetch_equals_jax(lib, corpus, buckets):
    vocab = [str(corpus / "s.subwords"), str(corpus / "t.subwords")]
    kw = dict(batch_size=16, sequence_length=64, target_vocab_size=600, seed=5,
              prefetch=True, length_buckets=buckets)
    got = load_dataset(str(corpus), *vocab, **kw)
    want = j_load_dataset(str(corpus), *vocab, **kw)
    assert got[2].subwords == want[2].subwords and got[3].subwords == want[3].subwords
    assert got[0].native_loader() is not None
    for epoch in (0, 1):
        _same(got[0].batches(epoch), want[0].batches(epoch))
    _same(got[1].batches(0), want[1].batches(0))


def test_without_the_library_prefetch_warns_and_keeps_the_numpy_order(lib, monkeypatch):
    monkeypatch.setenv("TRANSFORMER_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_lib", None)
    assert native.get_lib() is None
    src, tgt = _examples()
    kw = dict(batch_size=8, src_len=10, tgt_len=10, seed=3)
    ds = Seq2SeqDataset(src, tgt, prefetch=True, **kw)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        got = list(ds.batches(0))
    assert any(issubclass(w.category, RuntimeWarning) and "batch order" in str(w.message)
               for w in seen)
    _same(got, Seq2SeqDataset(src, tgt, **kw).batches(0))
    monkeypatch.setattr(native, "_lib", None)  # the library again for later tests


def test_library_builds_under_build_native_only(lib, tmp_path, monkeypatch):
    """The port builds its library into ``build/native/<hash>/`` (here a
    temporary one) by tmp-and-rename, never under ``transformer_tpu/``."""

    def tree():
        out = {}
        for base, dirs, files in os.walk(os.path.join(ROOT, "transformer_tpu")):
            dirs[:] = [d for d in dirs if d != "__pycache__"]
            for name in files:
                # the JAX package's own library (and its build's temporaries)
                if base.endswith(os.path.join("transformer_tpu", "native")) and \
                        name.endswith(".so"):
                    continue
                st = os.stat(os.path.join(base, name))
                out[os.path.join(base, name)] = (st.st_size, st.st_mtime_ns)
        return out

    assert str(native.library_path()).startswith(os.path.join(ROOT, "build", "native"))
    before = tree()
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    built = native._build()
    assert built == native.library_path() and built.parent.parent == tmp_path
    assert sorted(p.name for p in built.parent.iterdir()) == ["libtpu_native.so"]
    assert tree() == before
    monkeypatch.setattr(native, "_lib", None)


# --------------------------------------------------------------------------
# the default command line end to end


@within(300)
def test_cli_train_defaults_see_jax_default_batch_sequence(lib, tmp_path):
    """``cli.train`` on its defaults batches through the native loader: its
    three steps from a JAX init (restored from a JAX checkpoint at step 0)
    see the batches of JAX's ``load_dataset(prefetch=True)`` and end within
    the train-parity limits of JAX's own three steps."""
    from transformer_tpu_torch.cli import train

    for side in ("src", "tgt"):
        with open(os.path.join(ROOT, "data", f"{side}-train.txt"), encoding="utf-8") as f:
            (tmp_path / f"{side}-train.txt").write_text("".join(next(f) for _ in range(60)),
                                                         encoding="utf-8")
    vocab = [str(tmp_path / "s.subwords"), str(tmp_path / "t.subwords")]
    kept = j_load_dataset(str(tmp_path), *vocab, batch_size=1, sequence_length=64,
                          target_vocab_size=600)[0].num_examples
    batch = kept // 3  # three steps in the epoch
    want_ds, _, src_tok, tgt_tok = j_load_dataset(
        str(tmp_path), *vocab, batch_size=batch, sequence_length=64, prefetch=True)
    model = dict(num_layers=1, d_model=32, num_heads=4, dff=64,
                 input_vocab_size=src_tok.model_vocab_size,
                 target_vocab_size=tgt_tok.model_vocab_size, max_position=64,
                 dropout_rate=0.0, dtype="float32")
    tcfg = dict(batch_size=batch, sequence_length=64, epochs=1, warmup_steps=4)
    jcfg, jtcfg = JConfig(**model), JTrain(**tcfg)
    state = j_create_state(jax.random.PRNGKey(0), jcfg, jtcfg)
    ckpt = str(tmp_path / "ckpt")
    JCheckpointManager(ckpt, is_primary=True).save(state)
    step = jax.jit(j_make_train_step(jcfg, jtcfg))
    want_losses = []
    batches = list(want_ds.batches(0))
    assert len(batches) == 3 == len(want_ds)
    for src, tgt in batches:
        state, m = step(state, jnp.asarray(src), jnp.asarray(tgt), jax.random.PRNGKey(0))
        want_losses.append(float(m["loss"]))
    logs = []
    trainer = train.main([
        "--device=cpu", "--dataset_path", str(tmp_path), "--src_vocab_file", vocab[0],
        "--tgt_vocab_file", vocab[1], "--num_layers", "1", "--d_model", "32", "--dff", "64",
        "--num_heads", "4", "--sequence_length", "64", "--batch_size", str(batch), "--epochs", "1",
        "--warmup_steps", "4", "--dropout_rate", "0", "--dtype", "float32",
        "--eval_bleu=false", "--ckpt_path", ckpt, "--export_path", str(tmp_path / "export"),
    ], log_fn=logs.append)
    assert any("native loader" in line for line in logs), logs
    assert trainer.state.step == 3
    for got, want in zip(trainer.losses, want_losses, strict=True):
        assert abs(got - want) <= 1e-5 * abs(want), (trainer.losses, want_losses)
    lr_sum = sum(float(j_noam(32, 4)(s)) for s in range(3))
    want_params = _flatten(state.params)
    params = {k: v.detach().numpy() for k, v in flatten(trainer.state.params).items()}
    assert params.keys() == want_params.keys()
    for key, want in want_params.items():
        diff = np.abs(params[key] - np.asarray(want)) / lr_sum
        assert diff.max() <= 2.0, key
        if not key.endswith("mha/key/bias"):
            assert diff.mean() <= 1e-5 and diff.max() <= 1e-2, (key, diff.mean(), diff.max())
    # The numpy order is another batch sequence: the same run on it differs.
    numpy_order = [s for s, _ in j_load_dataset(
        str(tmp_path), *vocab, batch_size=batch, sequence_length=64)[0].batches(0)]
    assert any(not np.array_equal(a, b) for a, b in zip(numpy_order, [s for s, _ in batches]))
