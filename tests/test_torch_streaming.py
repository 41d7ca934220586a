"""``data/streaming.py`` (``StreamingSeq2SeqDataset``) and
``load_dataset(streaming=True)`` against the JAX package's.

- The streaming batches equal JAX's element for element over two epochs,
  whole and as two shards of one global stream, shuffled and not, with
  and without ``drop_remainder``.
- The memory bound, read from the dataset's own counts as JAX's test
  reads it: the buffer never holds more than ``buffer_size`` examples,
  and the resident examples (buffer + the forming batch) never more than
  ``buffer_size + batch_size``.
- ``load_dataset(streaming=True)`` equals JAX's (train and test batches),
  and refuses what JAX refuses, with its messages: ``prefetch``,
  ``length_buckets``, missing vocab files.
- ``cli.train --streaming --buffer_size`` trains on the CPU and logs the
  streaming line in place of the example count.
"""

import os

import numpy as np
import pytest

from transformer_tpu.data.pipeline import load_dataset as j_load_dataset
from transformer_tpu.data.streaming import StreamingSeq2SeqDataset as JStreaming
from transformer_tpu.data.tokenizer import SubwordTokenizer as JTokenizer
from transformer_tpu_torch.data.pipeline import load_dataset
from transformer_tpu_torch.data.streaming import StreamingSeq2SeqDataset
from transformer_tpu_torch.data.tokenizer import SubwordTokenizer


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """500 distinct lines, big beside the 32-example buffer, plus a test
    split, and both vocabularies built (the JAX test's corpus)."""
    d = tmp_path_factory.mktemp("stream_corpus")
    lines = [f"line number {i} with some words" for i in range(500)]
    (d / "src-train.txt").write_text("\n".join(lines) + "\n")
    (d / "tgt-train.txt").write_text("\n".join(line.upper() for line in lines) + "\n")
    (d / "src-test.txt").write_text("\n".join(lines[:20]) + "\n")
    (d / "tgt-test.txt").write_text("\n".join(line.upper() for line in lines[:20]) + "\n")
    load_dataset(str(d), str(d / "src.subwords"), str(d / "tgt.subwords"), batch_size=4,
                 sequence_length=24, target_vocab_size=300)
    return d


def _pair(d, **kw):
    args = dict(batch_size=4, sequence_length=24, buffer_size=32, seed=0)
    args.update(kw)
    src, tgt = str(d / "src.subwords"), str(d / "tgt.subwords")
    got = StreamingSeq2SeqDataset(str(d), SubwordTokenizer.load(src),
                                  SubwordTokenizer.load(tgt), **args)
    want = JStreaming(str(d), JTokenizer.load(src), JTokenizer.load(tgt), **args)
    return got, want


def _same(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for (gs, gt), (ws, wt) in zip(got, want):
        assert gs.dtype == ws.dtype == np.int32
        assert np.array_equal(gs, ws) and np.array_equal(gt, wt)
    return got


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_remainder", [True, False])
def test_streaming_batches_equal_jax(corpus, shuffle, drop_remainder):
    got, want = _pair(corpus, shuffle=shuffle, drop_remainder=drop_remainder)
    epochs = [_same(got.batches(e), want.batches(e)) for e in (0, 1)]
    assert got.num_examples == want.num_examples == 500
    if shuffle:
        assert not np.array_equal(epochs[0][0][0], epochs[1][0][0])


def test_streaming_shards_equal_jax_and_slice_one_stream(corpus):
    whole, _ = _pair(corpus)
    for epoch in (0, 1):
        halves = []
        for index in (0, 1):
            got, want = _pair(corpus, shard_index=index, shard_count=2)
            halves.append(_same(got.batches(epoch), want.batches(epoch)))
        for (a, _), (b, _), (w, _) in zip(*halves, whole.batches(epoch)):
            assert np.array_equal(np.concatenate([a, b]), w)


@pytest.mark.parametrize("buffer_size", [1, 32, 1000])
def test_peak_buffer_within_buffer_size(corpus, buffer_size):
    got, want = _pair(corpus, buffer_size=buffer_size)
    _same(got.batches(0), want.batches(0))
    assert 0 < got.peak_buffer_examples <= buffer_size
    assert got.peak_resident_examples == want.peak_resident_examples
    assert got.peak_resident_examples <= buffer_size + 4


def test_load_dataset_streaming_equals_jax(corpus):
    vocab = [str(corpus / "src.subwords"), str(corpus / "tgt.subwords")]
    kw = dict(batch_size=4, sequence_length=24, streaming=True, buffer_size=32, seed=2)
    got, want = load_dataset(str(corpus), *vocab, **kw), j_load_dataset(str(corpus), *vocab,
                                                                         **kw)
    assert isinstance(got[0], StreamingSeq2SeqDataset)
    for epoch in (0, 1):
        _same(got[0].batches(epoch), want[0].batches(epoch))
    _same(got[1].batches(0), want[1].batches(0))
    held = load_dataset(str(corpus), *vocab, **kw, exclude_test_overlap=True)[0]
    j_held = j_load_dataset(str(corpus), *vocab, **kw, exclude_test_overlap=True)[0]
    _same(held.batches(0), j_held.batches(0))
    rows = {r.tobytes() for s, _ in held.batches(0) for r in s}
    assert rows.isdisjoint({r.tobytes() for s, _ in got[1].batches(0) for r in s})


@pytest.mark.parametrize("extra,error,match", [
    (dict(prefetch=True), ValueError, "does not compose with prefetch"),
    (dict(length_buckets=(8, 24)), ValueError, "does not compose with prefetch"),
    (dict(vocab="missing"), FileNotFoundError, "needs pre-built vocab files"),
])
def test_streaming_refusals_match_jax(corpus, extra, error, match):
    vocab = [str(corpus / "src.subwords"), str(corpus / "tgt.subwords")]
    if extra.pop("vocab", None):
        vocab = [str(corpus / "no.subwords")] * 2
    kw = dict(batch_size=4, sequence_length=24, streaming=True, **extra)
    for loader in (load_dataset, j_load_dataset):
        with pytest.raises(error, match=match):
            loader(str(corpus), *vocab, **kw)


def test_cli_train_streams(corpus, tmp_path):
    from transformer_tpu_torch.cli import train

    logs = []
    trainer = train.main([
        "--device=cpu", "--dataset_path", str(corpus), "--src_vocab_file",
        str(corpus / "src.subwords"), "--tgt_vocab_file", str(corpus / "tgt.subwords"),
        "--num_layers", "1", "--d_model", "16", "--dff", "32", "--num_heads", "2",
        "--sequence_length", "24", "--batch_size", "16", "--epochs", "1", "--streaming",
        "--buffer_size", "64", "--eval_bleu=false", "--ckpt_path", str(tmp_path / "ckpt"),
        "--export_path", str(tmp_path / "export"),
    ], log_fn=logs.append)
    assert any(line.startswith("data: streaming corpus (buffer 64)") for line in logs), logs
    assert trainer.state.step == 500 // 16 and np.isfinite(trainer.train_metrics.loss)
    assert os.path.exists(tmp_path / "export" / "params.npz")
