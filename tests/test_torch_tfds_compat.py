"""``data/tfds_compat.py`` (``TfdsSubwordTokenizer``: the reference's tfds
``SubwordTextEncoder`` vocab files) against the JAX package's, on JAX's
hand-built tfds vocabulary (``tests/test_data.py`` ``TestTfdsCompat``).

- ids and decoded strings equal JAX's on every line of
  ``data/src-test.txt`` (and ``tgt-test.txt``), and on JAX's own
  round-trip strings;
- the id space: pad 0, subwords in file order, 256 byte ids, BOS/EOS
  outside;
- ``SubwordTokenizer.load`` sniffs the tfds header in both packages;
- ``save`` writes JAX's bytes; a file with metadata lines and escapes
  loads alike;
- the pipeline trains on tfds vocab files (``load_dataset``, in memory
  and streaming) with JAX's batches.
"""

import os

import numpy as np
import pytest

from transformer_tpu.data.pipeline import load_dataset as j_load_dataset
from transformer_tpu.data.tfds_compat import TfdsSubwordTokenizer as JTfds
from transformer_tpu.data.tokenizer import SubwordTokenizer as JTokenizer
from transformer_tpu_torch.data.pipeline import load_dataset
from transformer_tpu_torch.data.tfds_compat import TfdsSubwordTokenizer
from transformer_tpu_torch.data.tokenizer import SubwordTokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIECES = [
    "the_", "quick_", "bro", "wn_", "fox", "es_",
    "a", "b", "c", "d", "e", "f", "h", "i", "k", "n", "o", "q",
    "r", "s", "t", "u", "w", "x", "_", "\\", ";", ".",
] + list("0123456789")


@pytest.fixture()
def vocab_file(tmp_path):
    p = tmp_path / "ref.subwords"
    lines = ["### SubwordTextEncoder", "### Metadata: {}"]
    lines += ["'" + s.replace("\\", "\\\\").replace("\n", "\\n") + "'" for s in PIECES]
    p.write_text("\n".join(lines) + "\n")
    return str(p)


def _lines(name):
    with open(os.path.join(ROOT, "data", name), encoding="utf-8") as f:
        return [line.rstrip("\n") for line in f]


@pytest.mark.parametrize("name", ["src-test.txt", "tgt-test.txt"])
def test_ids_and_strings_equal_jax_on_the_test_split(vocab_file, name):
    got, want = TfdsSubwordTokenizer.load(vocab_file), JTfds.load(vocab_file)
    lines = _lines(name)
    assert len(lines) == 500
    for line in lines:
        ids = got.encode(line)
        assert ids == want.encode(line), line
        assert got.decode(ids) == want.decode(ids)
        assert all(0 < i < got.vocab_size for i in ids)


@pytest.mark.parametrize("text", [
    "the quick brown fox", "the quick the quick",
    "foxes run under_scores and back\\slashes", "punct. at ends.",
    "unicode: über café", "digits 0123 and ; semicolons",
])
def test_roundtrip_strings_equal_jax(vocab_file, text):
    got, want = TfdsSubwordTokenizer.load(vocab_file), JTfds.load(vocab_file)
    assert got.encode(text) == want.encode(text)
    assert got.decode(got.encode(text)) == want.decode(want.encode(text)) == text


def test_id_space_and_greedy_match(vocab_file):
    tok = TfdsSubwordTokenizer.load(vocab_file)
    n = len(PIECES)
    assert tok.subwords == PIECES
    assert (tok.vocab_size, tok.bos_id, tok.eos_id, tok.model_vocab_size) == (
        1 + n + 256, 1 + n + 256, 2 + n + 256, 3 + n + 256)
    assert tok.encode("the") == [1]
    assert tok.encode("foxes") == [PIECES.index("fox") + 1, PIECES.index("es_") + 1]
    ids = tok.encode("ü")  # outside the alphabet: escaped, then bytes
    assert ids == JTfds.load(vocab_file).encode("ü") and tok.decode(ids) == "ü"


def test_subword_load_sniffs_the_tfds_header(vocab_file, tmp_path):
    got, want = SubwordTokenizer.load(vocab_file), JTokenizer.load(vocab_file)
    assert isinstance(got, TfdsSubwordTokenizer) and isinstance(want, JTfds)
    assert got.subwords == want.subwords
    bad = tmp_path / "bad.subwords"
    bad.write_text("neither\n")
    with pytest.raises(ValueError, match="neither a transformer_tpu nor a tfds"):
        SubwordTokenizer.load(str(bad))
    with pytest.raises(ValueError, match="not a tfds SubwordTextEncoder"):
        TfdsSubwordTokenizer.load(str(bad))


def test_save_is_byte_identical_to_jax(vocab_file, tmp_path):
    pieces = PIECES + ["multi\nline", "back\\slash_", "'quoted'"]
    TfdsSubwordTokenizer(pieces).save(str(tmp_path / "got.subwords"))
    JTfds(pieces).save(str(tmp_path / "want.subwords"))
    got = (tmp_path / "got.subwords").read_bytes()
    assert got == (tmp_path / "want.subwords").read_bytes()
    assert TfdsSubwordTokenizer.load(str(tmp_path / "got.subwords")).subwords == pieces
    TfdsSubwordTokenizer.load(vocab_file).save(str(tmp_path / "again.subwords"))
    assert (tmp_path / "again.subwords").read_bytes() == open(vocab_file, "rb").read()


@pytest.mark.parametrize("streaming", [False, True])
def test_pipeline_on_tfds_vocabularies_equals_jax(vocab_file, tmp_path, streaming):
    for side in ("src", "tgt"):
        for split, n in (("train", 60), ("test", 10)):
            lines = _lines(f"{side}-{split}.txt")[:n]
            (tmp_path / f"{side}-{split}.txt").write_text("\n".join(lines) + "\n",
                                                           encoding="utf-8")
    kw = dict(batch_size=8, sequence_length=256, streaming=streaming, buffer_size=16)
    got = load_dataset(str(tmp_path), vocab_file, vocab_file, **kw)
    want = j_load_dataset(str(tmp_path), vocab_file, vocab_file, **kw)
    assert isinstance(got[2], TfdsSubwordTokenizer)
    for (gs, gt), (ws, wt) in zip(got[0].batches(0), want[0].batches(0), strict=True):
        assert np.array_equal(gs, ws) and np.array_equal(gt, wt)
    assert (got[0].batches(0).__next__()[0][:, 0] == got[2].bos_id).all()
