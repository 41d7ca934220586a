"""Host-side input pipeline: parallel-corpus pairs and LM windows.

Port of the parts of ``transformer_tpu/data/pipeline.py`` that
``cli.train`` runs: the parallel-corpus reader, the tokenizer
build-or-load, the seq2seq dataset of ``load_dataset`` on its in-memory
path (BOS/EOS framing, the filter that drops a train pair with either side
longer than ``sequence_length``, the test split cut to fit), the
causal-LM dataset (the corpus as one EOS-separated token stream cut into
BOS-prefixed windows) and the flat in-memory batcher of ``Seq2SeqDataset``
with its (seed, epoch)-keyed shuffle. Batches are numpy int32 arrays equal
to the JAX package's, element for element. Length buckets, the native C++
loader, prefetch and streaming are not ported: they raise.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from collections.abc import Iterator

import numpy as np

from transformer_tpu_torch.config import PAD_ID
from transformer_tpu_torch.data.seeding import epoch_rng
from transformer_tpu_torch.data.tokenizer import SubwordTokenizer


def corpus_files(dataset_path: str, split: str) -> tuple[list[str], list[str]]:
    """The ``{src,tgt}-{split}*.txt`` line files of one split, sorted."""
    src_files = sorted(glob.glob(os.path.join(dataset_path, f"src-{split}*.txt")))
    tgt_files = sorted(glob.glob(os.path.join(dataset_path, f"tgt-{split}*.txt")))
    if not src_files or not tgt_files:
        raise FileNotFoundError(
            f"no {split} corpus under {dataset_path!r} "
            f"(expected src-{split}*.txt / tgt-{split}*.txt)"
        )
    return src_files, tgt_files


def read_parallel_corpus(dataset_path: str, split: str = "train") -> tuple[list[str], list[str]]:
    """Zipped src/tgt lines of one split."""
    src_files, tgt_files = corpus_files(dataset_path, split)
    src_lines: list[str] = []
    tgt_lines: list[str] = []
    for sf, tf in zip(src_files, tgt_files):
        with open(sf, encoding="utf-8") as f:
            src_lines.extend(line.rstrip("\n") for line in f)
        with open(tf, encoding="utf-8") as f:
            tgt_lines.extend(line.rstrip("\n") for line in f)
    if len(src_lines) != len(tgt_lines):
        raise ValueError(
            f"parallel corpus length mismatch: {len(src_lines)} src vs "
            f"{len(tgt_lines)} tgt lines"
        )
    return src_lines, tgt_lines


def load_or_build_tokenizer(
    vocab_file: str, corpus: list[str] | None = None, target_vocab_size: int = 2**15
) -> SubwordTokenizer:
    """Load a persisted vocab, else train one from ``corpus`` and save it."""
    if os.path.exists(vocab_file):
        return SubwordTokenizer.load(vocab_file)
    if corpus is None:
        raise FileNotFoundError(f"vocab file {vocab_file!r} missing and no corpus given")
    tok = SubwordTokenizer.build_from_corpus(corpus, target_vocab_size)
    os.makedirs(os.path.dirname(vocab_file) or ".", exist_ok=True)
    tok.save(vocab_file)
    return tok


def _encode_and_frame(lines: list[str], tok: SubwordTokenizer) -> list[np.ndarray]:
    bos, eos = tok.bos_id, tok.eos_id
    return [np.asarray([bos, *tok.encode(line), eos], dtype=np.int32) for line in lines]


def _round_up(n: int, multiple: int = 8) -> int:
    return ((n + multiple - 1) // multiple) * multiple


@dataclasses.dataclass
class Seq2SeqDataset:
    """In-memory dataset yielding fixed-shape (B, L) int32 (src, tgt)
    batches: the flat batcher of the JAX twin. ``drop_remainder=False``
    pads the last batch with empty rows (index -1), which come out all PAD
    and carry no metric weight."""

    src: list[np.ndarray]
    tgt: list[np.ndarray]
    batch_size: int
    src_len: int
    tgt_len: int
    shuffle: bool = True
    seed: int = 0
    drop_remainder: bool = True

    def __post_init__(self) -> None:
        if len(self.src) != len(self.tgt):
            raise ValueError("src/tgt example count mismatch")

    def __len__(self) -> int:
        full, rem = divmod(len(self.src), self.batch_size)
        return full + (1 if rem and not self.drop_remainder else 0)

    @property
    def num_examples(self) -> int:
        return len(self.src)

    def batches(self, epoch: int = 0) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        order = np.arange(len(self.src))
        if self.shuffle:
            epoch_rng(self.seed, epoch).shuffle(order)
        stop = len(order) - (self.batch_size - 1 if self.drop_remainder else 0)
        for start in range(0, stop, self.batch_size):
            idx = order[start : start + self.batch_size]
            if len(idx) < self.batch_size:
                fill = np.full(self.batch_size - len(idx), -1, dtype=np.int64)
                idx = np.concatenate([idx, fill])
            yield self._pad(idx)

    def _pad(self, idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        src = np.full((len(idx), self.src_len), PAD_ID, dtype=np.int32)
        tgt = np.full((len(idx), self.tgt_len), PAD_ID, dtype=np.int32)
        for row, i in enumerate(idx):
            if i < 0:
                continue  # padding row
            s = self.src[i][: self.src_len]
            t = self.tgt[i][: self.tgt_len]
            src[row, : len(s)] = s
            tgt[row, : len(t)] = t
        return src, tgt


def make_lm_dataset(
    lines: list[str],
    tok: SubwordTokenizer,
    batch_size: int,
    sequence_length: int,
    seed: int = 0,
    shuffle: bool = True,
    drop_remainder: bool = True,
) -> Seq2SeqDataset:
    """Causal-LM dataset: documents joined with EOS into one stream, cut
    into windows of BOS + ``sequence_length - 1`` stream tokens (the train
    step's teacher-forcing shift means consecutive windows need no
    overlap); src and tgt are the same windows."""
    stream: list[np.ndarray] = []
    for line in lines:
        ids = tok.encode(line)
        if ids:
            stream.append(np.asarray(ids + [tok.eos_id], dtype=np.int32))
    if not stream:
        raise ValueError("empty corpus for LM dataset")
    flat = np.concatenate(stream)
    body = sequence_length - 1
    n_windows = len(flat) // body
    if n_windows == 0:
        raise ValueError(
            f"corpus ({len(flat)} tokens) shorter than one {sequence_length}-token window"
        )
    windows = [
        np.concatenate([[tok.bos_id], flat[i * body : (i + 1) * body]]).astype(np.int32)
        for i in range(n_windows)
    ]
    return Seq2SeqDataset(
        windows, windows, batch_size=batch_size, src_len=sequence_length,
        tgt_len=sequence_length, shuffle=shuffle, seed=seed,
        drop_remainder=drop_remainder,
    )


def load_lm_splits(
    dataset_path: str,
    vocab_file: str,
    batch_size: int,
    sequence_length: int,
    target_vocab_size: int = 2**15,
    seed: int = 0,
) -> tuple[Seq2SeqDataset, Seq2SeqDataset | None, SubwordTokenizer]:
    """Causal-LM train (+ test, when the split exists and holds a window)
    datasets over the target-side corpus. Eval sees every window once:
    unshuffled, with an all-PAD-padded tail batch."""
    _, tgt_lines = read_parallel_corpus(dataset_path, "train")
    tok = load_or_build_tokenizer(vocab_file, tgt_lines, target_vocab_size)
    train = make_lm_dataset(
        tgt_lines, tok, batch_size=batch_size, sequence_length=sequence_length, seed=seed
    )
    test: Seq2SeqDataset | None
    try:
        _, test_tgt = read_parallel_corpus(dataset_path, "test")
        test = make_lm_dataset(
            test_tgt, tok, batch_size=batch_size, sequence_length=sequence_length,
            seed=seed, shuffle=False, drop_remainder=False,
        )
    except (FileNotFoundError, ValueError):
        test = None  # no test split, or one shorter than a window
    return train, test, tok


def load_dataset(
    dataset_path: str,
    src_vocab_file: str,
    tgt_vocab_file: str,
    batch_size: int,
    sequence_length: int,
    target_vocab_size: int = 2**15,
    seed: int = 0,
    prefetch: bool = False,
    length_buckets: tuple[int, ...] = (),
    streaming: bool = False,
) -> tuple[Seq2SeqDataset, Seq2SeqDataset | None, SubwordTokenizer, SubwordTokenizer]:
    """Seq2seq train (+ test, when the split exists) datasets and both
    tokenizers, built from (or saved to) the vocab files. Train pairs with
    either side longer than ``sequence_length`` after BOS/EOS framing are
    dropped."""
    if streaming or prefetch or length_buckets:
        raise NotImplementedError(
            "streaming, the native prefetching loader and length buckets are not "
            "ported; the port batches the corpus in memory"
        )
    src_lines, tgt_lines = read_parallel_corpus(dataset_path, "train")
    src_tok = load_or_build_tokenizer(src_vocab_file, src_lines, target_vocab_size)
    tgt_tok = load_or_build_tokenizer(tgt_vocab_file, tgt_lines, target_vocab_size)
    src_ids = _encode_and_frame(src_lines, src_tok)
    tgt_ids = _encode_and_frame(tgt_lines, tgt_tok)
    keep = [
        i for i in range(len(src_ids))
        if len(src_ids[i]) <= sequence_length and len(tgt_ids[i]) <= sequence_length
    ]
    train = Seq2SeqDataset(
        [src_ids[i] for i in keep], [tgt_ids[i] for i in keep], batch_size=batch_size,
        src_len=sequence_length, tgt_len=sequence_length, shuffle=True, seed=seed,
    )
    test = _build_test_split(dataset_path, src_tok, tgt_tok, batch_size, sequence_length)
    return train, test, src_tok, tgt_tok


def _build_test_split(
    dataset_path: str,
    src_tok: SubwordTokenizer,
    tgt_tok: SubwordTokenizer,
    batch_size: int,
    sequence_length: int,
) -> Seq2SeqDataset | None:
    """The test split, unshuffled with an all-PAD-padded tail batch: no
    length filter, but examples longer than ``sequence_length`` are cut to
    it and keep their EOS; each side pads to its longest example rounded
    up to 8, at most ``sequence_length``."""
    try:
        test_src, test_tgt = read_parallel_corpus(dataset_path, "test")
    except FileNotFoundError:
        return None

    def truncate_keep_eos(arrs: list[np.ndarray], eos: int) -> list[np.ndarray]:
        return [
            a if len(a) <= sequence_length
            else np.concatenate([a[: sequence_length - 1], [eos]]).astype(np.int32)
            for a in arrs
        ]

    tsrc = truncate_keep_eos(_encode_and_frame(test_src, src_tok), src_tok.eos_id)
    ttgt = truncate_keep_eos(_encode_and_frame(test_tgt, tgt_tok), tgt_tok.eos_id)
    return Seq2SeqDataset(
        tsrc, ttgt, batch_size=batch_size,
        src_len=min(_round_up(max(len(a) for a in tsrc)), sequence_length),
        tgt_len=min(_round_up(max(len(a) for a in ttgt)), sequence_length),
        shuffle=False, drop_remainder=False,
    )
