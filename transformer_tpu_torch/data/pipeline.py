"""Host-side input pipeline: parallel-corpus pairs and LM windows.

Port of ``transformer_tpu/data/pipeline.py``: the parallel-corpus
reader, the tokenizer build-or-load (tfds-format vocab files included),
the seq2seq dataset of ``load_dataset`` (BOS/EOS framing, the filter
that drops a train pair with either side longer than
``sequence_length``, ``exclude_test_overlap``, the test split cut to
fit), the causal-LM dataset (the corpus as one EOS-separated token
stream cut into BOS-prefixed windows) and ``Seq2SeqDataset``'s batchers:
in memory, flat or in length buckets, with the (seed, epoch)-keyed numpy
shuffle; or, with ``prefetch``, the C++ loader (``native/``), whose
splitmix64 order is the JAX package's default batch order (its
``--native_loader``). ``streaming=True`` reads the train split from disk
through a shuffle buffer (``data/streaming.py``). Batches are numpy int32
arrays equal to the JAX package's, element for element, path for path.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import warnings
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
):  # -> SubwordTokenizer | tfds_compat.TfdsSubwordTokenizer
    """Load a persisted vocab (a tfds ``SubwordTextEncoder`` file comes back
    as a ``TfdsSubwordTokenizer``), else train one from ``corpus`` and save
    it."""
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
    """In-memory dataset yielding (B, L) int32 (src, tgt) batches: the
    batcher of the JAX twin. ``drop_remainder=False`` pads the last batch
    with empty rows (index -1), which come out all PAD and carry no metric
    weight.

    ``length_buckets``: an ascending tuple of widths, the last at most the
    dataset's width. Each example lands in the smallest bucket that fits
    ``max(len(src), len(tgt))``; batches form within a bucket, pad to its
    width on both sides, and come in a (seed, epoch)-shuffled order across
    buckets, so one epoch mixes widths. Short sentences stop paying for the
    full width, and the step takes one shape per bucket (one CUDA graph
    each under ``steps_per_dispatch``). () = one fixed width.

    ``prefetch``: batches come from the C++ loader (``native/``), a worker
    thread filling a ring of batches ahead of the consumer, in its own
    splitmix64 Fisher-Yates order per (seed, epoch) (buckets: members,
    then the plan) — the JAX package's ``--native_loader`` order, not the
    numpy one; the unshuffled order and the padding are the same. Without
    the library it warns and keeps the numpy order."""

    src: list[np.ndarray]
    tgt: list[np.ndarray]
    batch_size: int
    src_len: int
    tgt_len: int
    shuffle: bool = True
    seed: int = 0
    drop_remainder: bool = True
    length_buckets: tuple[int, ...] = ()
    prefetch: bool = False
    _native: object = dataclasses.field(default=None, init=False, repr=False, compare=False)

    def __post_init__(self) -> None:
        if len(self.src) != len(self.tgt):
            raise ValueError("src/tgt example count mismatch")
        if self.length_buckets:
            self.length_buckets = tuple(sorted(self.length_buckets))
            if self.length_buckets[-1] > max(self.src_len, self.tgt_len):
                raise ValueError(
                    f"largest bucket {self.length_buckets[-1]} exceeds the "
                    f"dataset width {max(self.src_len, self.tgt_len)}"
                )
            lengths = np.asarray([max(len(s), len(t)) for s, t in zip(self.src, self.tgt)])
            if lengths.size and int(lengths.max()) > self.length_buckets[-1]:
                # Refused rather than cut: cutting would drop sentences' EOS.
                n_over = int((lengths > self.length_buckets[-1]).sum())
                raise ValueError(
                    f"{n_over} examples exceed the largest length bucket "
                    f"{self.length_buckets[-1]} (longest is {int(lengths.max())}); make "
                    "the last bucket as wide as the length filter (sequence_length)"
                )
            which = np.searchsorted(np.asarray(self.length_buckets), lengths)
            self._bucket_members = [
                np.flatnonzero(which == b) for b in range(len(self.length_buckets))
            ]

    def _batches_per_bucket(self, n: int) -> int:
        full, rem = divmod(n, self.batch_size)
        return full + (1 if rem and not self.drop_remainder else 0)

    def __len__(self) -> int:
        if self.length_buckets:
            return sum(self._batches_per_bucket(len(m)) for m in self._bucket_members)
        return self._batches_per_bucket(len(self.src))

    @property
    def num_examples(self) -> int:
        return len(self.src)

    def _fill(self, idx: np.ndarray) -> np.ndarray:
        if len(idx) < self.batch_size:
            fill = np.full(self.batch_size - len(idx), -1, dtype=np.int64)
            idx = np.concatenate([idx, fill])
        return idx

    def native_loader(self):
        """The C++ loader of these examples (built at first use), or None
        without the library."""
        if self._native is None:
            from transformer_tpu_torch import native

            self._native = native.NativeBatchLoader.create(
                self.src, self.tgt, self.batch_size, self.batch_size, 0, self.src_len,
                self.tgt_len, pad_id=PAD_ID, length_buckets=self.length_buckets,
            ) or False
        return self._native or None

    def batches(self, epoch: int = 0) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        if self.prefetch:
            loader = self.native_loader()
            if loader is not None:
                seed = (self.seed * 0x9E3779B97F4A7C15 + epoch) & (2**64 - 1)
                yield from loader.epoch(seed, self.shuffle, self.drop_remainder)
                return
            warnings.warn(
                "prefetch requested but the native loader is unavailable; "
                "falling back to the Python batcher. Its batch order is the "
                "prefetch=False path's, which differs from the native loader's "
                "shuffle, so a run changes its batch sequence, and with several "
                "processes EVERY process must take the same path (all native or "
                "all fallback) or their global batches desynchronize",
                RuntimeWarning,
                stacklevel=2,
            )
        yield from self._python_batches(epoch)

    def _python_batches(self, epoch: int) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """The in-memory numpy batcher, flat or bucketed."""
        if self.length_buckets:
            yield from self._bucketed_batches(epoch)
            return
        order = np.arange(len(self.src))
        if self.shuffle:
            epoch_rng(self.seed, epoch).shuffle(order)
        stop = len(order) - (self.batch_size - 1 if self.drop_remainder else 0)
        for start in range(0, stop, self.batch_size):
            yield self._pad(self._fill(order[start : start + self.batch_size]))

    def _bucketed_batches(self, epoch: int) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Batches formed inside each bucket (members permuted per bucket),
        then the plan of (width, rows) shuffled across buckets, both from
        the one (seed, epoch) generator, in the JAX twin's order of draws."""
        rng = epoch_rng(self.seed, epoch)
        plan: list[tuple[int, np.ndarray]] = []
        for b, members in enumerate(self._bucket_members):
            perm = members[rng.permutation(len(members))] if self.shuffle else members
            for k in range(self._batches_per_bucket(len(perm))):
                rows = self._fill(perm[k * self.batch_size : (k + 1) * self.batch_size])
                plan.append((self.length_buckets[b], rows))
        if self.shuffle:
            rng.shuffle(plan)
        for width, rows in plan:
            yield self._pad(rows, width, width)

    def _pad(
        self, idx: np.ndarray, src_len: int | None = None, tgt_len: int | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        src_len = self.src_len if src_len is None else src_len
        tgt_len = self.tgt_len if tgt_len is None else tgt_len
        src = np.full((len(idx), src_len), PAD_ID, dtype=np.int32)
        tgt = np.full((len(idx), tgt_len), PAD_ID, dtype=np.int32)
        for row, i in enumerate(idx):
            if i < 0:
                continue  # padding row
            s = self.src[i][:src_len]
            t = self.tgt[i][:tgt_len]
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
    exclude_test_overlap: bool = False,
    streaming: bool = False,
    buffer_size: int = 10000,
) -> tuple[Seq2SeqDataset, Seq2SeqDataset | None, SubwordTokenizer, SubwordTokenizer]:
    """Seq2seq train (+ test, when the split exists) datasets and both
    tokenizers, built from (or saved to) the vocab files. Train pairs with
    either side longer than ``sequence_length`` after BOS/EOS framing are
    dropped; ``length_buckets`` batches the train split in buckets and
    ``prefetch`` through the C++ loader (``Seq2SeqDataset``).

    ``exclude_test_overlap`` drops every train pair whose exact (src, tgt)
    line pair also appears in the test split (the bundled test split is
    drawn from the train corpus, so BLEU on it is otherwise in-sample). The
    vocabularies are still built from the whole train files, so the
    ``*.subwords`` files are the same either way.

    ``streaming=True`` makes the train split a
    ``data.streaming.StreamingSeq2SeqDataset``: read and tokenized line by
    line through a ``buffer_size``-example shuffle buffer (the reference's
    ``--buffer_size``), so host memory stays O(buffer_size). It needs the
    vocab files to exist and composes with neither ``prefetch`` nor
    ``length_buckets``, which need the in-memory example table (the JAX
    package's refusals). The test split stays in memory."""
    if streaming:
        if prefetch or length_buckets:
            raise ValueError(
                "streaming=True does not compose with prefetch or "
                "length_buckets (the native loader and bucket planner need "
                "the in-memory example table)"
            )
        if not (os.path.exists(src_vocab_file) and os.path.exists(tgt_vocab_file)):
            raise FileNotFoundError(
                "streaming=True needs pre-built vocab files "
                f"({src_vocab_file!r}, {tgt_vocab_file!r}): vocabulary "
                "construction requires its own corpus pass — run once "
                "without streaming (or build vocabs from a sample) first"
            )
        from transformer_tpu_torch.data.streaming import StreamingSeq2SeqDataset

        src_tok = SubwordTokenizer.load(src_vocab_file)
        tgt_tok = SubwordTokenizer.load(tgt_vocab_file)
        held: set[tuple[str, str]] = set()
        if exclude_test_overlap:
            try:
                held = set(zip(*read_parallel_corpus(dataset_path, "test")))
            except FileNotFoundError:
                pass
        train = StreamingSeq2SeqDataset(
            dataset_path, src_tok, tgt_tok, batch_size=batch_size,
            sequence_length=sequence_length, buffer_size=buffer_size, seed=seed,
            exclude_pairs=held,
        )
        test = _build_test_split(dataset_path, src_tok, tgt_tok, batch_size, sequence_length)
        return train, test, src_tok, tgt_tok
    src_lines, tgt_lines = read_parallel_corpus(dataset_path, "train")
    src_tok = load_or_build_tokenizer(src_vocab_file, src_lines, target_vocab_size)
    tgt_tok = load_or_build_tokenizer(tgt_vocab_file, tgt_lines, target_vocab_size)
    if exclude_test_overlap:
        try:
            held = set(zip(*read_parallel_corpus(dataset_path, "test")))
        except FileNotFoundError:
            held = set()
        if held:
            pairs = [(s, t) for s, t in zip(src_lines, tgt_lines) if (s, t) not in held]
            src_lines, tgt_lines = [s for s, _ in pairs], [t for _, t in pairs]
    src_ids = _encode_and_frame(src_lines, src_tok)
    tgt_ids = _encode_and_frame(tgt_lines, tgt_tok)
    keep = [
        i for i in range(len(src_ids))
        if len(src_ids[i]) <= sequence_length and len(tgt_ids[i]) <= sequence_length
    ]
    train = Seq2SeqDataset(
        [src_ids[i] for i in keep], [tgt_ids[i] for i in keep], batch_size=batch_size,
        src_len=sequence_length, tgt_len=sequence_length, shuffle=True, seed=seed,
        length_buckets=tuple(length_buckets), prefetch=prefetch,
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
