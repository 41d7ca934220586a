"""Streaming input pipeline: bounded-memory training on corpora that do not
fit in host RAM. A copy of ``transformer_tpu/data/streaming.py``, whose
batches it equals element for element (``tests/test_torch_streaming.py``).

The in-memory path (``data/pipeline.py Seq2SeqDataset``) tokenizes the whole
corpus up front — the right call for the bundled 10k-pair corpus, and the one
capability gap vs the reference, whose ``TextLineDataset`` streams from disk
(``utils.py:77-80``) with a bounded shuffle buffer (``utils.py:154``,
``--buffer_size``). This module closes that gap TPU-side:

- **Line streams, chunked decode.** src/tgt files are read line-by-line and
  tokenized on the fly; no list of all examples ever exists.
- **Reservoir-style shuffle buffer** with the reference's semantics: a
  ``buffer_size``-example buffer is filled from the stream; each emitted
  example is drawn uniformly from the buffer and its slot refilled from the
  stream — exactly ``tf.data.Dataset.shuffle(buffer_size)``, but
  deterministic per ``(seed, epoch)`` (NumPy Philox keyed on both), so every
  host computes the same global batch sequence and slices its own rows.
- **Memory bound is structural**: peak example storage is ``buffer_size``
  (``peak_buffer_examples``, read by the tests), independent of corpus size.

Static shapes, PAD/BOS/EOS framing, the train-side length filter, and the
multi-host slice convention all match ``Seq2SeqDataset`` — the trainer
cannot tell the two apart (same ``.batches(epoch)`` / ``.num_examples``
surface).
"""

from __future__ import annotations

from collections.abc import Iterator

import numpy as np

from transformer_tpu_torch.config import PAD_ID
from transformer_tpu_torch.data.seeding import epoch_rng
from transformer_tpu_torch.data.tokenizer import SubwordTokenizer


def _line_pairs(
    src_files: list[str], tgt_files: list[str]
) -> Iterator[tuple[str, str]]:
    """Zip the src/tgt line streams file by file; a length mismatch is an
    error at the point it is discovered (the in-memory reader checks the
    same invariant after reading everything). zip_longest rather than zip:
    plain zip consumes one extra line from the longer stream before noticing
    exhaustion, which would hide an off-by-one corpus corruption."""
    from itertools import zip_longest

    for sf, tf in zip_longest(src_files, tgt_files):
        if sf is None or tf is None:
            raise ValueError(
                f"parallel corpus file-count mismatch: {src_files} vs {tgt_files}"
            )
        with open(sf, encoding="utf-8") as fs, open(tf, encoding="utf-8") as ft:
            for s_line, t_line in zip_longest(fs, ft):
                if s_line is None or t_line is None:
                    raise ValueError(
                        f"parallel corpus length mismatch between {sf} and {tf}"
                    )
                yield s_line.rstrip("\n"), t_line.rstrip("\n")


class StreamingSeq2SeqDataset:
    """Disk-streaming counterpart of ``Seq2SeqDataset``: fixed-shape (B, L)
    int32 batches from corpora of unbounded size with O(buffer_size) host
    memory.

    Tokenizers must already exist (build them once with
    ``load_or_build_tokenizer`` — vocabulary construction needs its own
    corpus pass and is out of scope for the steady-state stream).
    """

    def __init__(
        self,
        dataset_path: str,
        src_tok: SubwordTokenizer,
        tgt_tok: SubwordTokenizer,
        batch_size: int,
        sequence_length: int,
        split: str = "train",
        buffer_size: int = 10000,
        seed: int = 0,
        shard_index: int = 0,
        shard_count: int = 1,
        shuffle: bool = True,
        drop_remainder: bool = True,
        length_filter: bool = True,
        exclude_pairs: set[tuple[str, str]] | None = None,
    ) -> None:
        if batch_size % shard_count:
            raise ValueError(
                f"global batch size {batch_size} not divisible by "
                f"shard count {shard_count}"
            )
        if buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, got {buffer_size}")
        from transformer_tpu_torch.data.pipeline import corpus_files

        self.src_files, self.tgt_files = corpus_files(dataset_path, split)
        self.src_tok = src_tok
        self.tgt_tok = tgt_tok
        self.batch_size = batch_size
        self.src_len = sequence_length
        self.tgt_len = sequence_length
        self.buffer_size = buffer_size
        self.seed = seed
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.length_filter = length_filter
        self.exclude_pairs = exclude_pairs or set()
        self._num_lines: int | None = None
        # High-water marks over the last epoch: examples resident at once
        # (the shuffle buffer + one forming batch), and in the buffer alone
        # (at most buffer_size) — the structural memory bound this class
        # exists to provide.
        self.peak_resident_examples = 0
        self.peak_buffer_examples = 0

    @property
    def num_examples(self) -> int:
        """Raw line-pair count (pre length-filter — counting post-filter
        examples would need a full tokenization pass). One cheap line scan,
        cached."""
        if self._num_lines is None:
            n = 0
            for sf in self.src_files:
                with open(sf, encoding="utf-8") as f:
                    n += sum(1 for _ in f)
            self._num_lines = n
        return self._num_lines

    def _example_stream(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        s_bos, s_eos = self.src_tok.bos_id, self.src_tok.eos_id
        t_bos, t_eos = self.tgt_tok.bos_id, self.tgt_tok.eos_id
        for s_line, t_line in _line_pairs(self.src_files, self.tgt_files):
            if (s_line, t_line) in self.exclude_pairs:
                continue
            s = np.asarray(
                [s_bos, *self.src_tok.encode(s_line), s_eos], dtype=np.int32
            )
            t = np.asarray(
                [t_bos, *self.tgt_tok.encode(t_line), t_eos], dtype=np.int32
            )
            if self.length_filter and (
                len(s) > self.src_len or len(t) > self.tgt_len
            ):
                continue  # the reference's train filter, utils.py:145-147
            yield s, t

    def batches(self, epoch: int = 0) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        rng = epoch_rng(self.seed, epoch)
        local = self.batch_size // self.shard_count
        lo = self.shard_index * local

        def emit(batch):
            rows = batch[lo : lo + local]
            src = np.full((local, self.src_len), PAD_ID, dtype=np.int32)
            tgt = np.full((local, self.tgt_len), PAD_ID, dtype=np.int32)
            for r, (s, t) in enumerate(rows):
                src[r, : len(s)] = s
                tgt[r, : len(t)] = t
            return src, tgt

        buf_len = [0]  # live buffer size, for the resident high-water mark

        def drawn() -> Iterator[tuple[np.ndarray, np.ndarray]]:
            """The example sequence after (optional) buffered shuffling."""
            stream = self._example_stream()
            if not self.shuffle:
                # No buffer at all: slot-replacement would reorder a FIFO.
                yield from stream
                return
            buf: list[tuple[np.ndarray, np.ndarray]] = []
            for ex in stream:
                buf.append(ex)
                if len(buf) >= self.buffer_size:
                    break
            while buf:
                buf_len[0] = len(buf)
                j = int(rng.integers(len(buf)))
                out = buf[j]
                nxt = next(stream, None)
                if nxt is not None:
                    buf[j] = nxt
                else:
                    buf[j] = buf[-1]
                    buf.pop()
                yield out

        batch: list[tuple[np.ndarray, np.ndarray]] = []
        peak = peak_buffer = 0
        for ex in drawn():
            batch.append(ex)
            peak = max(peak, buf_len[0] + len(batch))
            peak_buffer = max(peak_buffer, buf_len[0])
            if len(batch) == self.batch_size:
                yield emit(batch)
                batch = []
        if batch and not self.drop_remainder:
            # Same tail convention as Seq2SeqDataset: pad to the full batch
            # with all-PAD rows (zero metric weight) so every shard emits
            # the same batch count.
            pad_row = (
                np.zeros(0, dtype=np.int32),
                np.zeros(0, dtype=np.int32),
            )
            batch.extend(pad_row for _ in range(self.batch_size - len(batch)))
            yield emit(batch)
        self.peak_resident_examples = peak
        self.peak_buffer_examples = peak_buffer
