"""Subword tokenizer: BPE trained from a corpus, greedy longest-match encode.

A copy of ``transformer_tpu/data/tokenizer.py``, so vocab files and token
ids are interchangeable between the two packages. The encoder and the
BPE trainer run in C++ (``transformer_tpu_torch/native``) when its
library builds, else in Python; the two give the same pieces and ids.

- id 0 is reserved for padding (never produced by ``encode``);
- subword ids run 1..vocab_size;
- BOS/EOS are ``vocab_size`` / ``vocab_size + 1``, and models are built
  with ``vocab_size + 2`` embedding rows.

Each whitespace-separated word is encoded with a trailing ``"_"`` marker.
Characters never seen at training time fall back to byte-escape tokens
``<0xNN>``, which are always in the alphabet, so ``encode`` is total.
``SubwordTokenizer.load`` also reads the tfds ``SubwordTextEncoder``
files of the reference's runs, through ``data/tfds_compat.py``.
"""

from __future__ import annotations

import heapq
import os
from collections import Counter
from collections.abc import Iterable, Iterator

_WORD_END = "_"
_ESCAPED_UNDERSCORE = "\\u"  # literal underscore in text is escaped on encode
_ESCAPED_BACKSLASH = "\\\\"  # literal backslash likewise (escape the escape)
_ESCAPED_LT = "\\<"  # literal '<' escaped so text can never collide with the
# byte-fallback token namespace "<0xNN>" (decode would otherwise reinterpret
# literal text like "<0x41>" as byte 0x41)


def _escape_char(ch: str) -> str:
    if ch == "_":
        return _ESCAPED_UNDERSCORE
    if ch == "\\":
        return _ESCAPED_BACKSLASH
    if ch == "<":
        return _ESCAPED_LT
    return ch


def _word_to_symbols(word: str) -> list[str]:
    """Split a word into its initial symbol sequence: characters with literal
    underscores/backslashes escaped, plus the word-end marker."""
    return [_escape_char(ch) for ch in word] + [_WORD_END]


def _byte_token(b: int) -> str:
    return f"<0x{b:02X}>"


class SubwordTokenizer:
    """BPE subword tokenizer with save/load and greedy longest-match encode."""

    def __init__(self, subwords: list[str]):
        if not subwords:
            raise ValueError("empty vocabulary")
        self.subwords = list(subwords)
        # id 0 = pad; real tokens start at 1.
        self._piece_to_id = {piece: i + 1 for i, piece in enumerate(self.subwords)}
        if len(self._piece_to_id) != len(self.subwords):
            raise ValueError("duplicate subwords in vocabulary")
        self._max_piece_len = max(len(p) for p in self.subwords)
        self._native = None  # the C++ encoder, built at first use (False = none)

    # ------------------------------------------------------------------ sizes
    @property
    def vocab_size(self) -> int:
        """Number of real subwords + 1 (id 0 = pad), i.e. ids are
        0..vocab_size-1 — matching the reference's convention where model BOS
        is ``tokenizer.vocab_size`` (``utils.py:139``)."""
        return len(self.subwords) + 1

    @property
    def bos_id(self) -> int:
        return self.vocab_size

    @property
    def eos_id(self) -> int:
        return self.vocab_size + 1

    @property
    def model_vocab_size(self) -> int:
        """Embedding rows a model needs: all subword ids + pad + BOS + EOS
        (reference ``train.py:232-233``)."""
        return self.vocab_size + 2

    # ----------------------------------------------------------------- encode
    def _encode_symbols(self, symbols: list[str]) -> list[int]:
        """Greedy longest-match over the concatenated symbol string."""
        text = "".join(symbols)
        out: list[int] = []
        i, n = 0, len(text)
        while i < n:
            end = min(n, i + self._max_piece_len)
            match_id = None
            for j in range(end, i, -1):
                tid = self._piece_to_id.get(text[i:j])
                if tid is not None:
                    match_id = tid
                    i = j
                    break
            if match_id is None:
                # Byte fallback for unseen characters.
                for b in text[i].encode("utf-8"):
                    out.append(self._piece_to_id[_byte_token(b)])
                i += 1
            else:
                out.append(match_id)
        return out

    def _native_encoder(self):
        if self._native is None:
            # The C++ byte fallback needs every <0xNN> piece (it cannot raise
            # KeyError as the Python path does on an incomplete hand-built
            # vocabulary), so it serves full alphabets only.
            if all(_byte_token(b) in self._piece_to_id for b in range(256)):
                from transformer_tpu_torch import native

                self._native = native.NativeTokenizer.from_pieces(self.subwords) or False
            else:
                self._native = False
        return self._native or None

    def encode(self, text: str) -> list[int]:
        words = text.split()
        if not words:
            return []
        nat = self._native_encoder()
        if nat is not None:
            return nat.encode_words(words)
        ids: list[int] = []
        for word in words:
            ids.extend(self._encode_symbols(_word_to_symbols(word)))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        pieces: list[str] = []
        for tid in ids:
            if tid <= 0 or tid > len(self.subwords):
                continue  # pad / BOS / EOS / out-of-range: dropped
            pieces.append(self.subwords[tid - 1])
        text = "".join(pieces)
        # Undo byte-escapes first, then word-end markers and underscore escapes.
        out_bytes: list[int] = []
        result: list[str] = []
        i = 0
        while i < len(text):
            if text.startswith("<0x", i) and len(text) >= i + 6 and text[i + 5] == ">":
                out_bytes.append(int(text[i + 3 : i + 5], 16))
                i += 6
                continue
            if out_bytes:
                result.append(bytes(out_bytes).decode("utf-8", errors="replace"))
                out_bytes = []
            if text.startswith(_ESCAPED_BACKSLASH, i):
                result.append("\\")
                i += 2
            elif text.startswith(_ESCAPED_UNDERSCORE, i):
                result.append("_")
                i += 2
            elif text.startswith(_ESCAPED_LT, i):
                result.append("<")
                i += 2
            elif text[i] == _WORD_END:
                result.append(" ")
                i += 1
            else:
                result.append(text[i])
                i += 1
        if out_bytes:
            result.append(bytes(out_bytes).decode("utf-8", errors="replace"))
        return "".join(result).rstrip(" ")

    # ------------------------------------------------------------- train/save
    @classmethod
    def build_from_corpus(
        cls,
        corpus: Iterable[str],
        target_vocab_size: int = 2**15,
        min_pair_count: int = 2,
    ) -> "SubwordTokenizer":
        """Train BPE until ``target_vocab_size`` pieces (or until no pair
        occurs ``min_pair_count`` times). Incremental pair-count maintenance
        with a lazy max-heap — full recounts per merge would be quadratic and
        unusable at 2^15 on a 1-core host. The C++ trainer, whose pieces
        are the same, runs instead when its library builds."""
        word_freq: Counter[str] = Counter()
        for line in corpus:
            word_freq.update(line.split())

        from transformer_tpu_torch import native

        nat = native.NativeTokenizer.train(word_freq, target_vocab_size, min_pair_count)
        if nat is not None:
            return cls(nat.pieces())

        words: list[list[str]] = []
        freqs: list[int] = []
        for w, f in word_freq.items():
            words.append(_word_to_symbols(w))
            freqs.append(f)

        # Alphabet: 256 byte-fallback tokens + escape pieces + all seen symbols.
        alphabet: dict[str, None] = {_byte_token(b): None for b in range(256)}
        alphabet[_ESCAPED_UNDERSCORE] = None
        alphabet[_ESCAPED_BACKSLASH] = None
        alphabet[_ESCAPED_LT] = None
        alphabet[_WORD_END] = None
        for sym_seq in words:
            for s in sym_seq:
                alphabet[s] = None
        vocab: dict[str, None] = dict(alphabet)

        # pair -> total count; pair -> set of word indices containing it.
        pair_counts: Counter[tuple[str, str]] = Counter()
        pair_words: dict[tuple[str, str], set[int]] = {}
        for wi, sym_seq in enumerate(words):
            f = freqs[wi]
            for a, b in zip(sym_seq, sym_seq[1:]):
                pair_counts[(a, b)] += f
                pair_words.setdefault((a, b), set()).add(wi)

        heap: list[tuple[int, tuple[str, str]]] = [
            (-c, p) for p, c in pair_counts.items()
        ]
        heapq.heapify(heap)

        def bump(pair: tuple[str, str], delta: int, wi: int) -> None:
            c = pair_counts[pair] + delta
            if c <= 0:
                pair_counts.pop(pair, None)
            else:
                pair_counts[pair] = c
                heapq.heappush(heap, (-c, pair))
            s = pair_words.setdefault(pair, set())
            if delta > 0:
                s.add(wi)

        while len(vocab) < target_vocab_size and heap:
            neg_c, pair = heapq.heappop(heap)
            c = pair_counts.get(pair)
            if c is None or -neg_c != c:
                continue  # stale heap entry
            if c < min_pair_count:
                break
            merged = pair[0] + pair[1]
            vocab[merged] = None
            del pair_counts[pair]
            affected = pair_words.pop(pair, set())
            for wi in affected:
                sym_seq = words[wi]
                f = freqs[wi]
                out: list[str] = []
                i = 0
                changed = False
                while i < len(sym_seq):
                    if (
                        i + 1 < len(sym_seq)
                        and sym_seq[i] == pair[0]
                        and sym_seq[i + 1] == pair[1]
                    ):
                        # Update neighbour pair counts around the merge site.
                        if out:
                            bump((out[-1], pair[0]), -f, wi)
                            bump((out[-1], merged), f, wi)
                        if i + 2 < len(sym_seq):
                            nxt = sym_seq[i + 2]
                            bump((pair[1], nxt), -f, wi)
                            bump((merged, nxt), f, wi)
                        out.append(merged)
                        i += 2
                        changed = True
                    else:
                        out.append(sym_seq[i])
                        i += 1
                if changed:
                    words[wi] = out

        # Longer pieces first is not required (encode is longest-match via
        # scanning), but a stable, frequency-ish order keeps ids reproducible.
        return cls(list(vocab.keys()))

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write("transformer_tpu_subwords_v1\n")
            for piece in self.subwords:
                f.write(piece.encode("unicode_escape").decode("ascii") + "\n")
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str):
        """Load a vocab file written by ``save`` (either package's). A file
        in the tfds ``SubwordTextEncoder`` format (the reference's
        ``save_to_file``) is told by its header and comes back as a
        ``data.tfds_compat.TfdsSubwordTokenizer``, the same interface over
        the reference's id space."""
        with open(path, encoding="utf-8") as f:
            header = f.readline().rstrip("\n")
        if header.startswith("### SubwordTextEncoder"):
            from transformer_tpu_torch.data.tfds_compat import TfdsSubwordTokenizer

            return TfdsSubwordTokenizer.load(path)
        if header != "transformer_tpu_subwords_v1":
            raise ValueError(f"{path}: neither a transformer_tpu nor a tfds subword vocab file")
        with open(path, encoding="utf-8") as f:
            f.readline()  # header
            subwords = [
                line.rstrip("\n").encode("ascii").decode("unicode_escape")
                for line in f
                if line.rstrip("\n")
            ]
        return cls(subwords)

    def __len__(self) -> int:
        return self.vocab_size

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_native"] = None  # a ctypes handle does not pickle; rebuilt at first use
        return state


def iter_lines(*paths: str) -> Iterator[str]:
    for path in paths:
        with open(path, encoding="utf-8") as f:
            for line in f:
                yield line.rstrip("\n")
