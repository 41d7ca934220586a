"""Loader for tfds-format ``.subwords`` vocab files
(``tfds.deprecated.text.SubwordTextEncoder`` — the reference's tokenizer,
``utils.py:96-111``): a copy of ``transformer_tpu/data/tfds_compat.py``,
whose ids, strings and saved files it equals (``tests/test_torch_tfds_compat.py``).

The point is BLEU comparability (SURVEY §7 hard part d): a run of the
reference under real TF persists its vocabulary via
``SubwordTextEncoder.save_to_file`` (``utils.py:100,104``); loading that file
here lets this framework train/decode in the SAME id space, so quality
comparisons share a vocabulary instead of comparing across two different
subword inductions.

Implemented from the t2t/tfds subword-text-encoder conventions:

- **File format**: ``### SubwordTextEncoder`` header line (+ optional
  ``### Metadata: ...`` lines), then one subword per line wrapped in single
  quotes, with ``\\`` and ``\n`` backslash-escaped.
- **Id space**: 0 = pad; 1..len(subwords) = subwords, in file order;
  len(subwords)+1 .. len(subwords)+256 = raw bytes 0..255 (fallback);
  ``vocab_size`` = 1 + len(subwords) + 256. BOS/EOS stay OUTSIDE the vocab
  as ``vocab_size`` / ``vocab_size + 1``, exactly like the reference pipeline
  (``utils.py:137-143``) and this repo's own tokenizer.
- **Tokenization**: text splits into maximal runs of alphanumeric vs
  non-alphanumeric characters; a single space between two alphanumeric runs
  is dropped (it is re-inserted by decode's join rule).
- **Token escaping**: within a token, ``\\`` -> ``\\\\``, ``_`` -> ``\\u``,
  characters outside the subword alphabet -> ``\\<ord>;``; an ``_`` is
  appended as the end-of-token marker. Subwords greedily longest-prefix
  match the escaped token; anything unmatched falls back to byte ids.

Caveat, stated honestly: tfds is not installed in this environment, so the
implementation is reconstructed from the documented/source conventions and
pinned by round-trip fixtures (the JAX package's tests/test_data.py
TestTfdsCompat, whose vocabulary the port's tests share), not by
diffing against a live tfds encoder. Id-space layout and file parsing are
the load-bearing parts for comparability and are exact per the format above.
"""

from __future__ import annotations

from collections.abc import Iterable

_HEADER = "### SubwordTextEncoder"
_UNDERSCORE = "_"


def _is_alnum(ch: str) -> bool:
    return ch.isalnum()


def _tokenize(text: str) -> list[str]:
    """Alternating alnum / non-alnum runs; single inter-word spaces dropped."""
    if not text:
        return []
    tokens: list[str] = []
    start = 0
    alnum = [_is_alnum(c) for c in text]
    for pos in range(1, len(text)):
        if alnum[pos] != alnum[pos - 1]:
            tok = text[start:pos]
            if tok != " " or start == 0:
                tokens.append(tok)
            start = pos
    tokens.append(text[start:])
    return tokens


def _join_tokens(tokens: list[str]) -> str:
    """Inverse of _tokenize: re-insert the single space between two
    alphanumeric-adjacent tokens."""
    out: list[str] = []
    prev_alnum = False
    for i, tok in enumerate(tokens):
        if not tok:
            continue
        cur_alnum = _is_alnum(tok[0])
        if i > 0 and prev_alnum and cur_alnum:
            out.append(" ")
        out.append(tok)
        prev_alnum = _is_alnum(tok[-1])
    return "".join(out)


class TfdsSubwordTokenizer:
    """Duck-type of ``SubwordTokenizer`` (encode/decode/vocab_size/bos_id/
    eos_id/model_vocab_size) over a tfds-format vocabulary."""

    def __init__(self, subwords: list[str]):
        if not subwords:
            raise ValueError("empty tfds subword vocabulary")
        self.subwords = list(subwords)
        self._piece_to_id = {s: i + 1 for i, s in enumerate(self.subwords)}
        self._max_len = max(len(s) for s in self.subwords)
        self._byte_base = 1 + len(self.subwords)  # id of byte 0
        # Alphabet: every character appearing in any subword, plus the escape
        # machinery characters — tfds guarantees those are always in its
        # alphabet (its build adds "\\_u;0123456789" unconditionally), and
        # without them the escape sequences emitted below would themselves
        # get re-escaped. Characters outside the alphabet escape to
        # "\<ord>;" during encode (the tfds rule).
        self._alphabet = {c for s in self.subwords for c in s}
        self._alphabet.update("\\_u;0123456789")
        # token -> ids memo: encode() runs per corpus line on the data hot
        # path and natural-language tokens repeat heavily (real tfds
        # memoizes for the same reason).
        self._token_cache: dict[str, list[int]] = {}

    # ------------------------------------------------------------------ sizes
    @property
    def vocab_size(self) -> int:
        return 1 + len(self.subwords) + 256  # pad + subwords + byte fallback

    @property
    def bos_id(self) -> int:
        return self.vocab_size  # reference convention, utils.py:139

    @property
    def eos_id(self) -> int:
        return self.vocab_size + 1

    @property
    def model_vocab_size(self) -> int:
        return self.vocab_size + 2

    # ----------------------------------------------------------------- encode
    def _escape_token(self, token: str) -> str:
        # tfds rule verbatim: backslash/underscore get backslash-escapes
        # first, then any char outside the alphabet (and always newline)
        # becomes "\<ord>;". The escape chars themselves are alphabet
        # members by construction, so they pass through literally.
        body = [
            c if (c in self._alphabet and c != "\n") else f"\\{ord(c)};"
            for c in token.replace("\\", "\\\\").replace(_UNDERSCORE, "\\u")
        ]
        return "".join(body) + _UNDERSCORE

    def _unescape_token(self, escaped: str) -> str:
        out: list[str] = []
        i = 0
        while i < len(escaped):
            c = escaped[i]
            if c == "\\" and i + 1 < len(escaped):
                nxt = escaped[i + 1]
                if nxt == "u":
                    out.append(_UNDERSCORE)
                    i += 2
                    continue
                if nxt == "\\":
                    out.append("\\")
                    i += 2
                    continue
                if nxt.isdigit():
                    j = i + 1
                    while j < len(escaped) and escaped[j].isdigit():
                        j += 1
                    if j < len(escaped) and escaped[j] == ";":
                        out.append(chr(int(escaped[i + 1 : j])))
                        i = j + 1
                        continue
            out.append(c)
            i += 1
        return "".join(out)

    def _token_to_ids(self, token: str) -> list[int]:
        escaped = self._escape_token(token)
        ids: list[int] = []
        pos = 0
        n = len(escaped)
        while pos < n:
            end = min(n, pos + self._max_len)
            match = None
            for j in range(end, pos, -1):
                tid = self._piece_to_id.get(escaped[pos:j])
                if tid is not None:
                    match = tid
                    pos = j
                    break
            if match is not None:
                ids.append(match)
            else:
                # Byte fallback for a character no subword covers.
                for b in escaped[pos].encode("utf-8"):
                    ids.append(self._byte_base + b)
                pos += 1
        return ids

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for token in _tokenize(text):
            cached = self._token_cache.get(token)
            if cached is None:
                cached = self._token_to_ids(token)
                if len(self._token_cache) < 1_000_000:  # bound the memo
                    self._token_cache[token] = cached
            ids.extend(cached)
        return ids

    # ----------------------------------------------------------------- decode
    def decode(self, ids: Iterable[int]) -> str:
        pieces: list[str] = []
        byte_buf: list[int] = []

        def flush_bytes() -> None:
            if byte_buf:
                pieces.append(bytes(byte_buf).decode("utf-8", errors="replace"))
                byte_buf.clear()

        for tid in ids:
            tid = int(tid)
            if 1 <= tid <= len(self.subwords):
                flush_bytes()
                pieces.append(self.subwords[tid - 1])
            elif self._byte_base <= tid < self._byte_base + 256:
                byte_buf.append(tid - self._byte_base)
            # pad / BOS / EOS / out-of-range: dropped
        flush_bytes()
        concatenated = "".join(pieces)
        # "_" marks token ends; split, unescape each token, re-join.
        tokens = [
            self._unescape_token(t) for t in concatenated.split(_UNDERSCORE)
        ]
        return _join_tokens([t for t in tokens if t])

    def __len__(self) -> int:
        return self.vocab_size

    # ------------------------------------------------------------- file format
    @classmethod
    def load(cls, path: str) -> "TfdsSubwordTokenizer":
        with open(path, encoding="utf-8") as f:
            first = f.readline().rstrip("\n")
            if not first.startswith(_HEADER):
                raise ValueError(
                    f"{path}: not a tfds SubwordTextEncoder vocab file "
                    f"(header {first[:40]!r})"
                )
            subwords: list[str] = []
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("### "):
                    continue  # metadata lines
                if len(line) >= 2 and line[0] == "'" and line[-1] == "'":
                    line = line[1:-1]
                subwords.append(
                    line.replace("\\n", "\n").replace("\\\\", "\\")
                )
        return cls(subwords)

    def save(self, path: str) -> None:
        """Write back in tfds format (round-trip support for fixtures)."""
        import os

        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(_HEADER + "\n")
            f.write("### Metadata: {}\n")
            for s in self.subwords:
                f.write(
                    "'" + s.replace("\\", "\\\\").replace("\n", "\\n") + "'\n"
                )
        os.replace(tmp, path)


