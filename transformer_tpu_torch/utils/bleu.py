"""Corpus BLEU (Papineni et al. 2002), the translation metric of the
seq2seq slice.

The port's own copy of ``transformer_tpu/utils/bleu.py``: geometric mean
of the modified n-gram precisions (n <= 4) with the brevity penalty and
optional +1 smoothing of the higher orders (Lin & Och). The same strings
give the same float.
"""

from __future__ import annotations

import math
from collections import Counter


def _ngrams(tokens: list[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def corpus_bleu(
    references: list[str] | list[list[str]],
    hypotheses: list[str] | list[list[str]],
    max_n: int = 4,
    smooth: bool = True,
) -> float:
    """BLEU in [0, 100], one reference per hypothesis; strings are split
    on whitespace."""
    if len(references) != len(hypotheses):
        raise ValueError("references and hypotheses must align")
    clipped = [0] * max_n
    totals = [0] * max_n
    ref_len = hyp_len = 0
    for ref, hyp in zip(references, hypotheses):
        ref_t = ref.split() if isinstance(ref, str) else list(ref)
        hyp_t = hyp.split() if isinstance(hyp, str) else list(hyp)
        ref_len += len(ref_t)
        hyp_len += len(hyp_t)
        for n in range(1, max_n + 1):
            hyp_ng = _ngrams(hyp_t, n)
            ref_ng = _ngrams(ref_t, n)
            totals[n - 1] += max(len(hyp_t) - n + 1, 0)
            clipped[n - 1] += sum(min(c, ref_ng[g]) for g, c in hyp_ng.items())
    if hyp_len == 0:
        return 0.0
    log_p = 0.0
    for n in range(max_n):
        c, t = clipped[n], totals[n]
        if smooth and n > 0:
            c, t = c + 1, t + 1
        if c == 0 or t == 0:
            return 0.0
        log_p += math.log(c / t)
    log_p /= max_n
    bp = 1.0 if hyp_len > ref_len else math.exp(1.0 - ref_len / max(hyp_len, 1))
    return 100.0 * bp * math.exp(log_p)
