"""Model-quality evaluation: corpus BLEU over parallel text, perplexity
over LM text.

Port of ``read_lines``, ``bleu_on_pairs``, ``bleu_on_test_files`` and
``perplexity_on_lines`` from ``transformer_tpu/train/evaluate.py``:
decode every source sentence in fixed-size batches through ``translate``
and score the detokenized hypotheses with ``utils.bleu.corpus_bleu``; or
score BOS-led, EOS-terminated lines under a decoder-only LM.
"""

from __future__ import annotations

import glob
import math
import os
from typing import Callable

import torch

from transformer_tpu_torch.config import ModelConfig
from transformer_tpu_torch.train.decode import translate
from transformer_tpu_torch.utils.bleu import corpus_bleu


def read_lines(path: str) -> list[str]:
    with open(path, encoding="utf-8") as f:
        return [line.rstrip("\n") for line in f]


def bleu_on_pairs(
    params,
    model_cfg: ModelConfig,
    src_tok,
    tgt_tok,
    src_lines: list[str],
    ref_lines: list[str],
    *,
    batch_size: int = 64,
    max_len: int = 64,
    src_len: int | None = None,
    beam_size: int = 1,
    log_fn: Callable[[str], None] | None = None,
) -> tuple[float, list[str]]:
    """(BLEU in [0, 100], hypotheses). Over-long sources are clipped to the
    positional table (EOS-terminated)."""
    if len(src_lines) != len(ref_lines):
        raise ValueError(
            f"src/ref line counts differ: {len(src_lines)} != {len(ref_lines)}"
        )
    hyps: list[str] = []
    for start in range(0, len(src_lines), batch_size):
        chunk = src_lines[start : start + batch_size]
        hyps.extend(
            translate(
                params, model_cfg, src_tok, tgt_tok, chunk, max_len=max_len,
                src_len=src_len, beam_size=beam_size, truncate=True,
            )
        )
        if log_fn is not None and start // batch_size % 4 == 0:
            log_fn(f"bleu eval: {start + len(chunk)}/{len(src_lines)} decoded")
    return corpus_bleu(ref_lines, hyps), hyps


@torch.no_grad()
def perplexity_on_lines(
    params,
    model_cfg: ModelConfig,
    tok,
    lines: list[str],
    *,
    batch_size: int = 64,
    log_fn: Callable[[str], None] | None = None,
) -> tuple[float, int]:
    """(perplexity, token count) of a decoder-only LM over text lines: each
    line a BOS-led, EOS-terminated window clipped to ``max_position``,
    rows padded to power-of-two widths; exp of the corpus mean CE over the
    non-PAD target positions."""
    from transformer_tpu_torch.models.transformer import transformer_apply
    from transformer_tpu_torch.train.decode import _bucket, _pad_batch
    from transformer_tpu_torch.train.loss import masked_cross_entropy

    if not model_cfg.decoder_only:
        raise ValueError("perplexity_on_lines is for decoder_only models")
    if not lines:
        raise ValueError("perplexity_on_lines got no input lines")
    device = params["decoder"]["embedding"]["table"].device
    cap = model_cfg.max_position
    encoded = [[tok.bos_id, *tok.encode(line), tok.eos_id][: cap + 1] for line in lines]
    total_ls = total_w = 0.0
    for start in range(0, len(encoded), batch_size):
        chunk = encoded[start : start + batch_size]
        ids, _ = _pad_batch(chunk, _bucket(max(len(e) for e in chunk), cap + 1, floor=8))
        ids = torch.from_numpy(ids).to(device=device, dtype=torch.long)
        logits = transformer_apply(params, None, ids[:, :-1], model_cfg)
        _, m = masked_cross_entropy(logits, ids[:, 1:])
        total_ls += float(m["loss_sum"])
        total_w += float(m["weight"])
        if log_fn is not None and start // batch_size % 4 == 0:
            log_fn(f"perplexity eval: {start + len(chunk)}/{len(encoded)} scored")
    return math.exp(total_ls / max(total_w, 1.0)), int(total_w)


def bleu_on_test_files(
    params,
    model_cfg: ModelConfig,
    src_tok,
    tgt_tok,
    dataset_path: str,
    *,
    batch_size: int = 64,
    max_len: int = 64,
    limit: int = 0,
    log_fn: Callable[[str], None] | None = None,
) -> tuple[float, int] | None:
    """BLEU of the ``{src,tgt}-test*.txt`` split under ``dataset_path``
    (its first ``limit`` pairs when ``limit``): (bleu, n_pairs), or None
    when there is no test split."""
    src_tests = sorted(glob.glob(os.path.join(dataset_path, "src-test*.txt")))
    tgt_tests = sorted(glob.glob(os.path.join(dataset_path, "tgt-test*.txt")))
    if not src_tests or not tgt_tests:
        if log_fn is not None:
            log_fn(f"no test split under {dataset_path}; skipping BLEU")
        return None
    src_lines = [line for p in src_tests for line in read_lines(p)]
    ref_lines = [line for p in tgt_tests for line in read_lines(p)]
    if limit:
        src_lines, ref_lines = src_lines[:limit], ref_lines[:limit]
    bleu, _ = bleu_on_pairs(
        params, model_cfg, src_tok, tgt_tok, src_lines, ref_lines,
        batch_size=batch_size, max_len=max_len, log_fn=log_fn,
    )
    if log_fn is not None:
        log_fn(f"test BLEU {bleu:.2f} on {len(src_lines)} pairs")
    return bleu, len(src_lines)
