"""Decoding: token picking, prompt bucketing, and seq2seq translation.

Port of ``sample_token``, ``_detokenize_rows``, ``prefill_len_for``,
``_dummy_rows``, ``greedy_decode``, ``beam_search_decode``, ``_bucket``,
``_pad_batch`` and ``translate`` from ``transformer_tpu/train/decode.py``.
Sampling draws from an explicit ``torch.Generator``; greedy picks are
argmax and need none. The JAX twin's early-exit ``while_loop`` is a
Python loop here that stops once every row (or beam) has finished; its
test reads one flag from the device per generated position. Beams pick
their K best candidates with a stable descending sort of the flattened
scores, so equal scores go to the lower flat index first, as
``lax.top_k`` orders them (``torch.topk`` promises no order among ties).
Decoding runs in one process: a model trained with a sequence-parallel
attention impl ("ring", "ulysses") encodes its source with the
whole-sequence flash kernels, which is what a ring of one process runs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from transformer_tpu_torch.config import PAD_ID, ModelConfig
from transformer_tpu_torch.models.decoder import init_decoder_caches, precompute_cross_kvs
from transformer_tpu_torch.models.encoder import encoder_apply
from transformer_tpu_torch.models.transformer import (
    transformer_decode_step,
    transformer_prefill,
)
from transformer_tpu_torch.ops.masks import make_padding_mask


def sample_token(
    logits: torch.Tensor,
    generator: torch.Generator | None = None,
    *,
    sample: bool = False,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """(B, V) logits -> (B,) int64 next-token ids. Greedy argmax (first
    maximal index, as jnp.argmax), or a draw from softmax(logits /
    temperature) truncated to the ``top_k`` most likely tokens and then to
    the nucleus reaching ``top_p``. The draw is Gumbel-max with uniform
    noise from ``generator`` (same distribution as jax.random.categorical;
    the random numbers differ)."""
    if not sample:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / max(float(temperature), 1e-6)
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, -torch.inf), logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        exclusive = torch.cumsum(probs, dim=-1) - probs
        kept = exclusive < top_p
        thresh = torch.where(
            kept, sorted_logits, torch.full_like(sorted_logits, torch.inf)
        ).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < thresh, torch.full_like(logits, -torch.inf), logits)
    u = torch.rand(
        logits.shape, generator=generator, device=logits.device, dtype=torch.float32
    )
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


def _detokenize_rows(out, n: int, tokenizer) -> list[str]:
    """Strip PAD/EOS from the first ``n`` rows and decode to text."""
    texts = []
    for row in out[:n]:
        toks = [int(t) for t in row if t not in (PAD_ID, tokenizer.eos_id)]
        texts.append(tokenizer.decode(toks))
    return texts


def prefill_len_for(prompt_len: int, chunk: int = 0) -> int:
    """How many prompt positions single-pass prefill takes: ``chunk`` times
    the largest power of two of whole chunks the prompt covers, else (no
    chunking, or under one chunk) the largest power of two <= prompt_len.
    The remainder is fed one token per decode step."""
    if prompt_len < 1:
        return 0
    n = 1
    if chunk > 0 and prompt_len >= chunk:
        while n * 2 <= prompt_len // chunk:
            n *= 2
        return n * chunk
    while n * 2 <= prompt_len:
        n *= 2
    return n


def _dummy_rows(ids: torch.Tensor) -> torch.Tensor:
    """(B, S) ids -> (B, 1) True for all-PAD rows: the power-of-two
    bucketing dummies ``_pad_batch`` appends. They start decoding
    finished, so they never hold the loop open."""
    return ~torch.any(ids != PAD_ID, dim=1, keepdim=True)


def _encode_source(params, src_ids: torch.Tensor, cfg: ModelConfig, reference: bool):
    if cfg.attention_impl in ("ring", "ulysses"):  # one process: the ring of one
        cfg = dataclasses.replace(cfg, attention_impl="flash")
    enc_mask = make_padding_mask(src_ids)
    return encoder_apply(params["encoder"], src_ids, enc_mask, cfg, reference=reference), enc_mask


@torch.no_grad()
def greedy_decode(
    params,
    src_ids: torch.Tensor,
    cfg: ModelConfig,
    max_len: int,
    bos_id: int,
    eos_id: int,
    reference: bool = False,
) -> torch.Tensor:
    """(B, S_src) source ids -> (B, max_len) generated target ids (int64).

    Generated rows start after BOS; positions after a row's EOS are PAD.
    The BOS token goes through ``transformer_prefill``; each later
    position is one ``transformer_decode_step`` over the dense caches,
    with the cross-attention K/V projected once. ``reference`` runs the
    encoder's flash kernels as their plain versions."""
    batch, dev = src_ids.shape[0], src_ids.device
    tokens = torch.full((batch, max_len), PAD_ID, dtype=torch.long, device=dev)
    if max_len < 1:
        return tokens
    enc_out, enc_mask = _encode_source(params, src_ids, cfg, reference)
    caches = init_decoder_caches(cfg, batch, max_len + 1, device=dev)
    cross = dict(cross_mask=enc_mask,
                 cross_kvs=precompute_cross_kvs(params["decoder"], enc_out, cfg))
    bos = torch.full((batch, 1), bos_id, dtype=torch.long, device=dev)
    logits, caches = transformer_prefill(params, bos, caches, 0, cfg, **cross)
    finished = _dummy_rows(src_ids)
    t = 0
    while True:
        nxt = torch.argmax(logits, dim=-1)[:, None]
        nxt = torch.where(finished, torch.full_like(nxt, PAD_ID), nxt)
        finished = finished | (nxt == eos_id)
        tokens[:, t] = nxt[:, 0]
        t += 1
        if t >= max_len or bool(finished.all()):
            return tokens
        logits, caches = transformer_decode_step(params, nxt, caches, t, cfg, **cross)


@torch.no_grad()
def beam_search_decode(
    params,
    src_ids: torch.Tensor,
    cfg: ModelConfig,
    max_len: int,
    bos_id: int,
    eos_id: int,
    beam_size: int = 4,
    alpha: float = 0.6,
    reference: bool = False,
) -> torch.Tensor:
    """(B, S_src) source ids -> (B, max_len) ids of the best beam (int64).

    Beams ride the batch dimension (B·K) through the decode step greedy
    uses. Each tick adds every beam's log-probabilities to its score
    (finished beams continue with PAD only, at no cost; on the first tick
    only beam 0 is live), keeps the K best of the (K·V) candidates per row,
    and gathers the caches' rows by parent beam into fresh tensors. The
    best beam is chosen by GNMT length normalisation ``score /
    ((5 + len) / 6) ** alpha``."""
    batch, dev, K = src_ids.shape[0], src_ids.device, beam_size
    vocab = cfg.target_vocab_size
    if max_len < 1:
        return torch.full((batch, max_len), PAD_ID, dtype=torch.long, device=dev)
    neg = torch.tensor(-1e9, dtype=torch.float32, device=dev)
    enc_out, enc_mask = _encode_source(params, src_ids, cfg, reference)
    cross_kvs = [
        (k.repeat_interleave(K, dim=0), v.repeat_interleave(K, dim=0))
        for k, v in precompute_cross_kvs(params["decoder"], enc_out, cfg)
    ]
    cross = dict(cross_mask=enc_mask.repeat_interleave(K, dim=0), cross_kvs=cross_kvs)
    caches = init_decoder_caches(cfg, batch * K, max_len + 1, device=dev)
    pad_only = torch.full((vocab,), -1e9, dtype=torch.float32, device=dev)
    pad_only[PAD_ID] = 0.0
    first_tick = torch.zeros((1, K, 1), dtype=torch.float32, device=dev)
    first_tick[:, 1:] = neg
    rows = torch.arange(batch, device=dev)[:, None] * K

    def select(t, logits, caches, scores, finished, tokens_buf):
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(batch, K, vocab)
        logp = torch.where(finished[:, :, None], pad_only, logp)
        combined = scores[:, :, None] + logp
        if t == 0:
            combined = combined + first_tick
        flat_scores, flat_idx = torch.sort(
            combined.reshape(batch, K * vocab), dim=1, descending=True, stable=True
        )
        flat_scores, flat_idx = flat_scores[:, :K], flat_idx[:, :K]
        parent = flat_idx // vocab
        nxt_tok = flat_idx % vocab
        row = (rows + parent).reshape(-1)
        caches = [
            {name: buf[row] if torch.is_tensor(buf) else buf for name, buf in cache.items()}
            for cache in caches
        ]
        tokens_buf = torch.gather(tokens_buf, 1, parent[:, :, None].expand(-1, -1, max_len))
        tokens_buf[:, :, t] = nxt_tok
        finished = torch.gather(finished, 1, parent)
        emit = torch.where(finished, torch.full_like(nxt_tok, PAD_ID), nxt_tok)
        return (emit.reshape(batch * K, 1), caches, flat_scores, finished | (nxt_tok == eos_id),
                tokens_buf)

    bos = torch.full((batch * K, 1), bos_id, dtype=torch.long, device=dev)
    logits, caches = transformer_prefill(params, bos, caches, 0, cfg, **cross)
    state = select(
        0, logits, caches, torch.zeros((batch, K), dtype=torch.float32, device=dev),
        _dummy_rows(src_ids).expand(batch, K),
        torch.full((batch, K, max_len), PAD_ID, dtype=torch.long, device=dev),
    )
    t = 1
    while t < max_len and not bool(state[3].all()):
        tok, caches, scores, finished, tokens_buf = state
        logits, caches = transformer_decode_step(params, tok, caches, t, cfg, **cross)
        state = select(t, logits, caches, scores, finished, tokens_buf)
        t += 1
    _, _, scores, _, tokens_buf = state
    lengths = torch.clamp((tokens_buf != PAD_ID).sum(dim=-1).float(), min=1.0)
    best = torch.argmax(scores / ((5.0 + lengths) / 6.0) ** alpha, dim=1)
    return tokens_buf[torch.arange(batch, device=dev), best]


def _bucket(n: int, cap: int, floor: int = 16) -> int:
    """Round ``n`` up to a power of two, clamped to [floor, cap]."""
    w = floor
    while w < n:
        w *= 2
    return min(w, cap)


def _pad_batch(encoded: list[list[int]], width: int) -> tuple[np.ndarray, int]:
    """Stack id lists into a PAD canvas of a power-of-two number of rows;
    returns (ids, number of real rows)."""
    n = len(encoded)
    ids = np.full((_bucket(n, 1 << 30, floor=1), width), PAD_ID, dtype=np.int32)
    for i, e in enumerate(encoded):
        ids[i, : min(len(e), width)] = e[:width]
    return ids, n


def translate(
    params,
    cfg: ModelConfig,
    src_tokenizer,
    tgt_tokenizer,
    sentences: str | list[str],
    max_len: int = 64,
    src_len: int | None = None,
    truncate: bool = False,
    beam_size: int = 1,
    alpha: float = 0.6,
) -> list[str]:
    """Text in, text out, on the params' device. Sources are framed with
    BOS/EOS and padded to a power-of-two width (capped at
    ``cfg.max_position``; ``src_len`` pins it) and a power-of-two batch of
    rows; an over-long source raises unless ``truncate`` or ``src_len``
    clips it (keeping its EOS). ``beam_size > 1`` runs beam search with
    length penalty ``alpha``."""
    if cfg.encoder_only or cfg.decoder_only:
        raise ValueError("translate() needs a seq2seq (encoder-decoder) model")
    if isinstance(sentences, str):
        sentences = [sentences]
    encoded = [
        [src_tokenizer.bos_id, *src_tokenizer.encode(s), src_tokenizer.eos_id]
        for s in sentences
    ]
    longest = max(len(e) for e in encoded)
    if src_len is None and not truncate and longest > cfg.max_position:
        raise ValueError(
            f"a sentence encodes to {longest} tokens but the model's "
            f"max_position is {cfg.max_position}; shorten the input, or opt "
            "into truncation (truncate=True / src_len=...)"
        )
    width = src_len or _bucket(longest, cfg.max_position)
    encoded = [
        e if len(e) <= width else [*e[: width - 1], src_tokenizer.eos_id] for e in encoded
    ]
    src, n = _pad_batch(encoded, width)
    device = params["encoder"]["embedding"]["table"].device
    src_t = torch.from_numpy(src).to(device=device, dtype=torch.long)
    ids = (tgt_tokenizer.bos_id, tgt_tokenizer.eos_id)
    if beam_size > 1:
        out = beam_search_decode(params, src_t, cfg, max_len, *ids, beam_size=beam_size,
                                 alpha=alpha)
    else:
        out = greedy_decode(params, src_t, cfg, max_len, *ids)
    return _detokenize_rows(out.cpu().tolist(), n, tgt_tokenizer)
