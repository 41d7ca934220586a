"""Decoding: token picking, prompt bucketing, seq2seq translation and LM
continuation.

Port of ``sample_token``, ``_detokenize_rows``, ``prefill_len_for``,
``_dummy_rows``, ``greedy_decode``, ``lm_generate``, ``beam_search_decode``,
``lm_generate_speculative``, ``_bucket``, ``_pad_batch``, ``generate`` and
``translate`` from ``transformer_tpu/train/decode.py``.
Sampling draws from an explicit ``torch.Generator``; greedy picks are
argmax and need none. ``lm_generate``'s sampled pick at tick ``t`` draws
from the generator keyed (seed, t) (``serve.speculative.pick_generator``),
the key the continuous scheduler gives a slot's pick at position ``t``, so
a batch-1 sampled ``generate`` answers as the scheduler does (JAX folds
``t`` into one threefry key; its draws cannot be reproduced). The JAX
twin's early-exit ``while_loop`` is a
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
def lm_generate(
    params,
    prompt_ids: torch.Tensor,
    cfg: ModelConfig,
    max_new: int,
    eos_id: int,
    seed: int = 0,
    sample: bool = False,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    prefill_len: int = 0,
    prefill_chunk: int = 0,
) -> torch.Tensor:
    """Causal-LM continuation: (B, P) BOS-led prompts (PAD on the right)
    -> (B, max_new) generated ids over dense KV caches.

    ``prefill_len = n > 0`` runs the first ``n`` prompt positions through
    ``transformer_prefill`` (in ``prefill_chunk`` pieces); the loop then
    feeds one token per row per tick: the rest of each row's prompt, then
    its picks. ``n`` must not exceed the shortest real row's prompt
    (``generate`` computes it). Tick ``t`` picks the token of position
    ``t + 1`` from position ``t``'s logits; a row stops at EOS (later
    positions PAD) or once it has picked its ``max_new``-th token (later
    ticks would pick tokens the result never reads), all-PAD bucketing
    rows start finished, and the loop exits once every row has finished.
    ``sample`` draws with ``sample_token`` from the generator keyed (seed,
    t)."""
    from transformer_tpu_torch.serve.speculative import pick_generator

    batch, prompt_len = prompt_ids.shape
    dev = prompt_ids.device
    total = prompt_len + max_new
    caches = init_decoder_caches(cfg, batch, total + 1, device=dev)
    prompt_lens = (prompt_ids != PAD_ID).sum(dim=1, keepdim=True)
    toks = torch.full((batch, total - 1), PAD_ID, dtype=torch.long, device=dev)

    def advance(t, logits, finished):
        """Selection tick t: the token for position t + 1 (the next prompt
        token while in the prompt, else the pick), finished rows frozen to
        PAD, the emission stored at column t."""
        if sample:
            sampled = sample_token(
                logits, pick_generator(seed, t, dev), sample=True,
                temperature=temperature, top_k=top_k, top_p=top_p,
            )
        else:
            sampled = sample_token(logits)
        in_prompt = (t + 1) < prompt_lens
        nxt_prompt = prompt_ids[:, min(t + 1, prompt_len - 1)][:, None]
        nxt = torch.where(in_prompt, nxt_prompt, sampled[:, None])
        nxt = torch.where(finished, torch.full_like(nxt, PAD_ID), nxt)
        finished = finished | (~in_prompt & (nxt == eos_id))
        toks[:, t] = torch.where(in_prompt, torch.full_like(nxt, PAD_ID), nxt)[:, 0]
        return nxt, finished | (t >= last_tick)

    # A row's last kept pick is the token of position prompt_len + max_new - 1.
    last_tick = prompt_lens + (max_new - 2)
    finished = _dummy_rows(prompt_ids)
    # Clamp the prefill below the last tick (total - 1) so the hoisted
    # selection tick has a column to write.
    n = min(prefill_len, prompt_len, total - 1)
    if n >= 1:
        logits, caches = transformer_prefill(
            params, prompt_ids[:, :n], caches, 0, cfg, chunk=prefill_chunk
        )
        # Tick n - 1's selection (the prefill's last logits are its logits);
        # ticks 0 .. n - 2 were all in the prompt and emitted PAD.
        tok, finished = advance(n - 1, logits, finished)
        t = n
    else:
        tok, t = prompt_ids[:, :1], 0
    while t < total - 1 and not bool(finished.all()):
        logits, caches = transformer_decode_step(params, tok, caches, t, cfg)
        tok, finished = advance(t, logits, finished)
        t += 1
    # toks[:, t] holds the token of position t + 1; a row's generation
    # starts at its prompt length. Clamp both ends: an all-PAD dummy row
    # has prompt length 0.
    cols = prompt_lens - 1 + torch.arange(max_new, device=dev)[None, :]
    return torch.gather(toks, 1, torch.clamp(cols, 0, total - 2))


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


def lm_generate_speculative(
    params,
    prompt_ids,
    cfg: ModelConfig,
    max_new: int,
    eos_id: int,
    *,
    speculate_k: int,
    drafter=None,
    sample: bool = False,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    seed: int = 0,
    prefill_chunk: int = 0,
) -> tuple[list[int], dict]:
    """Batch-1 speculative counterpart of ``lm_generate``: ``(tokens,
    stats)`` from ``serve.speculative.speculative_generate`` (greedy tokens
    equal ``lm_generate``'s; ``drafter=None`` is the n-gram drafter)."""
    from transformer_tpu_torch.serve.speculative import speculative_generate

    return speculative_generate(
        params, cfg, prompt_ids, max_new, eos_id,
        speculate_k=speculate_k, drafter=drafter, sample=sample,
        temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
        prefill_chunk=prefill_chunk,
    )


def generate(
    params,
    cfg: ModelConfig,
    tokenizer,
    prompts: str | list[str],
    max_new: int = 64,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    seed: int = 0,
    prefill_chunk: int = 0,
    speculate_k: int = 0,
    drafter=None,
) -> list[str]:
    """Text in, continuation text out, for decoder-only models, on the
    params' device. Prompts are BOS-led, padded to a power-of-two width
    (at least 8, capped at ``cfg.max_position``) and a power-of-two batch
    of rows; the prefix the shortest prompt covers (``prefill_len_for``)
    is prefilled in one pass. ``temperature`` 0 is greedy, above 0 samples
    (with optional top-k and top-p). ``max_new`` is clamped to the
    position budget; a prompt that leaves none raises. ``speculate_k > 0``
    runs each prompt alone through ``lm_generate_speculative``."""
    if not cfg.decoder_only:
        raise ValueError("generate() is for decoder_only models; use translate()")
    if isinstance(prompts, str):
        prompts = [prompts]
    encoded = [[tokenizer.bos_id, *tokenizer.encode(p)] for p in prompts]
    longest = max(len(e) for e in encoded)
    if longest >= cfg.max_position:
        raise ValueError(
            f"a prompt encodes to {longest} tokens but the model's "
            f"max_position is {cfg.max_position}; shorten the prompt"
        )
    max_new = min(max_new, cfg.max_position - longest)
    sample = temperature > 0.0
    if speculate_k > 0:
        texts = []
        for e in encoded:
            toks, _ = lm_generate_speculative(
                params, e, cfg, max_new, tokenizer.eos_id,
                speculate_k=speculate_k, drafter=drafter, sample=sample,
                temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
                prefill_chunk=prefill_chunk,
            )
            texts.extend(_detokenize_rows([toks] if toks else [[PAD_ID]], 1, tokenizer))
        return texts
    width = _bucket(longest, cfg.max_position, floor=8)
    ids, n = _pad_batch(encoded, width)
    device = params["decoder"]["embedding"]["table"].device
    shortest = min(len(e) for e in encoded)
    out = lm_generate(
        params, torch.from_numpy(ids).to(device=device, dtype=torch.long), cfg, max_new,
        tokenizer.eos_id, seed=seed, sample=sample, temperature=temperature, top_k=top_k,
        top_p=top_p, prefill_len=prefill_len_for(shortest, prefill_chunk),
        prefill_chunk=prefill_chunk,
    )
    return _detokenize_rows(out.cpu().tolist(), n, tokenizer)


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
