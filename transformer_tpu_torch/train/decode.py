"""Token picking and prompt bucketing for the serving path.

Port of ``sample_token``, ``_detokenize_rows`` and ``prefill_len_for``
from ``transformer_tpu/train/decode.py``. Sampling draws from an explicit
``torch.Generator``; greedy picks are argmax and need none.
"""

from __future__ import annotations

import torch

from transformer_tpu_torch.config import PAD_ID


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
