"""The masked-LM objective: BERT-style dynamic masking.

Port of ``transformer_tpu/train/mlm.py``. The trainer masks each step's
batch on the device from the step's own generator (fresh masks every
step); the data pipeline stays the plain LM-window stream. The [MASK]
token is the model's top input id (``vocab_size - 1``): ``cli.train
--objective mlm`` sizes the model vocabulary one larger than the
tokenizer's.

The JAX twin draws from a threefry key, which a ``torch.Generator`` cannot
reproduce, so the draws and the masking are split: ``mask_draws`` makes
the three tensors (selection uniforms, kind uniforms, replacement ranks)
and ``mask_from_draws`` turns them into the masked batch. Given JAX's own
draws, ``mask_from_draws`` gives JAX's output bit for bit.
"""

from __future__ import annotations

import torch

from transformer_tpu_torch.config import PAD_ID


def allowed_draws(vocab_size: int, excluded_ids=()) -> tuple[tuple[int, ...], int]:
    """(the excluded ids the replacement draw skips, ascending; the number
    of ids it draws from). Raises ValueError when none is left."""
    mask_id = vocab_size - 1
    excl = tuple(sorted({int(i) for i in excluded_ids if 1 <= i < mask_id}))
    n_allowed = (mask_id - 1) - len(excl)
    if n_allowed < 1:
        raise ValueError(
            f"excluded_ids {excluded_ids} leave no real tokens to draw "
            f"random replacements from (vocab_size={vocab_size})"
        )
    return excl, n_allowed


def mask_draws(
    shape, generator: torch.Generator, n_allowed: int, device=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The random numbers of one masking over a (B, S) batch, from
    ``generator``: selection uniforms, kind uniforms (fp32 in [0, 1)) and
    replacement ranks (int64 in [1, n_allowed]), in that order."""
    kw = dict(generator=generator, device=device)
    return (torch.rand(shape, **kw), torch.rand(shape, **kw),
            torch.randint(1, n_allowed + 1, shape, **kw))


def mask_from_draws(
    tokens: torch.Tensor,
    u_sel: torch.Tensor,
    u_kind: torch.Tensor,
    rank: torch.Tensor,
    vocab_size: int,
    mask_rate: float = 0.15,
    excluded_ids=(),
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S) ids and one masking's draws -> (masked input, labels).

    ``mask_rate`` of the positions that are neither PAD nor excluded are
    selected (``u_sel < mask_rate``); of those, ``u_kind < 0.8`` become
    [MASK] (``vocab_size - 1``), ``u_kind < 0.9`` a random real id and the
    rest stay (80 / 10 / 10). The random id is the rank shifted past each
    excluded id in ascending order, so it is never PAD, [MASK] or an
    excluded id. ``labels`` holds the original id at the selected positions
    and PAD elsewhere, so the masked CE scores exactly those."""
    mask_id = vocab_size - 1
    excl, _ = allowed_draws(vocab_size, excluded_ids)
    real = tokens != PAD_ID
    for e in excluded_ids:
        real = real & (tokens != e)
    sel = (u_sel < mask_rate) & real
    rand_tok = rank.to(tokens.dtype)
    for e in excl:
        rand_tok = torch.where(rand_tok >= e, rand_tok + 1, rand_tok)
    masked = torch.where(
        sel & (u_kind < 0.8),
        torch.full_like(tokens, mask_id),
        torch.where(sel & (u_kind < 0.9), rand_tok, tokens),
    )
    labels = torch.where(sel, tokens, torch.full_like(tokens, PAD_ID))
    return masked, labels


def mask_tokens(
    tokens: torch.Tensor,
    generator: torch.Generator,
    vocab_size: int,
    mask_rate: float = 0.15,
    excluded_ids=(),
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S) ids -> (masked input, labels) for one MLM step, drawn from
    ``generator`` on the ids' device (``mask_from_draws``)."""
    _, n_allowed = allowed_draws(vocab_size, excluded_ids)
    draws = mask_draws(tokens.shape, generator, n_allowed, device=tokens.device)
    return mask_from_draws(tokens, *draws, vocab_size, mask_rate, excluded_ids)
