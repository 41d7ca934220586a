"""Masked cross-entropy and its exact metric sums.

Port of ``masked_cross_entropy`` from ``transformer_tpu/train/loss.py``:
per-token CE over fp32 log-softmax with PAD targets zeroed, optional label
smoothing, normalised per non-PAD token ("tokens") or per sequence
("batch"), returned with the exact sums ``loss_sum``, ``weight`` and
``correct`` so metrics accumulate without averaging error. Under a data ×
sequence split each process holds part of the batch: it normalises its
partial sum by the global token count (``total_weight``) or the global
batch, so the processes' losses add up to the loss of the whole batch.
The chunked variant (``loss_chunks > 1``) is not ported.
"""

from __future__ import annotations

import torch

from transformer_tpu_torch.config import PAD_ID


def _normalize(loss_sum, weight, normalization: str, batch_size: int | None):
    if normalization == "tokens":
        return loss_sum / torch.clamp(weight, min=1.0)
    if normalization == "batch":
        if batch_size is None:
            raise ValueError("normalization='batch' requires batch_size")
        return loss_sum / float(batch_size)
    raise ValueError(f"unknown normalization {normalization!r}")


def masked_cross_entropy(
    logits: torch.Tensor,
    targets: torch.Tensor,
    label_smoothing: float = 0.0,
    normalization: str = "tokens",
    batch_size: int | None = None,
    pad_id: int = PAD_ID,
    total_weight: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(B, S, V) logits, (B, S) targets -> (loss, {"loss_sum", "weight",
    "correct"}), all fp32 scalars on the logits' device. ``total_weight``
    replaces this call's own non-PAD count as the "tokens" divisor (the
    global count of a split batch)."""
    vocab = logits.shape[-1]
    targets = targets.long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    target_logp = logp.gather(-1, targets[..., None])[..., 0]
    if label_smoothing > 0.0:
        confidence = 1.0 - label_smoothing
        uniform = label_smoothing / (vocab - 1)
        smooth_sum = logp.sum(dim=-1) - target_logp
        per_token = -(confidence * target_logp + uniform * smooth_sum)
    else:
        per_token = -target_logp
    mask = (targets != pad_id).float()
    loss_sum = (per_token * mask).sum()
    weight = mask.sum()
    divisor = weight if total_weight is None else total_weight
    loss = _normalize(loss_sum, divisor, normalization, batch_size)
    correct = ((logits.argmax(dim=-1) == targets).float() * mask).sum()
    return loss, {"loss_sum": loss_sum, "weight": weight, "correct": correct}
