"""Masked cross-entropy and its exact metric sums.

Port of ``masked_cross_entropy`` from ``transformer_tpu/train/loss.py``:
per-token CE over fp32 log-softmax with PAD targets zeroed, optional label
smoothing, normalised per non-PAD token ("tokens") or per sequence
("batch"), returned with the exact sums ``loss_sum``, ``weight`` and
``correct`` so metrics accumulate without averaging error. Under a data ×
sequence split each process holds part of the batch: it normalises its
partial sum by the global token count (``total_weight``) or the global
batch, so the processes' losses add up to the loss of the whole batch.
``chunked_cross_entropy_from_hidden`` (``loss_chunks > 1``) computes the
same from the decoder hiddens without materialising the whole (B, S, V)
logits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from transformer_tpu_torch.config import PAD_ID
from transformer_tpu_torch.models.transformer import project_logits


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


def chunked_cross_entropy_from_hidden(
    params,
    hidden: torch.Tensor,
    targets: torch.Tensor,
    cfg,
    *,
    num_chunks: int,
    label_smoothing: float = 0.0,
    normalization: str = "tokens",
    batch_size: int | None = None,
    pad_id: int = PAD_ID,
    total_weight: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """``masked_cross_entropy`` of ``project_logits(params, hidden)`` over
    ``num_chunks`` sequence slices of the (B, S, d_model) hiddens, each
    slice's projection and CE recomputed in the backward
    (``torch.utils.checkpoint``), so only (B, S/num_chunks, V) logits are
    live at a time. The sequence is padded with PAD targets to a multiple
    of ``num_chunks``. Equal to the unchunked loss up to summation order."""
    s = hidden.shape[1]
    chunk = -(-s // num_chunks)
    pad = chunk * num_chunks - s
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad), value=pad_id)

    def chunk_sums(hc, tc):
        _, m = masked_cross_entropy(
            project_logits(params, hc, cfg), tc, label_smoothing=label_smoothing, pad_id=pad_id
        )
        return m["loss_sum"], m["weight"], m["correct"]

    zero = hidden.new_zeros((), dtype=torch.float32)
    loss_sum, weight, correct = zero, zero, zero
    for i in range(num_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        ls, w, c = checkpoint(chunk_sums, hidden[:, sl], targets[:, sl], use_reentrant=False,
                              preserve_rng_state=False)  # no randomness; capturable
        loss_sum, weight, correct = loss_sum + ls, weight + w, correct + c
    divisor = weight if total_weight is None else total_weight
    loss = _normalize(loss_sum, divisor, normalization, batch_size)
    return loss, {"loss_sum": loss_sum, "weight": weight, "correct": correct}
