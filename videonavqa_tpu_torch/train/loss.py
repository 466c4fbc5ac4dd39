"""Cross-entropy loss with torch.nn.CrossEntropyLoss(weight=..., reduction=...) semantics.

- the per-example nll (in f32) is scaled by the weight of the *target* class;
- 'mean' divides by the sum of the batch targets' weights, not the count;
- 'sum' sums; 'elementwise_mean' is torch's old alias for 'mean'.
"""

from __future__ import annotations

import torch


def cross_entropy_loss(logits, labels, *, class_weights=None, reduction="mean", valid=None):
    """logits [B, K], labels [B] int -> scalar f32. ``valid`` (bool [B],
    optional) drops padded rows from both the sum and the divisor."""
    if reduction not in ("sum", "mean", "elementwise_mean"):
        raise ValueError(f"unknown reduction {reduction!r}")
    labels = labels.long()
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    nll = -log_probs.gather(1, labels[:, None])[:, 0]
    w = class_weights.float()[labels] if class_weights is not None else torch.ones_like(nll)
    if valid is not None:
        w = w * valid.float()
    total = (nll * w).sum()
    if reduction == "sum":
        return total
    if class_weights is not None:
        denom = w.sum()
    elif valid is not None:
        denom = valid.float().sum()
    else:
        denom = float(labels.shape[0])
    return total / denom
