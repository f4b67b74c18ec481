"""Loss functions (counterpart of ``kubeflow_tpu.ops.losses``):
token-level cross-entropy in float32 with optional z-loss and masking."""

from __future__ import annotations

import torch


def softmax_cross_entropy(logits, labels, mask=None, z_loss: float = 0.0):
    """Token-level CE. logits: [..., V] (any dtype), labels: [...] integer.

    Returns (mean_loss, aux) where aux has 'total_weight' (the mask sum,
    at least 1) for token-weighted averaging across micro batches and
    'sum_loss'.
    """
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    label_logit = logits.gather(-1, labels.long()[..., None])[..., 0]
    loss = logz - label_logit
    if z_loss:
        loss = loss + z_loss * logz.square()
    mask = torch.ones_like(loss) if mask is None else mask.float()
    total = mask.sum().clamp_min(1.0)
    sum_loss = (loss * mask).sum()
    return sum_loss / total, {"total_weight": total, "sum_loss": sum_loss}


def accuracy(logits, labels, mask=None):
    """Share of positions whose argmax is the label (mask-weighted);
    ties go to the first maximal index, as ``jnp.argmax``."""
    correct = (logits.argmax(dim=-1) == labels.long()).float()
    if mask is None:
        return correct.mean()
    mask = mask.float()
    return (correct * mask).sum() / mask.sum().clamp_min(1.0)
