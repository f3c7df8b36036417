"""Sigmoid focal loss (the port of ``apex1_tpu/contrib/focal_loss.py``;
reference ``apex/contrib/focal_loss``, the RetinaNet detection loss).

FL(p_t) = -α_t (1 - p_t)^γ log(p_t) over per-class logits, in fp32, the
log terms through the stable identities log p = -softplus(-x) and
log(1 - p) = -softplus(x); ``label_smoothing`` as the reference kernel
applies it. A plain composite, as in the JAX package (no TPU kernel).
"""

from __future__ import annotations

import torch


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), with no threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def focal_loss(logits: torch.Tensor, targets: torch.Tensor, *,
               num_classes: int | None = None, alpha: float = 0.25,
               gamma: float = 2.0, label_smoothing: float = 0.0,
               reduction: str = "sum") -> torch.Tensor:
    """``logits`` (..., C); ``targets`` (...,) int class ids or (..., C)
    {0, 1} one-hot or multi-label floats. A class id outside [0, C) (a
    negative id: an anchor with no assignment) is a background-only
    row, all negatives, as ``jax.nn.one_hot`` gives it. ``reduction``:
    "sum", "mean" or "none"."""
    C = logits.shape[-1]
    if num_classes is not None and num_classes != C:
        raise ValueError(f"num_classes={num_classes} != logits C={C}")
    x = logits.float()
    if targets.dim() == x.dim() - 1:
        cls = torch.arange(C, device=targets.device)
        t = (targets.long()[..., None] == cls).float()
    else:
        t = targets.float()
    if label_smoothing:
        t = t * (1.0 - label_smoothing) + 0.5 * label_smoothing
    p = torch.sigmoid(x)
    loss = (t * alpha * torch.pow(1.0 - p, gamma) * _softplus(-x)
            + (1.0 - t) * (1.0 - alpha) * torch.pow(p, gamma)
            * _softplus(x))
    if reduction == "sum":
        return loss.sum()
    if reduction == "mean":
        return loss.mean()
    if reduction == "none":
        return loss
    raise ValueError(f"unknown reduction {reduction!r}")
