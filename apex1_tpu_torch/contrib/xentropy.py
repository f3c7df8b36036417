"""``apex.contrib.xentropy.SoftmaxCrossEntropyLoss`` (the port of
``apex1_tpu/contrib/xentropy.py``): the class-shaped wrapper over
`ops.xentropy.softmax_cross_entropy_loss`, whose forward and backward
are the cross-entropy kernels (TPU rows 18-19, ``csrc/xentropy.cu``)."""

from __future__ import annotations

import torch

from apex1_tpu_torch.ops.xentropy import softmax_cross_entropy_loss


class SoftmaxCrossEntropyLoss:
    """Callable and ``apply``-style wrapper; returns the per-token losses
    (fp32), reduce them yourself as the reference does."""

    def __init__(self, smoothing: float = 0.0,
                 padding_idx: int | None = None):
        self.smoothing = smoothing
        self.padding_idx = padding_idx

    def __call__(self, logits: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
        return softmax_cross_entropy_loss(
            logits, labels, smoothing=self.smoothing,
            padding_idx=self.padding_idx)

    @staticmethod
    def apply(logits: torch.Tensor, labels: torch.Tensor,
              smoothing: float = 0.0, padding_idx: int | None = None,
              half_to_float: bool = False) -> torch.Tensor:
        """``half_to_float`` casts half logits to fp32 first (the kernels
        then read fp32; their gradient comes back in fp32 and autograd's
        cast takes it to the logits' dtype)."""
        if half_to_float:
            logits = logits.float()
        return softmax_cross_entropy_loss(
            logits, labels, smoothing=smoothing, padding_idx=padding_idx)
