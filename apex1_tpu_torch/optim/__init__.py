"""Fused optimizers (the port of ``apex1_tpu/optim``): Adam and gradient
clipping so far; the rest are ROADMAP.md queue A item 5."""

from apex1_tpu_torch.optim.clip_grad import clip_grad_norm
from apex1_tpu_torch.optim.fused_adam import (FusedAdamState,
                                              GradientTransformation,
                                              fused_adam)

__all__ = ["clip_grad_norm", "FusedAdamState", "GradientTransformation",
           "fused_adam"]
