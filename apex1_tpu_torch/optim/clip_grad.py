"""Fused gradient clipping (the port of ``apex1_tpu/optim/clip_grad.py``;
reference ``apex/contrib/clip_grad/clip_grad.py :: clip_grad_norm_``).

Functional: returns (clipped_grads, total_norm), the norm unclipped, as
the reference returns it.
"""

from __future__ import annotations

import torch

from apex1_tpu_torch.core.pytree import global_norm, tree_scale


def clip_grad_norm(grads: dict, max_norm: float, *, eps: float = 1e-6):
    """Scale ``grads`` so their global L2 norm is at most ``max_norm``."""
    total_norm = global_norm(grads)
    scale = torch.clamp(max_norm / (total_norm + eps), max=1.0)
    return tree_scale(grads, scale), total_norm
