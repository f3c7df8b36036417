"""LARC (the port of ``apex1_tpu/optim/larc.py``; reference
``apex/parallel/LARC.py :: LARC``).

Layer-wise Adaptive Rate Clipping as a gradient pre-transform, chained
before the optimizer it wraps:

    local_lr = trust_coefficient * ||p|| / (||g|| + wd * ||p|| + eps)

- ``clip=True`` (LARC): g *= min(local_lr / lr, 1), so the wrapped
  optimizer's lr * g takes the clipped step (``learning_rate`` is
  required to form the ratio, as the reference divides by the group's
  lr);
- ``clip=False`` (LARS): g *= local_lr.

A param whose norm or gradient norm is 0 keeps its gradient (the
reference's guard).

    tx = chain(larc(0.02, learning_rate=0.1, weight_decay=wd),
               fused_sgd(0.1, weight_decay=wd))
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from apex1_tpu_torch.optim.fused_adam import GradientTransformation


def larc(trust_coefficient: float = 0.02, clip: bool = True,
         eps: float = 1e-8,
         learning_rate: Optional[Union[float, Callable]] = None,
         weight_decay: float = 0.0) -> GradientTransformation:
    """The pre-transform; its state is the step count (an int32 0-d
    tensor, for a schedule). ``weight_decay`` must be the wrapped
    optimizer's, so the denominator matches the reference's."""

    def init(params: dict) -> torch.Tensor:
        dev = next(iter(params.values())).device if params else None
        return torch.zeros((), dtype=torch.int32, device=dev)

    def update(grads: dict, state: torch.Tensor, params: dict = None):
        if params is None:
            raise ValueError("larc requires params")
        step = state + 1
        if clip:
            if learning_rate is None:
                raise ValueError("clip=True requires learning_rate")
            lr = (learning_rate(step) if callable(learning_rate)
                  else learning_rate)
        out = {}
        for k, g in grads.items():
            g32, p32 = g.float(), params[k].float()
            p_norm = p32.square().sum().sqrt()
            g_norm = g32.square().sum().sqrt()
            local_lr = trust_coefficient * p_norm / (
                g_norm + weight_decay * p_norm + eps)
            ok = (p_norm > 0) & (g_norm > 0)
            factor = (torch.clamp(local_lr / lr, max=1.0) if clip
                      else local_lr)
            factor = torch.where(ok, factor, 1.0)
            out[k] = (g32 * factor).to(g.dtype)
        return out, step

    return GradientTransformation(init, update)


#: the reference's name (``apex.parallel.LARC.LARC``): the same knobs
LARC = larc
