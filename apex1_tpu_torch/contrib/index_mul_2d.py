"""``index_mul_2d`` (the port of ``apex1_tpu/contrib/index_mul_2d.py``;
reference ``apex/contrib/index_mul_2d``, OpenFold): ``out[i] =
in1[idx[i]] * in2[i]``, a gather and a product whose backward
scatter-adds d_in1 over repeated indices (autograd's ``index_select``
backward). A plain composite, as in the JAX package."""

from __future__ import annotations

import torch


def index_mul_2d(in1: torch.Tensor, in2: torch.Tensor,
                 idx: torch.Tensor) -> torch.Tensor:
    """``in1`` (N, D), ``in2`` (M, D), ``idx`` (M,) ints into N: (M, D)
    = in1[idx] * in2."""
    if in2.shape[0] != idx.shape[0]:
        raise ValueError(f"in2 rows {in2.shape[0]} != idx len "
                         f"{idx.shape[0]}")
    return torch.index_select(in1, 0, idx.long()) * in2
