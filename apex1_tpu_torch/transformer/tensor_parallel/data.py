"""The input batch made the same on every tensor-parallel rank (the
port of ``apex1_tpu/transformer/tensor_parallel/data.py``; reference
``apex/transformer/tensor_parallel/data.py :: broadcast_data``).

The group's first rank broadcasts each tensor (``dist.broadcast``,
counted in `mappings.COLLECTIVES` as ``broadcast``): a guard against
ranks whose host data diverged. The JAX package sums a copy masked to
rank 0 over the axis, the same values.
"""

from __future__ import annotations

import torch.distributed as dist

from apex1_tpu_torch.transformer.tensor_parallel import mappings as mp


def broadcast_data(keys, data: dict, datatype=None, *, group=None) -> dict:
    """``{k: data[k]}`` for ``keys``, each cast to ``datatype`` (when
    given) and then replaced by the first rank's values of ``group``
    (default: the tensor-parallel group). New tensors."""
    group = mp._group(group)
    src = dist.get_process_group_ranks(group)[0]
    out = {}
    for k in keys:
        x = data[k] if datatype is None else data[k].to(datatype)
        x = x.contiguous().clone()
        dist.broadcast(x, src=src, group=group)
        mp.COLLECTIVES["broadcast"] += 1
        out[k] = x
    return out
