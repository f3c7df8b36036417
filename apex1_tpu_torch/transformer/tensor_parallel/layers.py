"""Tensor-parallel layers, functional forms (the port of part of
``apex1_tpu/transformer/tensor_parallel/layers.py``; reference
``apex/transformer/tensor_parallel/layers.py``).

`column_parallel_linear`, `row_parallel_linear` and
`vocab_parallel_embedding` take this rank's shards and run the
`mappings` collectives over a process group (default: `parallel_state`'s
tensor-parallel group). Under sequence parallelism the boundary
collective is monolithic by default, the decomposed overlapped ring with
``overlap=True`` (`mappings.all_gather_matmul` /
`matmul_reduce_scatter`), or that ring with each chunk product in the
hand-written kernel with ``fused=True``
(`ops.fused_collective.fused_all_gather_matmul` /
`fused_matmul_reduce_scatter`); the two options exclude each other.
Every product is fp32 summed and rounded once to the input's dtype.

The flax modules ``ColumnParallelLinear``, ``RowParallelLinear`` and
``VocabParallelEmbedding`` shard full-size parameters through GSPMD
annotations, which have no counterpart here (ROADMAP.md queue A item 7).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from apex1_tpu_torch.transformer.tensor_parallel import mappings as mp


def _exclusive(overlap: bool, fused: bool) -> None:
    if overlap and fused:
        raise ValueError("overlap= and fused= are exclusive: fused IS the "
                         "overlapped ring with the products in a kernel — "
                         "pick one")


def column_parallel_linear(x, kernel_shard, bias_shard=None, *,
                           gather_output: bool = False,
                           sequence_parallel_enabled: bool = False,
                           group=None, overlap: bool = False,
                           fused: bool = False):
    """``x`` replicated (or this rank's sequence chunk under sequence
    parallelism); ``kernel_shard`` (in, out/tp). The forward copies ``x``
    into the region (all-reduce in the backward) or, under sequence
    parallelism, all-gathers it along the sequence (reduce-scatter in
    the backward), then multiplies; ``gather_output`` all-gathers the
    output's last dimension."""
    _exclusive(overlap, fused)
    group = mp._group(group)
    if sequence_parallel_enabled and fused:
        from apex1_tpu_torch.ops.fused_collective import (
            fused_all_gather_matmul)
        y = fused_all_gather_matmul(x, kernel_shard, group, 0).to(x.dtype)
    elif sequence_parallel_enabled and overlap:
        y = mp.all_gather_matmul(x, kernel_shard, group, 0).to(x.dtype)
    else:
        if sequence_parallel_enabled:
            x = mp.gather_from_sequence_parallel_region(x, group, 0, True)
        else:
            x = mp.copy_to_tensor_model_parallel_region(x, group)
        y = mp.dot_f32(x, kernel_shard).to(x.dtype)
    if bias_shard is not None:
        y = y + bias_shard
    if gather_output:
        y = mp.gather_from_tensor_model_parallel_region(y, group)
    return y


def row_parallel_linear(x_parallel, kernel_shard, bias=None, *,
                        input_is_parallel: bool = True,
                        sequence_parallel_enabled: bool = False,
                        group=None, overlap: bool = False,
                        fused: bool = False):
    """``x_parallel`` (..., in/tp); ``kernel_shard`` (in/tp, out). The
    partial products all-reduce, or reduce-scatter along the sequence
    under sequence parallelism; the bias is added once, after."""
    _exclusive(overlap, fused)
    group = mp._group(group)
    if not input_is_parallel:
        x_parallel = mp.scatter_to_tensor_model_parallel_region(x_parallel,
                                                                group)
    if sequence_parallel_enabled and fused:
        from apex1_tpu_torch.ops.fused_collective import (
            fused_matmul_reduce_scatter)
        y = fused_matmul_reduce_scatter(x_parallel, kernel_shard, group,
                                        0).to(x_parallel.dtype)
    elif sequence_parallel_enabled and overlap:
        y = mp.matmul_reduce_scatter(x_parallel, kernel_shard, group,
                                     0).to(x_parallel.dtype)
    else:
        y = mp.dot_f32(x_parallel, kernel_shard).to(x_parallel.dtype)
        if sequence_parallel_enabled:
            y = mp.reduce_scatter_to_sequence_parallel_region(y, group, 0)
        else:
            y = mp.reduce_from_tensor_model_parallel_region(y, group)
    if bias is not None:
        y = y + bias
    return y


def vocab_parallel_embedding(tokens, table_shard, *, group=None):
    """``table_shard`` (vocab/tp, features) holds rows [rank·V/tp,
    (rank + 1)·V/tp): tokens outside it look up row 0 and are zeroed,
    and the partials all-reduce (identity backward, so each row's
    gradient lands on the one rank whose mask kept it)."""
    group = mp._group(group)
    per = table_shard.shape[0]
    local = tokens - dist.get_rank(group) * per
    in_shard = (local >= 0) & (local < per)
    y = torch.nn.functional.embedding(local.clamp(0, per - 1), table_shard)
    y = torch.where(in_shard[..., None], y, torch.zeros((), dtype=y.dtype))
    return mp.reduce_from_tensor_model_parallel_region(y, group)

