"""Tensor-parallel layers (the port of
``apex1_tpu/transformer/tensor_parallel/layers.py``; reference
``apex/transformer/tensor_parallel/layers.py``), in two forms, as in
the JAX package.

The modules `ColumnParallelLinear`, `RowParallelLinear` and
`VocabParallelEmbedding` hold full-size parameters in the flax layout
and names (``kernel`` (in, out), ``bias``, ``embedding``), drawn with
flax's initialisers from ``seed`` on ``device`` (CUDA unless named).
``partition_specs()`` gives the specs the JAX modules attach with
``nn.with_partitioning`` (the column kernel and bias split on the
output features, the row kernel on the input features, the embedding on
the vocabulary); placing the parameters by them (`core.mesh.place`)
shards the plain product the forward computes, and the DTensor's
propagation inserts the collectives, as GSPMD does in JAX. The JAX
modules' sharding constraints on the output are redistributions of a
DTensor output here.

The functional forms `column_parallel_linear`, `row_parallel_linear` and
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
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch import nn

from apex1_tpu_torch.core.mesh import AXIS_TP, placements
from apex1_tpu_torch.ops._common import resolve_device
from apex1_tpu_torch.parallel.specs import P
from apex1_tpu_torch.transformer.tensor_parallel import mappings as mp

#: flax's ``truncated_normal`` draws from [-2, 2] and rescales by this,
#: so the result's standard deviation is the one asked for
_TRUNC_STD = 0.87962566103423978


def _lecun_normal(shape, gen, device) -> torch.Tensor:
    """flax's ``lecun_normal()`` for an (in, out) kernel: a normal
    truncated at two standard deviations, variance 1 / in."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t * (math.sqrt(1.0 / shape[0]) / _TRUNC_STD)


def _constrain(y: torch.Tensor, spec) -> torch.Tensor:
    """A DTensor ``y`` redistributed to ``spec`` (JAX's sharding
    constraint); a plain tensor as it is (JAX with no mesh)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(y, DTensor):
        return y
    dm = y.device_mesh
    return y.redistribute(dm, placements(spec, y.ndim, dm.mesh_dim_names))


class _ParallelModule(nn.Module):
    def __init__(self, device, seed: int):
        super().__init__()
        self._dev = resolve_device(device)
        self._gen = torch.Generator(device=self._dev).manual_seed(seed)

    def _param(self, value: torch.Tensor, dtype) -> nn.Parameter:
        return nn.Parameter(value.to(dtype))


class ColumnParallelLinear(_ParallelModule):
    """``y = x @ kernel + bias`` with the kernel split on its output
    features: (in, out / tp) a rank. ``gather_output`` replicates y,
    else y stays split on its last dimension."""

    def __init__(self, in_features: int, features: int, *,
                 use_bias: bool = True, gather_output: bool = False,
                 sequence_parallel_enabled: bool = False,
                 dtype=torch.float32, param_dtype=torch.float32,
                 tp_axis: str = AXIS_TP, device=None, seed: int = 0):
        super().__init__(device, seed)
        self.gather_output = gather_output
        self.sequence_parallel_enabled = sequence_parallel_enabled
        self.dtype, self.tp_axis = dtype, tp_axis
        self.kernel = self._param(_lecun_normal(
            (in_features, features), self._gen, self._dev), param_dtype)
        self.bias = (self._param(torch.zeros(features, device=self._dev),
                                 param_dtype) if use_bias else None)

    def partition_specs(self) -> dict:
        specs = {"kernel": P(None, self.tp_axis)}
        if self.bias is not None:
            specs["bias"] = P(self.tp_axis)
        return specs

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = mp.dot_f32(x, self.kernel.to(self.dtype)).to(self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        if self.gather_output:
            return _constrain(y, P())
        return _constrain(y, P(*([None] * (y.ndim - 1)), self.tp_axis))


class RowParallelLinear(_ParallelModule):
    """``y = x @ kernel + bias`` with the kernel split on its input
    features: (in / tp, out) a rank; the partial products sum (split
    along the sequence under sequence parallelism) and the bias is
    added once, after."""

    def __init__(self, in_features: int, features: int, *,
                 use_bias: bool = True, input_is_parallel: bool = True,
                 sequence_parallel_enabled: bool = False,
                 dtype=torch.float32, param_dtype=torch.float32,
                 tp_axis: str = AXIS_TP, device=None, seed: int = 0):
        super().__init__(device, seed)
        self.input_is_parallel = input_is_parallel
        self.sequence_parallel_enabled = sequence_parallel_enabled
        self.dtype, self.tp_axis = dtype, tp_axis
        self.kernel = self._param(_lecun_normal(
            (in_features, features), self._gen, self._dev), param_dtype)
        self.bias = (self._param(torch.zeros(features, device=self._dev),
                                 param_dtype) if use_bias else None)

    def partition_specs(self) -> dict:
        specs = {"kernel": P(self.tp_axis, None)}
        if self.bias is not None:
            specs["bias"] = P(None)
        return specs

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = mp.dot_f32(x, self.kernel.to(self.dtype)).to(self.dtype)
        if self.sequence_parallel_enabled:
            y = _constrain(y, P(*([None] * (y.ndim - 2)), self.tp_axis,
                                None))
        else:
            y = _constrain(y, P())
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class VocabParallelEmbedding(_ParallelModule):
    """An embedding table split along the vocabulary; the lookup is
    replicated (a token outside a rank's rows adds zero there)."""

    def __init__(self, num_embeddings: int, features: int, *,
                 dtype=torch.float32, param_dtype=torch.float32,
                 tp_axis: str = AXIS_TP, device=None, seed: int = 0):
        super().__init__(device, seed)
        self.dtype, self.tp_axis = dtype, tp_axis
        table = torch.empty(num_embeddings, features, device=self._dev)
        nn.init.normal_(table, 0.0, 0.02, generator=self._gen)
        self.embedding = self._param(table, param_dtype)

    def partition_specs(self) -> dict:
        return {"embedding": P(self.tp_axis, None)}

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        y = nn.functional.embedding(tokens, self.embedding).to(self.dtype)
        return _constrain(y, P())


def set_tensor_model_parallel_attributes(spec_tree):
    """The reference tags each weight with its tensor-parallel split;
    here that information is the spec dict, returned as it is."""
    return spec_tree


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

