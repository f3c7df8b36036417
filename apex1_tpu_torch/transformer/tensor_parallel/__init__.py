"""Tensor parallelism (the port of
``apex1_tpu/transformer/tensor_parallel``): the region collectives and
the decomposed collective matmuls (`mappings`), the tensor-parallel
layers as modules and functional forms (`layers`), the vocab-parallel
cross-entropies, ``broadcast_data`` (`data`), the shape utilities, and
the RNG tracker and activation checkpointing of `random`."""

from apex1_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy, vocab_parallel_linear_cross_entropy)
from apex1_tpu_torch.transformer.tensor_parallel.data import broadcast_data
from apex1_tpu_torch.transformer.tensor_parallel.layers import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
    column_parallel_linear, row_parallel_linear,
    set_tensor_model_parallel_attributes, vocab_parallel_embedding)
from apex1_tpu_torch.transformer.tensor_parallel.mappings import (
    all_gather_matmul, collective_counts,
    copy_to_tensor_model_parallel_region,
    gather_from_sequence_parallel_region,
    gather_from_tensor_model_parallel_region, matmul_reduce_scatter,
    reduce_from_tensor_model_parallel_region,
    reduce_scatter_to_sequence_parallel_region, reset_collectives,
    scatter_to_sequence_parallel_region,
    scatter_to_tensor_model_parallel_region)
from apex1_tpu_torch.transformer.tensor_parallel.random import (
    RNGStatesTracker, checkpoint, get_rng_tracker, model_parallel_seed)
from apex1_tpu_torch.transformer.tensor_parallel.utils import (
    VocabUtility, divide, split_tensor_along_last_dim)

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "set_tensor_model_parallel_attributes",
           "broadcast_data", "RNGStatesTracker", "checkpoint",
           "get_rng_tracker", "model_parallel_seed",
           "vocab_parallel_cross_entropy",
           "vocab_parallel_linear_cross_entropy", "column_parallel_linear",
           "row_parallel_linear", "vocab_parallel_embedding",
           "all_gather_matmul",
           "collective_counts", "copy_to_tensor_model_parallel_region",
           "gather_from_sequence_parallel_region",
           "gather_from_tensor_model_parallel_region",
           "matmul_reduce_scatter",
           "reduce_from_tensor_model_parallel_region",
           "reduce_scatter_to_sequence_parallel_region",
           "reset_collectives", "scatter_to_sequence_parallel_region",
           "scatter_to_tensor_model_parallel_region", "VocabUtility",
           "divide", "split_tensor_along_last_dim"]
