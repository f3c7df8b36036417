"""Tensor parallelism (the port of part of
``apex1_tpu/transformer/tensor_parallel``): the region collectives and
the decomposed collective matmuls (`mappings`), the functional
tensor-parallel layers, the vocab-parallel cross-entropies, the shape
utilities, and the activation-checkpoint policies of `random`. The
flax layer modules, the RNG tracker and ``broadcast_data`` are not
ported yet (ROADMAP.md queue A item 7)."""

from apex1_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy, vocab_parallel_linear_cross_entropy)
from apex1_tpu_torch.transformer.tensor_parallel.layers import (
    column_parallel_linear, row_parallel_linear, vocab_parallel_embedding)
from apex1_tpu_torch.transformer.tensor_parallel.mappings import (
    all_gather_matmul, collective_counts,
    copy_to_tensor_model_parallel_region,
    gather_from_sequence_parallel_region,
    gather_from_tensor_model_parallel_region, matmul_reduce_scatter,
    reduce_from_tensor_model_parallel_region,
    reduce_scatter_to_sequence_parallel_region, reset_collectives,
    scatter_to_sequence_parallel_region,
    scatter_to_tensor_model_parallel_region)
from apex1_tpu_torch.transformer.tensor_parallel.utils import (
    VocabUtility, divide, split_tensor_along_last_dim)

__all__ = ["vocab_parallel_cross_entropy",
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
