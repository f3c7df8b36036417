"""Shape utilities (the port of
``apex1_tpu/transformer/tensor_parallel/utils.py``; reference
``apex/transformer/utils.py :: divide, split_tensor_along_last_dim`` and
``tensor_parallel/utils.py :: VocabUtility``)."""

from __future__ import annotations

import torch


def ensure_divisibility(numerator: int, denominator: int) -> None:
    if numerator % denominator != 0:
        raise ValueError(f"{numerator} is not divisible by {denominator}")


def divide(numerator: int, denominator: int) -> int:
    ensure_divisibility(numerator, denominator)
    return numerator // denominator


def split_tensor_along_last_dim(x: torch.Tensor, num_partitions: int,
                                contiguous_split_chunks: bool = False):
    """Equal chunks along the last dimension (views, as the reference
    returns; contiguous copies on request)."""
    chunks = torch.split(x, divide(x.shape[-1], num_partitions), dim=-1)
    if contiguous_split_chunks:
        return tuple(c.contiguous() for c in chunks)
    return chunks


class VocabUtility:
    """Vocab-range arithmetic for vocab-sharded tables."""

    @staticmethod
    def vocab_range_from_per_partition_vocab_size(per_partition_size, rank,
                                                  world_size=None):
        del world_size
        start = rank * per_partition_size
        return start, start + per_partition_size

    @staticmethod
    def vocab_range_from_global_vocab_size(global_vocab_size, rank,
                                           world_size):
        per = divide(global_vocab_size, world_size)
        return VocabUtility.vocab_range_from_per_partition_vocab_size(
            per, rank)
