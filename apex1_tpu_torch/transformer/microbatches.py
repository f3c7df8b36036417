"""Microbatch calculators (the port of
``apex1_tpu/transformer/microbatches.py``; reference
``apex/transformer/microbatches.py :: build_num_microbatches_calculator,
ConstantNumMicroBatches, RampupBatchsizeNumMicroBatches``).

Host arithmetic mapping a global batch size to (micro_batch_size,
num_micro_batches), with the linear batch-size ramp-up of Megatron-style
trainers. The same numbers and errors as the JAX module.
"""

from __future__ import annotations


class ConstantNumMicroBatchesCalculator:
    def __init__(self, global_batch_size: int, micro_batch_size: int,
                 data_parallel_size: int):
        micro_times_dp = micro_batch_size * data_parallel_size
        if global_batch_size % micro_times_dp:
            raise ValueError(
                f"global batch {global_batch_size} not divisible by "
                f"micro_batch*dp {micro_times_dp}")
        self.micro_batch_size = micro_batch_size
        self.num_micro_batches = global_batch_size // micro_times_dp
        self.current_global_batch_size = global_batch_size

    def get(self) -> int:
        return self.num_micro_batches

    def get_current_global_batch_size(self) -> int:
        return self.current_global_batch_size

    def update(self, consumed_samples: int, consistency_check: bool = True):
        pass


class RampupBatchsizeNumMicroBatchesCalculator:
    """Linear ramp from ``start_batch_size`` to ``global_batch_size`` by
    ``batch_size_increment`` every ``ramup_samples / steps`` samples."""

    def __init__(self, start_batch_size: int, batch_size_increment: int,
                 ramup_samples: int, global_batch_size: int,
                 micro_batch_size: int, data_parallel_size: int):
        self.micro_batch_size = micro_batch_size
        self.data_parallel_size = data_parallel_size
        self.start_batch_size = start_batch_size
        self.batch_size_increment = batch_size_increment
        self.ramup_samples = ramup_samples
        self.global_batch_size = global_batch_size
        diff = global_batch_size - start_batch_size
        if diff % batch_size_increment:
            raise ValueError("ramp range not divisible by increment")
        num_increments = diff // batch_size_increment
        self.rampup_samples_per_increment = (
            ramup_samples / num_increments if num_increments else 0)
        self.update(0)

    def update(self, consumed_samples: int,
               consistency_check: bool = True) -> None:
        if (self.rampup_samples_per_increment == 0
                or consumed_samples > self.ramup_samples):
            current = self.global_batch_size
        else:
            steps = int(consumed_samples
                        // self.rampup_samples_per_increment)
            current = min(self.start_batch_size
                          + steps * self.batch_size_increment,
                          self.global_batch_size)
        micro_times_dp = self.micro_batch_size * self.data_parallel_size
        if consistency_check and current % micro_times_dp:
            raise ValueError(
                f"ramped batch {current} not divisible by micro*dp "
                f"{micro_times_dp}")
        self.current_global_batch_size = current
        self.num_micro_batches = current // micro_times_dp

    def get(self) -> int:
        return self.num_micro_batches

    def get_current_global_batch_size(self) -> int:
        return self.current_global_batch_size


def build_num_microbatches_calculator(
        rampup_batch_size, global_batch_size: int, micro_batch_size: int,
        data_parallel_size: int):
    """``rampup_batch_size``: None or (start, increment, samples), the
    reference's 3-element CLI argument."""
    if rampup_batch_size is None:
        return ConstantNumMicroBatchesCalculator(
            global_batch_size, micro_batch_size, data_parallel_size)
    start, increment, samples = (int(x) for x in rampup_batch_size)
    return RampupBatchsizeNumMicroBatchesCalculator(
        start, increment, samples, global_batch_size, micro_batch_size,
        data_parallel_size)
