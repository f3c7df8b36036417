"""Distributed training (the port of part of ``apex1_tpu/parallel``;
reference ``apex/parallel``): the launcher, data-parallel gradient
averaging, ring and Ulysses attention and synchronized batch norm. The
distributed optimizers, halo exchange and the partition specs are not
ported yet (ROADMAP.md queue A item 7)."""

from apex1_tpu_torch.parallel.ddp import (DistributedDataParallel,
                                          allreduce_grads, broadcast_params)
from apex1_tpu_torch.parallel.multiproc import init_distributed, launch
from apex1_tpu_torch.parallel.ring_attention import (ring_attention,
                                                     ring_attention_serial)
from apex1_tpu_torch.parallel.ulysses import ulysses_attention
from apex1_tpu_torch.parallel.sync_batchnorm import (SyncBatchNorm,
                                                     convert_syncbn_model,
                                                     sync_batch_stats)

__all__ = ["DistributedDataParallel", "allreduce_grads", "broadcast_params",
           "init_distributed", "launch", "ring_attention",
           "ring_attention_serial", "SyncBatchNorm", "convert_syncbn_model",
           "sync_batch_stats", "ulysses_attention"]
