"""Distributed training (the port of ``apex1_tpu/parallel``; reference
``apex/parallel``): the launcher, data-parallel gradient averaging, the
ZeRO-style distributed optimizers and their specs, ring and Ulysses
attention, the halo exchange, the partition specs and synchronized
batch norm."""

from apex1_tpu_torch.parallel.ddp import (DistributedDataParallel,
                                          allreduce_grads, broadcast_params)
from apex1_tpu_torch.parallel.distributed_optimizer import (
    distributed_fused_adam, distributed_fused_lamb, fsdp_param_specs,
    shard_opt_state_specs)
from apex1_tpu_torch.parallel.halo import (exchange_overlap, halo_exchange,
                                           spatial_conv2d)
from apex1_tpu_torch.parallel.multiproc import (init_distributed,
                                                init_from_env, launch,
                                                launch_script)
from apex1_tpu_torch.parallel.ring_attention import (ring_attention,
                                                     ring_attention_serial)
from apex1_tpu_torch.parallel.specs import PartitionSpec, specs_from_rules
from apex1_tpu_torch.parallel.sync_batchnorm import (SyncBatchNorm,
                                                     convert_syncbn_model,
                                                     sync_batch_stats)
from apex1_tpu_torch.parallel.ulysses import ulysses_attention

__all__ = ["DistributedDataParallel", "allreduce_grads", "broadcast_params",
           "distributed_fused_adam", "distributed_fused_lamb",
           "fsdp_param_specs", "shard_opt_state_specs", "exchange_overlap",
           "halo_exchange", "spatial_conv2d", "PartitionSpec",
           "specs_from_rules", "init_distributed", "init_from_env", "launch",
           "launch_script", "ring_attention",
           "ring_attention_serial", "SyncBatchNorm", "convert_syncbn_model",
           "sync_batch_stats", "ulysses_attention"]
