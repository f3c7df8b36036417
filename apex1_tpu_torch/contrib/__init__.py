"""Contrib modules of the port (``apex1_tpu/contrib``), under the
reference's ``apex.contrib`` names: the fused multi-head attention
modules, `SoftmaxCrossEntropyLoss` (the cross-entropy kernels),
`openfold` (the norm and softmax kernels), and the plain composites
`focal_loss`, `group_norm`/`GroupNorm`, `index_mul_2d`, the transducer
joint and loss and ASP's sparsity masks; ``fmha``, ``clip_grad_norm_``
and ``GroupBatchNorm2d`` (`SyncBatchNorm`) bound to their port
modules; ``distributed_fused_adam`` / ``distributed_fused_lamb`` (the
reference's ``DistributedFusedAdam`` / ``DistributedFusedLAMB``) bound
to `parallel.distributed_optimizer`."""

from apex1_tpu_torch.contrib import openfold  # noqa: F401
from apex1_tpu_torch.contrib.focal_loss import focal_loss
from apex1_tpu_torch.contrib.group_norm import GroupNorm, group_norm
from apex1_tpu_torch.contrib.index_mul_2d import index_mul_2d
from apex1_tpu_torch.contrib.multihead_attn import (EncdecMultiheadAttn,
                                                    SelfMultiheadAttn)
from apex1_tpu_torch.contrib.sparsity import (ASP, compute_m4n2_mask,
                                              permutation_search)
from apex1_tpu_torch.contrib.transducer import (TransducerJoint,
                                                TransducerLoss,
                                                transducer_joint,
                                                transducer_loss)
from apex1_tpu_torch.contrib.xentropy import SoftmaxCrossEntropyLoss
from apex1_tpu_torch.ops.attention import fmha
from apex1_tpu_torch.optim.clip_grad import clip_grad_norm as clip_grad_norm_
from apex1_tpu_torch.parallel.distributed_optimizer import (
    distributed_fused_adam, distributed_fused_lamb)
from apex1_tpu_torch.parallel.sync_batchnorm import \
    SyncBatchNorm as GroupBatchNorm2d

__all__ = ["openfold", "focal_loss", "GroupNorm", "group_norm",
           "index_mul_2d", "EncdecMultiheadAttn", "SelfMultiheadAttn",
           "ASP", "compute_m4n2_mask", "permutation_search",
           "TransducerJoint", "TransducerLoss", "transducer_joint",
           "transducer_loss", "SoftmaxCrossEntropyLoss", "fmha",
           "clip_grad_norm_", "GroupBatchNorm2d", "distributed_fused_adam",
           "distributed_fused_lamb"]
