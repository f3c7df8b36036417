"""Contrib modules of the port (``apex1_tpu/contrib``): so far the fused
multi-head attention modules."""

from apex1_tpu_torch.contrib.multihead_attn import (EncdecMultiheadAttn,
                                                    SelfMultiheadAttn)

__all__ = ["EncdecMultiheadAttn", "SelfMultiheadAttn"]
