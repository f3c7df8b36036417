"""Ops with hand-written Hopper kernels, each beside its plain PyTorch
version (see `ops._common` for the dispatch rule)."""

from apex1_tpu_torch.ops._common import (NEG_INF, force_impl, get_impl,
                                         set_impl)
from apex1_tpu_torch.ops.layer_norm import (FusedLayerNorm, FusedRMSNorm,
                                            layer_norm, layer_norm_bwd,
                                            layer_norm_fwd, rms_norm)
from apex1_tpu_torch.ops.paged_decode import (PagedCache, cache_attend,
                                              fused_sample, gather_pages,
                                              paged_attend,
                                              paged_update_attend,
                                              sample_token, scatter_pages)
from apex1_tpu_torch.ops.softmax import (scaled_masked_softmax,
                                         scaled_upper_triang_masked_softmax,
                                         softmax_bwd, softmax_fwd)
from apex1_tpu_torch.ops.xentropy import (masked_next_token_mean,
                                          softmax_cross_entropy_loss,
                                          xent_bwd, xent_fwd)

#: every kernel wrapper, by kernel name; each keeps ``.launches``, the
#: number of times it launched its kernel
KERNEL_WRAPPERS = {"layer_norm_fwd": layer_norm_fwd,
                   "paged_attend": paged_attend,
                   "fused_sample": fused_sample,
                   "layer_norm_bwd": layer_norm_bwd,
                   "softmax_fwd": softmax_fwd,
                   "softmax_bwd": softmax_bwd,
                   "xent_fwd": xent_fwd,
                   "xent_bwd": xent_bwd}


def reset_launches() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


__all__ = ["NEG_INF", "force_impl", "get_impl", "set_impl",
           "FusedLayerNorm", "FusedRMSNorm", "layer_norm", "layer_norm_bwd",
           "layer_norm_fwd", "rms_norm", "PagedCache", "cache_attend",
           "fused_sample", "gather_pages", "paged_attend",
           "paged_update_attend", "sample_token", "scatter_pages",
           "scaled_masked_softmax", "scaled_upper_triang_masked_softmax",
           "softmax_bwd", "softmax_fwd", "masked_next_token_mean",
           "softmax_cross_entropy_loss", "xent_bwd", "xent_fwd",
           "KERNEL_WRAPPERS", "reset_launches", "launch_counts"]
