"""Ops with hand-written Hopper kernels, each beside its plain PyTorch
version (see `ops._common` for the dispatch rule)."""

from apex1_tpu_torch.ops._common import (NEG_INF, force_impl, get_impl,
                                         set_impl)
from apex1_tpu_torch.ops.attention import (flash_attention, flash_dbias,
                                           flash_dkv, flash_dq, flash_fwd,
                                           flash_fwd_merge, fmha)
from apex1_tpu_torch.ops.chunked_loss import (chunked_dpo_loss,
                                              chunked_kl_loss,
                                              chunked_logprob,
                                              chunked_orpo_loss)
from apex1_tpu_torch.ops.fused_dense import (check_glu_geometry, fused_glu,
                                             glu_fwd)
from apex1_tpu_torch.ops.layer_norm import (FusedLayerNorm, FusedRMSNorm,
                                            layer_norm, layer_norm_bwd,
                                            layer_norm_fwd, rms_norm)
from apex1_tpu_torch.ops.lora_epilogue import (check_lora_geometry,
                                               lora_delta)
from apex1_tpu_torch.ops.linear_xent import (linear_cross_entropy,
                                             lxent_dw, lxent_dx, lxent_fwd,
                                             lxent_grads, shard_grads,
                                             shard_stats, shard_stats_packed)
from apex1_tpu_torch.ops.paged_decode import (PagedCache, cache_attend,
                                              fused_sample, gather_pages,
                                              paged_attend,
                                              paged_update_attend,
                                              sample_token, scatter_pages)
from apex1_tpu_torch.ops.quantized import int8_matmul, int8_mm, quantize_int8
from apex1_tpu_torch.ops.rope import (apply_rotary_pos_emb, rope_tables,
                                      rotate)
from apex1_tpu_torch.ops.softmax import (FusedScaleMaskSoftmax,
                                         scaled_masked_softmax,
                                         scaled_upper_triang_masked_softmax,
                                         softmax_bwd, softmax_fwd)
from apex1_tpu_torch.ops.stochastic import (bda_bwd, bda_fwd, fold_seed,
                                            fused_bias_dropout_add,
                                            fused_dropout_add_layer_norm,
                                            layer_seeds)
from apex1_tpu_torch.ops.xentropy import (masked_next_token_mean,
                                          softmax_cross_entropy_loss,
                                          xent_bwd, xent_fwd)
# last: it imports the tensor-parallel collectives, which import the
# linear-xent kernels above
from apex1_tpu_torch.ops.fused_collective import chunk_matmul  # noqa: E402

#: every kernel wrapper, by kernel name; each keeps ``.launches``, the
#: number of times it launched its kernel
KERNEL_WRAPPERS = {"layer_norm_fwd": layer_norm_fwd,
                   "paged_attend": paged_attend,
                   "fused_sample": fused_sample,
                   "layer_norm_bwd": layer_norm_bwd,
                   "softmax_fwd": softmax_fwd,
                   "softmax_bwd": softmax_bwd,
                   "xent_fwd": xent_fwd,
                   "xent_bwd": xent_bwd,
                   "flash_fwd": flash_fwd,
                   "flash_dq": flash_dq,
                   "flash_dkv": flash_dkv,
                   "flash_dbias": flash_dbias,
                   "lxent_fwd": lxent_fwd,
                   "lxent_dx": lxent_dx,
                   "lxent_dw": lxent_dw,
                   "rope": rotate,
                   "glu_fwd": glu_fwd,
                   "bda_fwd": bda_fwd,
                   "bda_bwd": bda_bwd,
                   "int8_mm": int8_mm,
                   "lora_delta": lora_delta,
                   "chunk_matmul": chunk_matmul,
                   "flash_fwd_merge": flash_fwd_merge}


def reset_launches() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


__all__ = ["NEG_INF", "force_impl", "get_impl", "set_impl",
           "flash_attention", "flash_dbias", "flash_dkv", "flash_dq",
           "flash_fwd", "flash_fwd_merge", "fmha", "chunk_matmul",
           "chunked_dpo_loss", "chunked_kl_loss", "chunked_logprob",
           "chunked_orpo_loss", "linear_cross_entropy", "lxent_dw",
           "lxent_dx", "lxent_fwd", "lxent_grads", "shard_grads",
           "shard_stats", "shard_stats_packed", "check_glu_geometry",
           "fused_glu", "glu_fwd", "check_lora_geometry", "lora_delta",
           "int8_matmul", "int8_mm", "quantize_int8",
           "apply_rotary_pos_emb", "rope_tables",
           "rotate",
           "FusedLayerNorm", "FusedRMSNorm", "layer_norm", "layer_norm_bwd",
           "layer_norm_fwd", "rms_norm", "PagedCache", "cache_attend",
           "fused_sample", "gather_pages", "paged_attend",
           "paged_update_attend", "sample_token", "scatter_pages",
           "FusedScaleMaskSoftmax", "scaled_masked_softmax",
           "scaled_upper_triang_masked_softmax", "bda_bwd", "bda_fwd",
           "fold_seed", "fused_bias_dropout_add",
           "fused_dropout_add_layer_norm", "layer_seeds",
           "softmax_bwd", "softmax_fwd", "masked_next_token_mean",
           "softmax_cross_entropy_loss", "xent_bwd", "xent_fwd",
           "KERNEL_WRAPPERS", "reset_launches", "launch_counts"]
