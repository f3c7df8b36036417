"""Vocab-parallel cross-entropy (the port of
``apex1_tpu/transformer/tensor_parallel/cross_entropy.py``; reference
``apex/transformer/tensor_parallel/cross_entropy.py``).

`vocab_parallel_cross_entropy` over vocab-sharded logits, the
reference's algorithm step for step: local max → all-reduce MAX; local
Σexp(x − max) → all-reduce SUM; the target logit by the in-shard mask →
all-reduce SUM; loss = log Σexp − (target − max). Its backward is
local: softmax_shard − onehot_shard.

`vocab_parallel_linear_cross_entropy` fuses the LM-head product into
it: each rank's (V/tp, H) weight shard gives per-shard online-softmax
statistics through the port's linear-xent kernels (`shard_stats`, TPU
row 8, or `shard_stats_packed`, row 9, at the shard's ``col_offset``),
never the logits, merged across shards by four all-reduces
(``fused=False``) or two (``fused=True``,
`ops.fused_collective.fused_vocab_parallel_merge`); the backward is
`shard_grads` (rows 10-11) against the global lse, local to the shard.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from apex1_tpu_torch.ops.linear_xent import (shard_grads, shard_stats,
                                             shard_stats_packed)
from apex1_tpu_torch.transformer.tensor_parallel import mappings as mp


def _in_shard(targets, start: int, per: int):
    local = targets - start
    in_shard = (local >= 0) & (local < per)
    return in_shard, local.clamp(0, per - 1)


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits_shard, targets, label_smoothing, group):
        x = logits_shard.float()
        per = x.shape[-1]
        start = dist.get_rank(group) * per
        gmax = mp.all_reduce(x.amax(dim=-1), group, dist.ReduceOp.MAX)
        e = torch.exp(x - gmax[..., None])
        gsum = mp.all_reduce(e.sum(dim=-1), group)
        in_shard, local = _in_shard(targets, start, per)
        tgt = torch.gather(x, -1, local[..., None].long())[..., 0]
        tgt = mp.all_reduce(torch.where(in_shard, tgt, 0.0), group)
        lse = gmax + torch.log(gsum)
        loss = lse - tgt
        if label_smoothing:
            vocab = per * dist.get_world_size(group)
            mean_x = mp.all_reduce(x.sum(dim=-1), group) / vocab
            loss = ((1.0 - label_smoothing) * loss
                    + label_smoothing * (lse - mean_x))
        ctx.save_for_backward(logits_shard, targets, gmax, gsum)
        ctx.args = (label_smoothing, group)
        return loss

    @staticmethod
    def backward(ctx, dloss):
        logits_shard, targets, gmax, gsum = ctx.saved_tensors
        label_smoothing, group = ctx.args
        x = logits_shard.float()
        per = x.shape[-1]
        p = torch.exp(x - gmax[..., None]) / gsum[..., None]
        in_shard, local = _in_shard(targets, dist.get_rank(group) * per,
                                    per)
        col = torch.arange(per, device=x.device)
        onehot = (col == local[..., None]) & in_shard[..., None]
        grad = p - (1.0 - label_smoothing) * onehot.float()
        if label_smoothing:
            vocab = per * dist.get_world_size(group)
            grad = grad - label_smoothing / vocab
        grad = grad * dloss[..., None]
        return grad.to(logits_shard.dtype), None, None, None


def vocab_parallel_cross_entropy(logits_shard, targets,
                                 label_smoothing: float = 0.0, group=None):
    """``logits_shard`` (..., V/tp): this rank's vocab slice; ``targets``
    (...): global vocab ids, the same on every rank. Returns the
    per-token loss, the same on every rank."""
    return _VocabParallelCE.apply(logits_shard, targets,
                                  float(label_smoothing), mp._group(group))


def _vp_merge(m, l, tgt, sumx, group):
    """The decomposed cross-shard merge: four all-reduces."""
    gmax = mp.all_reduce(m, group, dist.ReduceOp.MAX)
    gsum = mp.all_reduce(l * torch.exp(m - gmax), group)
    return (gmax + torch.log(gsum), mp.all_reduce(tgt, group),
            mp.all_reduce(sumx, group))


class _VocabParallelLinearCE(torch.autograd.Function):
    """The JAX package's ``_vp_fused`` custom VJP: residuals (x, W shard,
    labels, global lse); the backward's dx is shard-partial, summed by
    the one input collective of the caller."""

    @staticmethod
    def forward(ctx, x2, w_shard, t, group, smoothing, padding_idx, k,
                fused_merge):
        off = dist.get_rank(group) * w_shard.shape[0]
        if fused_merge:
            from apex1_tpu_torch.ops.fused_collective import (
                fused_vocab_parallel_merge)
            stats = shard_stats_packed(x2, w_shard, t, col_offset=off,
                                       num_classes=k)
            lse, tgt, sumx = fused_vocab_parallel_merge(stats, group)
        else:
            m, l, tgt, sumx = shard_stats(x2, w_shard, t, col_offset=off,
                                          num_classes=k)
            lse, tgt, sumx = _vp_merge(m, l, tgt, sumx, group)
        loss = ((1.0 - smoothing) * (lse - tgt)
                + smoothing * (lse - sumx / k))
        if padding_idx is not None:
            loss = torch.where(t == padding_idx, 0.0, loss)
        ctx.save_for_backward(x2, w_shard, t, lse)
        ctx.args = (off, smoothing, padding_idx, k)
        return loss

    @staticmethod
    def backward(ctx, dloss):
        x2, w_shard, t, lse = ctx.saved_tensors
        off, smoothing, padding_idx, k = ctx.args
        dx, dw = shard_grads(x2, w_shard, t, lse, dloss, col_offset=off,
                             smoothing=smoothing, padding_idx=padding_idx,
                             num_classes=k)
        return dx, dw, None, None, None, None, None, None


def vocab_parallel_linear_cross_entropy(x, w_shard, labels, *, group=None,
                                        label_smoothing: float = 0.0,
                                        padding_idx: Optional[int] = None,
                                        num_classes: Optional[int] = None,
                                        sequence_parallel_input: bool = False,
                                        fused: bool = False):
    """Cross-entropy of ``softmax(x @ Wᵀ)`` with W vocab-sharded over
    ``group`` in equal shards: ``w_shard`` (V/tp, H) this rank's rows,
    ``labels`` global ids over the global token set. The op applies one
    input collective so the activation gradient comes out whole: with
    ``sequence_parallel_input=False`` ``x`` (..., H) is replicated and
    copied into the region (all-reduce in the backward); with True it is
    this rank's sequence chunk, all-gathered (reduce-scatter in the
    backward). ``num_classes`` masks padded global columns. ``fused``:
    the packed statistics and the two-all-reduce merge, the same numbers
    (the same kernel; a SUM all-reduce adds each lane on its own).
    Returns the per-token fp32 loss, the same on every rank."""
    group = mp._group(group)
    if x.shape[-1] != w_shard.shape[-1]:
        raise ValueError(f"hidden mismatch: x {tuple(x.shape)} vs w_shard "
                         f"{tuple(w_shard.shape)}")
    x2 = x.reshape(-1, x.shape[-1])
    if sequence_parallel_input:
        x2 = mp.gather_from_sequence_parallel_region(x2, group, 0, True)
    else:
        x2 = mp.copy_to_tensor_model_parallel_region(x2, group)
    t = labels.reshape(-1).to(torch.int32)
    if t.shape[0] != x2.shape[0]:
        raise ValueError(f"labels cover {t.shape[0]} tokens but x has "
                         f"{x2.shape[0]} (labels must span the GLOBAL token "
                         "set)")
    vocab = w_shard.shape[0] * dist.get_world_size(group)
    if num_classes is not None and not 0 < num_classes <= vocab:
        raise ValueError(f"num_classes {num_classes} must be in (0, {vocab}]")
    k = vocab if num_classes is None else int(num_classes)
    loss = _VocabParallelLinearCE.apply(x2, w_shard, t, group,
                                        float(label_smoothing), padding_idx,
                                        k, bool(fused))
    return loss.reshape(labels.shape)
