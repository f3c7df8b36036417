"""Fused LM-head cross-entropy (the port of ``apex1_tpu/ops/linear_xent.py``).

Per-token cross-entropy of ``softmax(x @ weightᵀ)`` without the
(tokens x vocab) logits in device memory, with the semantics of
`softmax_cross_entropy_loss` on the materialized logits: label
smoothing ε, ``padding_idx`` rows give zero loss and gradient,
``num_classes`` masks the padded vocab rows of the weight.

For a shard of W holding global columns ``[col_offset, col_offset +
V_l)`` (the vocab-parallel form), `shard_stats` and
`shard_stats_packed` give the per-row online-softmax partials (m, l,
tgt, sumx) and `shard_grads` the gradients given the global lse.

Three kernels (TPU rows 7-11), each beside its plain PyTorch version:

- :func:`lxent_fwd` (``_fwd_kernel``): mode 0 gives (loss, lse), mode 1
  the four statistics, mode 2 the same four packed as (T, 4);
- :func:`lxent_dx` (``_bwd_dx_kernel``): dx = G·W;
- :func:`lxent_dw` (``_bwd_dw_kernel``): dW = Gᵀ·x;

with G = softmax - (1-ε)·onehot - ε/K on valid columns, times dloss,
recomputed from (x, W, lse) and rounded to the operand type before
its product, as the TPU kernels round it. The plain versions walk the
vocab in chunks of `PLAIN_CHUNK` columns (never a (T, V) tile) in the
order of ``_fwd_kernel``'s statistics.

The forward in bf16 and fp16, at every H, is one wgmma product
(``csrc/linear_xent_fwd.cu`` on ``csrc/gemm_wg.cuh``) whose epilogue
folds each 128 x 256 score tile into per-row partial statistics in the
accumulator registers, then a fold of the partials over the vocab tiles
in order. In fp32 it is
``csrc/linear_xent.cu``'s: heads up to `MAX_H` = 768 columns on tiles
that keep all of H resident, wider ones on its wide path (tiled
products with H streamed, the statistics folded from per-tile
partials).

The backward walks the vocab a chunk at a time (in bf16 and fp16 as
many rows as keep G within `WIDE_G_BYTES`, `F32_CHUNK` rows in fp32):
G_c formed once into a (T, n) buffer, then dx += G_c·W_c (an fp32 sum
over the chunks in order) and dW_c = G_cᵀ·x. In bf16 and fp16 at every
H the three products run on wgmma (``csrc/linear_xent_bwd.cu`` on
``csrc/gemm_wg.cuh``; G's rows padded to a multiple of 8 values). In
fp32, heads up to `MAX_H` run linear_xent.cu's resident-tile dx and dW
kernels and wider ones its wide path's products. `shard_grads` forms
each chunk's G once for both products; `lxent_dx` and `lxent_dw` alone
each form it.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex1_tpu_torch.ops import _build
from apex1_tpu_torch.ops._common import (DTYPE_CODES, NEG_INF, check_cuda,
                                         plain_autodiff, use_kernel)

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
#: the widest hidden size fp32's resident-tile kernels hold (the forward,
#: dx and dW of linear_xent.cu); wider fp32 heads take its wide path.
#: bf16 and fp16 run the wgmma kernels at every H
MAX_H = 768
#: vocab columns a step of the plain versions
PLAIN_CHUNK = 4096
#: the bf16/fp16 backward's G buffer, (T, chunk) values: a chunk holds
#: as many vocab rows (a multiple of 128) as fit. Fewer chunks mean fewer
#: passes over the fp32 dx sum and fewer grid tails; the whole vocab
#: fits at the Llama and BERT heads, 16384 rows at GPT-2's 16368 tokens
#: (chip_smoke.py --compare's chunk sweep, PERF.md §6)
WIDE_G_BYTES = 512 << 20
#: vocab rows an fp32 chunk (the wide path): its dx is summed over the
#: chunks in order, so the chunk fixes its rounding
F32_CHUNK = 8192
#: the fp32 wide forward's score tile columns (one partial-statistics slot
#: each)
WIDE_BN = 128
#: the bf16/fp16 forward's score tile columns (one partial-statistics
#: slot a row each)
WG_FWD_BN = 256


# ---- plain versions ------------------------------------------------------


def _columns(c0, n, V, off, K, device):
    """(1, n) global column ids of local rows [c0, c0 + n) and their
    validity: inside the shard (local < V) and a real class (global <
    K)."""
    lcol = torch.arange(c0, c0 + n, device=device)[None, :]
    gcol = lcol + off
    return gcol, (lcol < V) & (gcol < K)


def _plain_stats(x2, w, labels, off, K):
    """``_fwd_kernel``'s online statistics over vocab chunks: (m, l,
    tgt, sumx), each (T,) fp32."""
    T, V = x2.shape[0], w.shape[0]
    dev = x2.device
    xf = x2.float()
    t = labels.reshape(-1, 1).long()
    m = torch.full((T, 1), NEG_INF, device=dev)
    l = torch.zeros(T, 1, device=dev)
    tgt = torch.zeros(T, 1, device=dev)
    sx = torch.zeros(T, 1, device=dev)
    for c0 in range(0, V, PLAIN_CHUNK):
        s = xf @ w[c0:c0 + PLAIN_CHUNK].float().t()
        gcol, valid = _columns(c0, s.shape[1], V, off, K, dev)
        sm = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, sm.amax(dim=1, keepdim=True))
        e = torch.where(valid, torch.exp(sm - m_new), 0.0)
        l = l * torch.exp(m - m_new) + e.sum(dim=1, keepdim=True)
        m = m_new
        tgt = tgt + torch.where(gcol == t, s, 0.0).sum(dim=1, keepdim=True)
        sx = sx + torch.where(valid, s, 0.0).sum(dim=1, keepdim=True)
    return m[:, 0], l[:, 0], tgt[:, 0], sx[:, 0]


def _loss_from_stats(m, l, tgt, sx, labels, smoothing, padding_idx, K):
    lse = m + torch.log(l)
    loss = ((1.0 - smoothing) * (lse - tgt)
            + smoothing * (lse - sx / K))
    if padding_idx is not None:
        loss = torch.where(labels.reshape(-1) == padding_idx, 0.0, loss)
    return loss, lse


def _plain_fwd(x2, w, labels, off, K, smoothing, padding_idx, mode):
    m, l, tgt, sx = _plain_stats(x2, w, labels, off, K)
    if mode == 0:
        return _loss_from_stats(m, l, tgt, sx, labels, smoothing,
                                padding_idx, K)
    if mode == 1:
        return m, l, tgt, sx
    return torch.stack([m, l, tgt, sx], dim=1)


def _grad_chunks(x2, w, labels, lse, dloss, off, K, smoothing,
                 padding_idx, dtype):
    """Yields (c0, G) per vocab chunk: ``_grad_tile``'s G in fp32 after
    a rounding to ``dtype`` (the operand type of its product)."""
    V = w.shape[0]
    dev = x2.device
    xf = x2.float()
    t = labels.reshape(-1, 1).long()
    dl = dloss.reshape(-1, 1).float()
    if padding_idx is not None:
        dl = torch.where(t == padding_idx, 0.0, dl)
    lse = lse.reshape(-1, 1).float()
    for c0 in range(0, V, PLAIN_CHUNK):
        s = xf @ w[c0:c0 + PLAIN_CHUNK].float().t()
        gcol, valid = _columns(c0, s.shape[1], V, off, K, dev)
        p = torch.where(valid, torch.exp(s - lse), 0.0)
        g = p - (1.0 - smoothing) * (gcol == t).float() - smoothing / K
        g = torch.where(valid, g, 0.0) * dl
        yield c0, g.to(dtype).float()


def _plain_dx(x2, w, labels, lse, dloss, off, K, smoothing, padding_idx):
    dx = torch.zeros(x2.shape, dtype=torch.float32, device=x2.device)
    for c0, g in _grad_chunks(x2, w, labels, lse, dloss, off, K, smoothing,
                              padding_idx, w.dtype):
        dx += g @ w[c0:c0 + g.shape[1]].float()
    return dx.to(x2.dtype)


def _plain_dw(x2, w, labels, lse, dloss, off, K, smoothing, padding_idx):
    dw = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    xf = x2.float()
    for c0, g in _grad_chunks(x2, w, labels, lse, dloss, off, K, smoothing,
                              padding_idx, x2.dtype):
        dw[c0:c0 + g.shape[1]] = g.t() @ xf
    return dw.to(w.dtype)


# ---- kernel wrappers -----------------------------------------------------


def _operands(name, x2, w, labels, *rest):
    """Contiguous operands after the shared checks, int32 labels, and the
    ``vec`` flag (16-byte row loads)."""
    if x2.dtype not in _DTYPES or w.dtype != x2.dtype:
        raise ValueError(f"{name}: x and W must share one of f32/bf16/f16, "
                         f"got {x2.dtype}, {w.dtype}")
    if x2.dim() != 2 or w.dim() != 2 or x2.shape[1] != w.shape[1]:
        raise ValueError(f"{name}: x {tuple(x2.shape)} and W "
                         f"{tuple(w.shape)} do not fit")
    if labels.numel() != x2.shape[0]:
        raise ValueError(f"{name}: {labels.numel()} labels for "
                         f"{x2.shape[0]} rows")
    ops = [x2.contiguous(), w.contiguous(),
           labels.reshape(-1).to(torch.int32).contiguous(),
           *(t.reshape(-1).float().contiguous() for t in rest)]
    check_cuda(name, *ops)
    epv = 16 // x2.element_size()
    vec = x2.shape[1] % epv == 0 and all(t.data_ptr() % 16 == 0
                                         for t in ops[:2])
    return ops, int(vec)


def _common_args(x2, w, col_offset, K, smoothing, padding_idx):
    return (x2.shape[0], w.shape[0], x2.shape[1], int(K), int(col_offset),
            float(smoothing), int(padding_idx is not None),
            -1 if padding_idx is None else int(padding_idx))


def lxent_fwd(x2: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, *,
              num_classes: int, col_offset: int = 0, smoothing: float = 0.0,
              padding_idx: Optional[int] = None, mode: int = 0):
    """The forward kernel for (T, H) ``x2``, a (V_l, H) W shard and (T,)
    labels: mode 0 (loss, lse), mode 1 (m, l, tgt, sumx), each (T,)
    fp32; mode 2 one (T, 4) fp32. CUDA tensors launch the kernel
    (``lxent_fwd.launches``: the product and its fold count once, in
    bf16/fp16 and on fp32's wide path); CPU tensors take the plain
    version."""
    if mode not in (0, 1, 2):
        raise ValueError(f"lxent_fwd: mode must be 0, 1 or 2, got {mode}")
    if not use_kernel(x2):
        return _plain_fwd(x2, w, labels, col_offset, num_classes, smoothing,
                          padding_idx, mode)
    (x2, w, labels), vec = _operands("lxent_fwd", x2, w, labels)
    T, dev = x2.shape[0], x2.device
    if mode == 2:
        outs = [torch.empty(T, 4, dtype=torch.float32, device=dev)]
    else:
        outs = [torch.empty(T, dtype=torch.float32, device=dev)
                for _ in range(2 if mode == 0 else 4)]
    ptrs = [o.data_ptr() for o in outs] + [None] * (4 - len(outs))
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = _common_args(x2, w, col_offset, num_classes, smoothing,
                        padding_idx)
    if x2.dtype != torch.float32:
        nblk = -(-w.shape[0] // WG_FWD_BN)
        part = torch.empty(nblk, T, 4, dtype=torch.float32, device=dev)
        _build.launch("apex1_lxent_wg_fwd", x2.data_ptr(), w.data_ptr(),
                      labels.data_ptr(), part.data_ptr(), *ptrs, *args, mode,
                      nblk, vec, DTYPE_CODES[x2.dtype], stream)
    elif x2.shape[1] > MAX_H:
        nblk = -(-w.shape[0] // WIDE_BN)
        part = torch.empty(T, nblk, 4, dtype=torch.float32, device=dev)
        _build.launch("apex1_lxent_wide_fwd", x2.data_ptr(), w.data_ptr(),
                      labels.data_ptr(), part.data_ptr(), *ptrs, *args, mode,
                      nblk, vec, DTYPE_CODES[x2.dtype], stream)
    else:
        _build.launch("apex1_lxent_fwd", x2.data_ptr(), w.data_ptr(),
                      labels.data_ptr(), *ptrs, *args, mode, vec,
                      DTYPE_CODES[x2.dtype], stream)
    lxent_fwd.launches += 1
    return outs[0] if mode == 2 else tuple(outs)


lxent_fwd.launches = 0


def _bwd(name, x2, w, labels, lse, dloss, col_offset, K, smoothing,
         padding_idx, out_like):
    (x2, w, labels, lse, dloss), vec = _operands(name, x2, w, labels, lse,
                                                 dloss)
    out = torch.empty_like(x2 if out_like == "x" else w)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    _build.launch(f"apex1_{name}", x2.data_ptr(), w.data_ptr(),
                  labels.data_ptr(), lse.data_ptr(), dloss.data_ptr(),
                  out.data_ptr(),
                  *_common_args(x2, w, col_offset, K, smoothing, padding_idx),
                  vec, DTYPE_CODES[x2.dtype], stream)
    return out


def wg_chunk(T: int, V: int, itemsize: int) -> int:
    """Vocab rows a bf16/fp16 backward chunk: the most that keep the
    (T, chunk) G within `WIDE_G_BYTES`, a multiple of 128, at least 128
    and at most V."""
    rows = WIDE_G_BYTES // max(1, T * itemsize) // 128 * 128
    return min(V, max(128, rows))


def _chunked(x2) -> bool:
    """True when the backward of CUDA ``x2`` walks vocab chunks: bf16 and
    fp16 at every H (the wgmma kernels), fp32 past `MAX_H`."""
    return x2.dtype != torch.float32 or x2.shape[-1] > MAX_H


def _chunked_bwd(x2, w, labels, lse, dloss, col_offset, K, smoothing,
                 padding_idx, want_dx, want_dw):
    """The chunked backward: per vocab chunk, G_c into a (T, n) buffer,
    then dx += G_c·W_c and/or dW_c = G_cᵀ·x, on the wgmma kernels in
    bf16/fp16 (G's row stride n rounded up to 8) and on the wide path's
    in fp32. Returns (dx, dW), None where not wanted."""
    (x2, w, labels, lse, dloss), vec = _operands(
        "lxent_dx" if want_dx else "lxent_dw", x2, w, labels, lse, dloss)
    (T, H), V, dev = x2.shape, w.shape[0], x2.device
    es, epv, code = x2.element_size(), 16 // x2.element_size(), \
        DTYPE_CODES[x2.dtype]
    wg = x2.dtype != torch.float32
    chunk = wg_chunk(T, V, es) if wg else min(F32_CHUNK, V)
    n_chunks = -(-V // chunk)
    g = torch.empty(T * (-(-chunk // 8) * 8 if wg else chunk),
                    dtype=x2.dtype, device=dev)
    dx = torch.empty_like(x2) if want_dx else None
    dw = torch.empty_like(w) if want_dw else None
    acc = (torch.empty(T, H, dtype=torch.float32, device=dev)
           if want_dx and n_chunks > 1 else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    common = _common_args(x2, w, col_offset, K, smoothing, padding_idx)
    for i in range(n_chunks):
        c0 = i * chunk
        n = min(chunk, V - c0)
        wc = w.data_ptr() + c0 * H * es
        first, last = int(i == 0), int(i == n_chunks - 1)
        acc_p = None if acc is None else acc.data_ptr()
        dw_c = None if dw is None else dw.data_ptr() + c0 * H * es
        if wg:
            ldg = -(-n // 8) * 8
            # (T, n, H, K, off, ...) of the chunk's rows
            _build.launch("apex1_lxent_wg_grad", x2.data_ptr(), wc,
                          labels.data_ptr(), lse.data_ptr(),
                          dloss.data_ptr(), g.data_ptr(), T, n, H, common[3],
                          common[4] + c0, *common[5:], ldg, vec, code, stream)
            if want_dx:
                _build.launch("apex1_lxent_wg_dx", g.data_ptr(), wc, acc_p,
                              dx.data_ptr(), T, n, H, ldg, first, last, vec,
                              code, stream)
            if want_dw:
                _build.launch("apex1_lxent_wg_dw", g.data_ptr(),
                              x2.data_ptr(), dw_c, T, n, H, ldg, vec, code,
                              stream)
            continue
        _build.launch("apex1_lxent_wide_grad", x2.data_ptr(), wc,
                      labels.data_ptr(), lse.data_ptr(), dloss.data_ptr(),
                      g.data_ptr(), T, n, H, common[3], common[4] + c0,
                      *common[5:], vec, code, stream)
        vec_g = int(vec and n % epv == 0)
        if want_dx:
            _build.launch("apex1_lxent_wide_dx", g.data_ptr(), wc, acc_p,
                          dx.data_ptr(), T, n, H, first, last, vec_g, code,
                          stream)
        if want_dw:
            _build.launch("apex1_lxent_wide_dw", g.data_ptr(),
                          x2.data_ptr(), dw_c, T, n, H, vec_g, code, stream)
    return dx, dw


def lxent_dx(x2, w, labels, lse, dloss, *, num_classes: int,
             col_offset: int = 0, smoothing: float = 0.0,
             padding_idx: Optional[int] = None) -> torch.Tensor:
    """dx = G·W, (T, H) in x's dtype, from the global (T,) lse and the
    per-token loss cotangent. CUDA tensors launch the kernel
    (``lxent_dx.launches``); CPU tensors take the plain version."""
    if not use_kernel(x2):
        return _plain_dx(x2, w, labels, lse, dloss, col_offset, num_classes,
                         smoothing, padding_idx)
    if _chunked(x2):
        dx = _chunked_bwd(x2, w, labels, lse, dloss, col_offset,
                          num_classes, smoothing, padding_idx, True, False)[0]
    else:
        dx = _bwd("lxent_dx", x2, w, labels, lse, dloss, col_offset,
                  num_classes, smoothing, padding_idx, "x")
    lxent_dx.launches += 1
    return dx


lxent_dx.launches = 0


def lxent_dw(x2, w, labels, lse, dloss, *, num_classes: int,
             col_offset: int = 0, smoothing: float = 0.0,
             padding_idx: Optional[int] = None) -> torch.Tensor:
    """dW = Gᵀ·x, (V_l, H) in W's dtype. CUDA tensors launch the kernel
    (``lxent_dw.launches``); CPU tensors take the plain version."""
    if not use_kernel(x2):
        return _plain_dw(x2, w, labels, lse, dloss, col_offset, num_classes,
                         smoothing, padding_idx)
    if _chunked(x2):
        dw = _chunked_bwd(x2, w, labels, lse, dloss, col_offset,
                          num_classes, smoothing, padding_idx, False, True)[1]
    else:
        dw = _bwd("lxent_dw", x2, w, labels, lse, dloss, col_offset,
                  num_classes, smoothing, padding_idx, "w")
    lxent_dw.launches += 1
    return dw


lxent_dw.launches = 0


def lxent_grads(x2, w, labels, lse, dloss, *, num_classes: int,
                col_offset: int = 0, smoothing: float = 0.0,
                padding_idx: Optional[int] = None):
    """(dx, dW) together. On CUDA in bf16/fp16, or in fp32 past `MAX_H`,
    each vocab chunk's G is formed once for both products (one launch of
    `lxent_dx` and one of `lxent_dw` counted); otherwise `lxent_dx` then
    `lxent_dw`."""
    kw = dict(num_classes=num_classes, col_offset=col_offset,
              smoothing=smoothing, padding_idx=padding_idx)
    if not (use_kernel(x2) and _chunked(x2)):
        return (lxent_dx(x2, w, labels, lse, dloss, **kw),
                lxent_dw(x2, w, labels, lse, dloss, **kw))
    out = _chunked_bwd(x2, w, labels, lse, dloss, col_offset, num_classes,
                       smoothing, padding_idx, True, True)
    lxent_dx.launches += 1
    lxent_dw.launches += 1
    return out


# ---- the JAX package's entry points --------------------------------------


def shard_stats(x2, w_shard, t2, *, col_offset=0, num_classes=None,
                block_t=None, block_v=None):
    """Per-shard online-softmax partials ``(m, l, tgt, sumx)``, each (T,)
    fp32, over the global columns ``[col_offset, col_offset + V_l)``.
    Not differentiable on its own. ``block_t``/``block_v`` are accepted
    for the JAX signature and do not change the CUDA tiles."""
    k = w_shard.shape[0] if num_classes is None else num_classes
    return lxent_fwd(x2, w_shard, t2, num_classes=k, col_offset=col_offset,
                     mode=1)


def shard_stats_packed(x2, w_shard, t2, *, col_offset=0, num_classes=None,
                       block_t=None, block_v=None):
    """`shard_stats` packed into one (T, 4) ``[m, l, tgt, sumx]`` array,
    bit-identical to `shard_stats`' four (the same kernel, another
    epilogue)."""
    k = w_shard.shape[0] if num_classes is None else num_classes
    return lxent_fwd(x2, w_shard, t2, num_classes=k, col_offset=col_offset,
                     mode=2)


def shard_grads(x2, w_shard, t2, lse, dloss, *, col_offset=0,
                smoothing=0.0, padding_idx=None, num_classes=None,
                block_t=None, block_v=None):
    """Per-shard gradients given the GLOBAL lse: ``(dx_partial,
    dw_shard)`` (dx still to be summed over shards)."""
    k = w_shard.shape[0] if num_classes is None else num_classes
    return lxent_grads(x2, w_shard, t2, lse, dloss, num_classes=k,
                       col_offset=col_offset, smoothing=smoothing,
                       padding_idx=padding_idx)


class _LinearXent(torch.autograd.Function):
    """The JAX package's ``_fused`` custom VJP: residuals (x, W, labels,
    lse), never the logits."""

    @staticmethod
    def forward(ctx, x2, w, t, smoothing, padding_idx, k):
        loss, lse = lxent_fwd(x2, w, t, num_classes=k, smoothing=smoothing,
                              padding_idx=padding_idx)
        ctx.save_for_backward(x2, w, t, lse)
        ctx.args = (smoothing, padding_idx, k)
        return loss

    @staticmethod
    def backward(ctx, dloss):
        x2, w, t, lse = ctx.saved_tensors
        smoothing, padding_idx, k = ctx.args
        dx, dw = shard_grads(x2, w, t, lse, dloss, smoothing=smoothing,
                             padding_idx=padding_idx, num_classes=k)
        return dx, dw, None, None, None, None


def linear_cross_entropy(x: torch.Tensor, weight: torch.Tensor,
                         labels: torch.Tensor, *, smoothing: float = 0.0,
                         padding_idx: Optional[int] = None,
                         num_classes: Optional[int] = None,
                         block_t: Optional[int] = None,
                         block_v: Optional[int] = None) -> torch.Tensor:
    """Per-token CE of ``softmax(x @ weightᵀ)`` without materializing the
    logits: ``x`` (..., H), ``weight`` (V, H) (an embedding table for a
    tied LM head), ``labels`` (...,) int; returns (...,) fp32 losses.
    Semantics of ``softmax_cross_entropy_loss(x @ weightᵀ, labels,
    ...)``. ``block_t``/``block_v`` (the TPU's tile sizes) are accepted
    and do not change the CUDA tiles."""
    if x.shape[-1] != weight.shape[-1]:
        raise ValueError(f"hidden mismatch: x {tuple(x.shape)} vs weight "
                         f"{tuple(weight.shape)}")
    if num_classes is not None and not 0 < num_classes <= weight.shape[0]:
        raise ValueError(f"num_classes {num_classes} must be in "
                         f"(0, {weight.shape[0]}]")
    if x.dtype != weight.dtype:
        dt = torch.promote_types(x.dtype, weight.dtype)
        x, weight = x.to(dt), weight.to(dt)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    k = weight.shape[0] if num_classes is None else int(num_classes)
    if plain_autodiff():
        loss = _plain_fwd(x2, weight, labels.reshape(-1), 0, k,
                          float(smoothing), padding_idx, 0)[0]
    else:
        loss = _LinearXent.apply(x2, weight, labels.reshape(-1),
                                 float(smoothing), padding_idx, k)
    return loss.reshape(lead)
