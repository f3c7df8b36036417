"""Flash attention (the port of ``apex1_tpu/ops/attention.py``).

    s   = q·kᵀ·scale (+ bias), invalid positions NEG_INF (finite)
    out = softmax(s)·v, lse = logsumexp(s); a row with no valid key
          gives out 0 and lse NEG_INF
    backward from (q, k, v, out, lse): p = exp(s - lse) on valid
          positions, δ = Σ_d dout·out, ds = p·(dO·vᵀ - δ + dlse)·scale,
          dq = ds·k, dk = dsᵀ·q, dv = pᵀ·dO, and with a bias
          dbias = Σ over its broadcast dims of p·(dO·vᵀ - δ + dlse)

Shapes as in the JAX package: ``q`` (B, Hq, Sq, D), ``k``/``v``
(B, Hkv, Sk, D) with ``Hq % Hkv == 0`` (GQA without a repeated K/V),
``lse`` fp32 (B, Hq, Sq). A position is valid when it is inside Sq/Sk,
causal ⇒ ``k + k_offset <= q + q_offset``, and with segments the query's
and key's segment ids are equal.

Four kernels in ``csrc/flash_attn.cu`` (TPU rows 3-6), each beside its
plain PyTorch version with the same signature, which materializes the
scores: :func:`flash_fwd`, :func:`flash_dq`, :func:`flash_dkv` and
:func:`flash_dbias`; and the forward's merge mode, :func:`flash_fwd_merge`
(TPU row 26, the all-gather flash attention's ring step: the shard's
output merged into a carried fp32 (out, lse) in the epilogue). As
in the kernels, the plain backward rounds p and dS to the operand type
before their products; the plain forward keeps the probabilities in
fp32 (the kernel rounds e = exp(s - m) against a running max, which a
materialized softmax cannot reproduce), so in bf16/fp16 the forward
agrees to about one rounding of the output.
`flash_attention` and `fmha` are differentiable through one
``torch.autograd.Function`` (the JAX package's ``_flash`` and
``_flash_with_bias`` custom VJPs) that saves ``(q, k, v, out, lse)``
and the bias; the CPU and ``force_impl("torch")`` go through the same
Function with the plain versions (``force_impl("autodiff")``: autograd
through the plain forward instead, for FLOP counts).

Attention-probability dropout (``dropout_p > 0`` with an int32
``dropout_seed``) rides all three kernels: keep = `attn_keep_mask`'s
hash at (seed, b·Hq + h, q row + q_offset, k col + k_offset), h the
query head. The softmax statistics (l, lse) stay undropped; the P·V
weights are keep·p/(1 - p), and the backward masks dP the same way, so
the Function saves the seed and p, never a mask.

The additive ``bias`` (T5's relative-position table, `multihead_attn`'s
masks) is (1|B, 1|Hq, Sq, Sk), broadcast over a size-1 batch or head
dimension; every kernel reads it as fp32 (a wrapper casts another dtype
once) and adds it to the scaled score before the mask, as the JAX
package's ``_xla_attention``. Its gradient, ``flash_dbias`` (TPU row
6), sums over the broadcast dimensions in fp32 and is cast back to the
bias's dtype; the backward launches it only when the bias takes a
gradient.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from apex1_tpu_torch.ops import _build
from apex1_tpu_torch.ops._common import (DTYPE_CODES, NEG_INF, check_cuda,
                                         plain_autodiff, use_kernel)
from apex1_tpu_torch.ops.stochastic import (_seed_word, attn_keep_mask,
                                            inv_keep, threshold_u32)

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_MAX_D = 128


# ---- plain versions ------------------------------------------------------


def _valid(B, Sq, Sk, qseg, kseg, causal, q_off, k_off, device):
    """(B or 1, 1, Sq, Sk) bool: the positions a query may attend."""
    row = torch.arange(Sq, device=device)[:, None]
    col = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones(1, 1, Sq, Sk, dtype=torch.bool, device=device)
    if causal:
        mask = mask & ((col + k_off) <= (row + q_off))
    if qseg is not None:
        mask = mask & (qseg[:, None, :, None] == kseg[:, None, None, :])
    return mask


def _repeat_kv(x, group: int):
    """(B, Hkv, S, D) -> (B, Hq, S, D), q head h reading kv head
    h // group (``jnp.repeat`` along the head axis)."""
    return x if group == 1 else x.repeat_interleave(group, dim=1)


def _keep(q, Sk, q_off, k_off, dropout_p, seed):
    """(B, Hq, Sq, Sk) bool keep mask of the dropout, or None at p = 0."""
    if dropout_p <= 0.0:
        return None
    B, Hq, Sq, _ = q.shape
    rows = torch.arange(Sq, device=q.device)[:, None] + q_off
    cols = torch.arange(Sk, device=q.device)[None, :] + k_off
    return attn_keep_mask(seed, B, Hq, rows, cols, dropout_p)


def _scores(q, k, qseg, kseg, scale, causal, q_off, k_off, bias=None):
    """fp32 masked scores (NEG_INF where invalid) and the mask; a bias
    is added to the scaled scores before the mask."""
    B, Hq, Sq, _ = q.shape
    Sk = k.shape[2]
    kk = _repeat_kv(k.float(), Hq // k.shape[1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    if bias is not None:
        s = s + bias.float()
    mask = _valid(B, Sq, Sk, qseg, kseg, causal, q_off, k_off, q.device)
    return torch.where(mask, s, NEG_INF), mask


def _plain_fwd(q, k, v, qseg, kseg, scale, causal, q_off, k_off,
               dropout_p=0.0, seed=None, bias=None):
    """The JAX package's ``_xla_attention`` (its empty-row rule, its
    bias and its dropout too: fp32 probabilities, dropped and rescaled
    after the normalization): ``(out in q's dtype, lse fp32)``."""
    sm, mask = _scores(q, k, qseg, kseg, scale, causal, q_off, k_off, bias)
    m = sm.amax(dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(sm - m), 0.0)
    l = e.sum(dim=-1, keepdim=True)
    safe = torch.where(l > 0, l, 1.0)
    probs = e / safe
    keep = _keep(q, k.shape[2], q_off, k_off, dropout_p, seed)
    if keep is not None:
        probs = torch.where(keep, probs * inv_keep(dropout_p), 0.0)
    vv = _repeat_kv(v.float(), q.shape[1] // v.shape[1])
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vv).to(q.dtype)
    lse = torch.where(l > 0, m + torch.log(safe), NEG_INF)[..., 0]
    return out, lse


def _probs_and_ds(q, k, v, dout, lse, delta, dlse, qseg, kseg, scale,
                  causal, q_off, k_off, dropout_p, seed, bias=None):
    """The P·V weights (p = exp(s - lse) on valid positions, 0
    elsewhere; with dropout keep·p/(1 - p)) and the gradient of the full
    logit p·(keep·dO·vᵀ/(1 - p) - δ + dlse) (ds before its ·scale),
    both fp32 (B, Hq, Sq, Sk)."""
    sm, mask = _scores(q, k, qseg, kseg, scale, causal, q_off, k_off, bias)
    p = torch.where(mask, torch.exp(sm - lse[..., None]), 0.0)
    vv = _repeat_kv(v.float(), q.shape[1] // v.shape[1])
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), vv)
    keep = _keep(q, k.shape[2], q_off, k_off, dropout_p, seed)
    p_av = p
    if keep is not None:
        inv = inv_keep(dropout_p)
        dp = torch.where(keep, dp * inv, 0.0)
        p_av = torch.where(keep, p * inv, 0.0)
    dp = dp - delta[..., None]
    if dlse is not None:
        dp = dp + dlse[..., None]
    return p_av, p * dp


def _rounded(x, dtype):
    """fp32 ``x`` rounded to ``dtype`` and back: the backward kernels
    (as the TPU's) feed p and dS to their products in the operand
    type."""
    return x.to(dtype).float()


def _plain_dq(q, k, v, dout, lse, delta, dlse, qseg, kseg, scale, causal,
              q_off, k_off, dropout_p=0.0, seed=None, bias=None):
    _, dsu = _probs_and_ds(q, k, v, dout, lse, delta, dlse, qseg, kseg,
                           scale, causal, q_off, k_off, dropout_p, seed,
                           bias)
    kk = _repeat_kv(k.float(), q.shape[1] // k.shape[1])
    return torch.einsum("bhqk,bhkd->bhqd", _rounded(dsu * scale, k.dtype),
                        kk).to(q.dtype)


def _plain_dkv(q, k, v, dout, lse, delta, dlse, qseg, kseg, scale, causal,
               q_off, k_off, dropout_p=0.0, seed=None, bias=None,
               out_dtype=None):
    p, dsu = _probs_and_ds(q, k, v, dout, lse, delta, dlse, qseg, kseg,
                           scale, causal, q_off, k_off, dropout_p, seed,
                           bias)
    ds = dsu * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", _rounded(p, dout.dtype),
                      dout.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", _rounded(ds, q.dtype), q.float())
    B, Hkv, Sk, D = k.shape
    group = q.shape[1] // Hkv
    if group > 1:
        dk = dk.reshape(B, Hkv, group, Sk, D).sum(dim=2)
        dv = dv.reshape(B, Hkv, group, Sk, D).sum(dim=2)
    return dk.to(out_dtype or k.dtype), dv.to(out_dtype or v.dtype)


def _plain_dbias(q, k, v, dout, lse, delta, dlse, qseg, kseg, scale,
                 causal, q_off, k_off, dropout_p, seed, bias):
    """fp32 dbias like ``bias``: the full logit's gradient summed over
    the dimensions the bias broadcasts along."""
    _, dsu = _probs_and_ds(q, k, v, dout, lse, delta, dlse, qseg, kseg,
                           scale, causal, q_off, k_off, dropout_p, seed,
                           bias)
    dims = tuple(d for d in (0, 1) if bias.shape[d] == 1 and
                 dsu.shape[d] != 1)
    return dsu.sum(dim=dims, keepdim=True) if dims else dsu


# ---- kernel wrappers -----------------------------------------------------


def _check_bias(bias, q, k) -> None:
    """The JAX package's bias checks: (1|B, 1|Hq, Sq, Sk), else a
    ValueError naming the bias."""
    B, Hq, Sq = q.shape[0], q.shape[1], q.shape[2]
    Sk = k.shape[2]
    if bias.dim() != 4:
        raise ValueError(f"bias must be (1|B, 1|H, Sq, Sk), got rank "
                         f"{bias.dim()}")
    if (bias.shape[0] not in (1, B) or bias.shape[1] not in (1, Hq)
            or tuple(bias.shape[2:]) != (Sq, Sk)):
        raise ValueError(f"bias shape {tuple(bias.shape)} must be "
                         f"(1|{B}, 1|{Hq}, {Sq}, {Sk})")


def _bias_operand(bias, q, k):
    """The bias as the kernels read it: checked, fp32, contiguous (one
    cast for another dtype); None stays None."""
    if bias is None:
        return None
    _check_bias(bias, q, k)
    return bias.to(torch.float32).contiguous()


def _bias_dims(bias):
    """The kernels' (Bb, Hb) arguments (1, 1 without a bias)."""
    return (1, 1) if bias is None else (bias.shape[0], bias.shape[1])


def _kernel_operands(name, q, k, v, dout, *rest):
    """Contiguous operands after the shared checks, and the ``vec`` flag
    (16-byte loads: D fills the kernel's padded width 64 or 128 and the
    tiles' operands are 16-byte aligned)."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k, v must share one of f32/bf16/f16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if (q.dim() != 4 or k.shape != v.shape or k.shape[0] != q.shape[0]
            or k.shape[3] != q.shape[3] or q.shape[1] % k.shape[1] != 0):
        raise ValueError(f"{name}: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)} do not fit")
    if dout is not None and (dout.shape != q.shape or dout.dtype != q.dtype):
        raise ValueError(f"{name}: dout must be like q")
    D = q.shape[3]
    if D > _MAX_D:
        raise ValueError(f"{name}: head dim {D} > {_MAX_D} is not supported")
    ops = [None if t is None else t.contiguous()
           for t in (q, k, v, dout, *rest)]
    check_cuda(name, *ops)
    vec = D in (64, 128) and all(t.data_ptr() % 16 == 0
                                 for t in ops[:4] if t is not None)
    return ops, int(vec)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _dims(q, k):
    B, Hq, Sq, D = q.shape
    return B, Hq, k.shape[1], Sq, k.shape[2], D


def _drop_args(dropout_p, seed):
    """The kernels' (dropout, seed word, threshold, inv) arguments."""
    if dropout_p <= 0.0:
        return 0, 0, 0, 0.0
    return (1, _seed_word(seed), threshold_u32(dropout_p),
            inv_keep(dropout_p))


def flash_fwd(q, k, v, qseg, kseg, scale: float, causal: bool,
              q_off: int = 0, k_off: int = 0, dropout_p: float = 0.0,
              dropout_seed=None, *, bias=None):
    """``(out, lse)``: out in q's dtype, lse fp32 (B, Hq, Sq). ``qseg``
    (B, Sq) and ``kseg`` (B, Sk) int32, or both None; ``dropout_p`` > 0
    drops P·V weights with the int32 ``dropout_seed``; ``bias``
    (1|B, 1|Hq, Sq, Sk) is added to the scaled scores. CUDA tensors
    launch the kernel (``flash_fwd.launches``); CPU tensors take the
    plain version."""
    bias = _bias_operand(bias, q, k)
    if not use_kernel(q):
        return _plain_fwd(q, k, v, qseg, kseg, scale, causal, q_off, k_off,
                          dropout_p, dropout_seed, bias)
    (q, k, v, _, qseg, kseg, bias), vec = _kernel_operands(
        "flash_fwd", q, k, v, None, qseg, kseg, bias)
    B, Hq, Hkv, Sq, Sk, D = _dims(q, k)
    out = torch.empty_like(q)
    lse = torch.empty(B, Hq, Sq, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.launch("apex1_flash_fwd", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), _ptr(qseg), _ptr(kseg), _ptr(bias),
                  out.data_ptr(), lse.data_ptr(), B, Hq, Hkv, Sq, Sk, D,
                  *_bias_dims(bias), float(scale), int(causal), int(q_off),
                  int(k_off), vec, *_drop_args(dropout_p, dropout_seed),
                  DTYPE_CODES[q.dtype], stream)
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.logaddexp`` as JAX writes it: max + log1p(exp(-|a - b|)),
    a + b where a - b is nan."""
    delta = a - b
    return torch.where(torch.isnan(delta), a + b,
                       torch.maximum(a, b)
                       + torch.log1p(torch.exp(-delta.abs())))


def merge_partials(out_a, lse_a, out_b, lse_b):
    """The exact combine of two normalized partial attentions (the JAX
    package's ``ring_attention._merge``): lse = logaddexp(lse_a, lse_b),
    out = out_a·exp(lse_a - lse) + out_b·exp(lse_b - lse), ``out_b``
    widened to ``out_a``'s dtype."""
    lse = logaddexp(lse_a, lse_b)
    w_a = torch.exp(lse_a - lse)[..., None]
    w_b = torch.exp(lse_b - lse)[..., None]
    return out_a * w_a + out_b.to(out_a.dtype) * w_b, lse


def flash_fwd_merge(q, k, v, qseg, kseg, scale: float, causal: bool,
                    q_off: int, k_off: int, prev_out: torch.Tensor,
                    prev_lse: torch.Tensor):
    """One ring step of the all-gather flash attention: this shard's
    flash forward merged into the carried ``(prev_out, prev_lse)`` (fp32
    (B, Hq, Sq, D) and (B, Hq, Sq)); returns the merged ``(out, lse)``,
    both fp32. The shard's output is rounded to q's dtype before the
    merge, as `flash_fwd` returns it. No bias, no dropout. CUDA tensors
    launch the forward kernel with its merge epilogue
    (``flash_fwd_merge.launches``); CPU tensors take the plain version,
    `flash_fwd`'s followed by `merge_partials`."""
    if prev_out.shape != q.shape or prev_lse.shape != q.shape[:3]:
        raise ValueError(f"flash_fwd_merge: the carried out "
                         f"{tuple(prev_out.shape)} and lse "
                         f"{tuple(prev_lse.shape)} must match q "
                         f"{tuple(q.shape)}")
    if not use_kernel(q):
        out_t, lse_t = _plain_fwd(q, k, v, qseg, kseg, scale, causal, q_off,
                                  k_off)
        return merge_partials(prev_out.float(), prev_lse.float(), out_t,
                              lse_t)
    (q, k, v, _, qseg, kseg, prev_out, prev_lse), vec = _kernel_operands(
        "flash_fwd_merge", q, k, v, None, qseg, kseg,
        prev_out.float(), prev_lse.float())
    B, Hq, Hkv, Sq, Sk, D = _dims(q, k)
    out = torch.empty_like(prev_out)
    lse = torch.empty_like(prev_lse)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.launch("apex1_flash_fwd_merge", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), _ptr(qseg), _ptr(kseg), prev_out.data_ptr(),
                  prev_lse.data_ptr(), out.data_ptr(), lse.data_ptr(), B, Hq,
                  Hkv, Sq, Sk, D, float(scale), int(causal), int(q_off),
                  int(k_off), vec, DTYPE_CODES[q.dtype], stream)
    flash_fwd_merge.launches += 1
    return out, lse


flash_fwd_merge.launches = 0


def _bwd_operands(name, q, k, v, dout, lse, delta, dlse, qseg, kseg, bias):
    """The backward kernels' operands after the shared checks, the
    leading pointers of their entry points (q through bias) and the
    ``vec`` flag."""
    ops, vec = _kernel_operands(name, q, k, v, dout, lse, delta, dlse,
                                qseg, kseg, bias)
    return ops, [_ptr(t) for t in ops], vec


def _bwd_tail(q, k, bias, scale, causal, q_off, k_off, vec, dropout_p,
              dropout_seed):
    """The backward entry points' arguments after their output
    pointers."""
    return (*_dims(q, k), *_bias_dims(bias), float(scale), int(causal),
            int(q_off), int(k_off), vec,
            *_drop_args(dropout_p, dropout_seed), DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_dq(q, k, v, dout, lse, delta, dlse, qseg, kseg, scale: float,
             causal: bool, q_off: int = 0, k_off: int = 0,
             dropout_p: float = 0.0, dropout_seed=None, *, bias=None):
    """dq in q's dtype from the saved ``lse``, ``delta`` = Σ_d dout·out
    and the lse cotangent ``dlse`` (fp32 (B, Hq, Sq), or None for 0);
    ``dout`` in q's dtype; the forward's dropout and bias. CUDA tensors
    launch the kernel (``flash_dq.launches``); CPU tensors take the
    plain version."""
    bias = _bias_operand(bias, q, k)
    if not use_kernel(q):
        return _plain_dq(q, k, v, dout, lse, delta, dlse, qseg, kseg, scale,
                         causal, q_off, k_off, dropout_p, dropout_seed, bias)
    ops, ptrs, vec = _bwd_operands("flash_dq", q, k, v, dout, lse, delta,
                                   dlse, qseg, kseg, bias)
    dq = torch.empty_like(ops[0])
    _build.launch("apex1_flash_dq", *ptrs, dq.data_ptr(),
                  *_bwd_tail(ops[0], ops[1], bias, scale, causal, q_off,
                             k_off, vec, dropout_p, dropout_seed))
    flash_dq.launches += 1
    return dq


flash_dq.launches = 0


def flash_dkv(q, k, v, dout, lse, delta, dlse, qseg, kseg, scale: float,
              causal: bool, q_off: int = 0, k_off: int = 0,
              dropout_p: float = 0.0, dropout_seed=None, *, bias=None,
              out_dtype=None):
    """``(dk, dv)`` in k's dtype, or ``out_dtype=torch.float32`` (the
    ring backward's per-shard partials, which it sums over the ring
    before one rounding), each kv head summed over its GQA group (fp32
    accumulation, one rounding at the store). Arguments as `flash_dq`.
    CUDA tensors launch the kernel (``flash_dkv.launches``); CPU tensors
    take the plain version."""
    if out_dtype not in (None, k.dtype, torch.float32):
        raise ValueError(f"flash_dkv: out_dtype must be k's dtype or "
                         f"float32, got {out_dtype}")
    bias = _bias_operand(bias, q, k)
    if not use_kernel(q):
        return _plain_dkv(q, k, v, dout, lse, delta, dlse, qseg, kseg,
                          scale, causal, q_off, k_off, dropout_p,
                          dropout_seed, bias, out_dtype)
    ops, ptrs, vec = _bwd_operands("flash_dkv", q, k, v, dout, lse, delta,
                                   dlse, qseg, kseg, bias)
    f32 = out_dtype == torch.float32
    dk = torch.empty_like(ops[1], dtype=out_dtype or ops[1].dtype)
    dv = torch.empty_like(ops[2], dtype=out_dtype or ops[2].dtype)
    _build.launch("apex1_flash_dkv", *ptrs, dk.data_ptr(), dv.data_ptr(),
                  int(f32),
                  *_bwd_tail(ops[0], ops[1], bias, scale, causal, q_off,
                             k_off, vec, dropout_p, dropout_seed))
    flash_dkv.launches += 1
    return dk, dv


flash_dkv.launches = 0


def flash_dbias(q, k, v, dout, lse, delta, dlse, qseg, kseg, scale: float,
                causal: bool, q_off: int = 0, k_off: int = 0,
                dropout_p: float = 0.0, dropout_seed=None, *, bias):
    """The bias's gradient, fp32 in ``bias``'s shape (Bb, Hb, Sq, Sk):
    p·(dO·vᵀ - δ + dlse) (with dropout, dO·vᵀ masked and rescaled as in
    `flash_dq`) summed over the (b, h) each entry broadcasts to.
    Arguments as `flash_dq`, ``bias`` required. CUDA tensors launch the
    kernel (``flash_dbias.launches``; a fixed summation order and no
    atomics: equal bits on every launch); CPU tensors take the plain
    version."""
    bias = _bias_operand(bias, q, k)
    if not use_kernel(q):
        return _plain_dbias(q, k, v, dout, lse, delta, dlse, qseg, kseg,
                            scale, causal, q_off, k_off, dropout_p,
                            dropout_seed, bias)
    ops, ptrs, vec = _bwd_operands("flash_dbias", q, k, v, dout, lse, delta,
                                   dlse, qseg, kseg, bias)
    dbias = torch.empty_like(ops[-1])
    _build.launch("apex1_flash_dbias", *ptrs, dbias.data_ptr(),
                  *_bwd_tail(ops[0], ops[1], bias, scale, causal, q_off,
                             k_off, vec, dropout_p, dropout_seed))
    flash_dbias.launches += 1
    return dbias


flash_dbias.launches = 0


class _Flash(torch.autograd.Function):
    """The JAX package's ``_flash`` and ``_flash_with_bias`` custom VJPs:
    residuals ``(q, k, v, out, lse)``, the bias and the segment ids, and
    the dropout's seed and p, never its mask; the backward takes the
    ``out`` and ``lse`` cotangents, and launches dbias only when the
    bias (fp32: the caller casts) takes a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, qseg, kseg, scale, causal, q_off, k_off,
                dropout_p, seed):
        out, lse = flash_fwd(q, k, v, qseg, kseg, scale, causal, q_off,
                             k_off, dropout_p, seed, bias=bias)
        ctx.save_for_backward(q, k, v, out, lse, bias, qseg, kseg)
        ctx.args = (scale, causal, q_off, k_off, dropout_p, seed)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse, bias, qseg, kseg = ctx.saved_tensors
        dout = (torch.zeros_like(out) if dout is None
                else dout.to(q.dtype))
        # δ_i = Σ_d dout·out in fp32, outside the kernels as in JAX
        delta = (dout.float() * out.float()).sum(dim=-1)
        dlse = None if dlse is None else dlse.float()
        res = (q, k, v, dout, lse, delta, dlse, qseg, kseg, *ctx.args)
        dq = flash_dq(*res, bias=bias)
        dk, dv = flash_dkv(*res, bias=bias)
        dbias = (flash_dbias(*res, bias=bias) if ctx.needs_input_grad[3]
                 else None)
        return (dq, dk, dv, dbias, None, None, None, None, None, None, None,
                None)


def _norm_segments(segment_ids, Sq: int, Sk: int, device):
    """``(q_seg, k_seg)`` int32 tensors on ``device``, or (None, None)."""
    if segment_ids is None:
        return None, None
    if isinstance(segment_ids, (tuple, list)):
        qseg, kseg = segment_ids
    else:
        if Sq != Sk:
            raise ValueError("pass (q_seg, k_seg) when Sq != Sk")
        qseg = kseg = segment_ids

    def as_i32(s):
        return torch.as_tensor(s, device=device).to(torch.int32).contiguous()

    return as_i32(qseg), as_i32(kseg)


def flash_attention(q, k, v, *, causal: bool = False, segment_ids=None,
                    sm_scale: Optional[float] = None, q_offset=0,
                    k_offset=0, block_q: Optional[int] = None,
                    block_k: Optional[int] = None, return_lse: bool = False,
                    bias=None, dropout_p: float = 0.0, dropout_seed=None):
    """Flash attention over (B, H, S, D) operands; differentiable.

    ``segment_ids``: (B, S) ints (self-attention) or a ``(q_seg, k_seg)``
    pair; tokens attend only within equal ids (padding: -1).
    ``q_offset``/``k_offset``: integer global-position offsets for the
    causal mask. ``return_lse``: also return the fp32 logsumexp
    (B, H, Sq), whose cotangent the backward takes. ``block_q`` and
    ``block_k`` are the TPU kernels' tile sizes: accepted and ignored
    (the Hopper kernels choose their own tiles). ``bias``: an additive
    logit bias (1|B, 1|H, Sq, Sk), T5's relative positions or an
    additive mask, differentiable (its gradient through the dbias
    kernel, summed over the broadcast dimensions in fp32 and cast to
    the bias's dtype). ``dropout_p`` in [0, 1): attention-probability
    dropout in the kernels, seeded by the int32 ``dropout_seed``
    (required when p > 0; two calls with one seed draw one mask)."""
    del block_q, block_k
    dropout_p = float(dropout_p)
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    if dropout_p > 0.0 and dropout_seed is None:
        raise ValueError("dropout_p > 0 needs an explicit int32 "
                         "dropout_seed (ops.stochastic.fold_seed at the "
                         "call site)")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("expected (B, H, S, D) operands")
    if q.shape[1] % k.shape[1] != 0:
        raise ValueError(f"Hq={q.shape[1]} not a multiple of "
                         f"Hkv={k.shape[1]}")
    scale = (1.0 / math.sqrt(q.shape[-1]) if sm_scale is None
             else float(sm_scale))
    # validated for both paths and cast to fp32 once; the gradient comes
    # back in the bias's dtype through the cast
    bias = _bias_operand(bias, q, k)
    qseg, kseg = _norm_segments(segment_ids, q.shape[2], k.shape[2],
                                q.device)
    args = (scale, bool(causal), int(q_offset), int(k_offset), dropout_p,
            dropout_seed if dropout_p > 0.0 else None)
    if plain_autodiff():
        out, lse = _plain_fwd(q, k, v, qseg, kseg, *args, bias=bias)
    else:
        out, lse = _Flash.apply(q, k, v, bias, qseg, kseg, *args)
    return (out, lse) if return_lse else out


def fmha(qkv, *, segment_ids=None, causal: bool = True,
         sm_scale: Optional[float] = None, dropout_p: float = 0.0,
         dropout_seed=None):
    """``apex.contrib.fmha.FMHAFun``: packed (B, S, 3, H, D) QKV, varlen
    through ``segment_ids``, the in-kernel probability dropout through
    ``dropout_p``/``dropout_seed``; returns (B, S, H, D)."""
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    out = flash_attention(q, k, v, causal=causal, segment_ids=segment_ids,
                          sm_scale=sm_scale, dropout_p=dropout_p,
                          dropout_seed=dropout_seed)
    return out.transpose(1, 2)
