"""Chunked preference and distillation losses that never materialize the
logits (the port of ``apex1_tpu/ops/chunked_loss.py``).

- ``chunked_logprob``: per-token log p(target), one `shard_stats_packed`
  call per vocab chunk (the linear-xent forward kernel, packed mode)
  merged online; its backward re-runs `shard_grads` per chunk with the
  negated cotangent (the dx and dW kernels) and writes each chunk's dW
  into its rows of a (V, H) buffer. The last chunk is ragged, not
  padded: the kernels mask its missing rows. On CPU tensors the same
  calls take the kernels' plain versions.
- ``chunked_dpo_loss`` / ``chunked_orpo_loss``: preference losses built
  on ``chunked_logprob`` by ordinary autograd.
- ``chunked_kl_loss``: streamed KL(teacher ‖ student) in plain PyTorch
  (the JAX package has no kernel for it either): one pass carries both
  models' online-softmax statistics and the two cross moments, and the
  backward recomputes each chunk.

Chunk geometry: ``chunk_v`` a multiple of 128 (``check_chunk_geometry``
raises otherwise, as the JAX package does) and within the card's budget
under `vmem_model.chunked_loss_check` (the chunk rides the linear-xent
kernels, whose shared-memory and register frames it prices); an
explicit ``chunk_v`` > the tuning table's ``chunked_loss`` entry for
the padded hidden size > ``min(ceil128(V), 8192)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from apex1_tpu_torch import tuning
from apex1_tpu_torch.core.capability import smem_budget
from apex1_tpu_torch.ops._common import NEG_INF
from apex1_tpu_torch.ops.linear_xent import shard_grads, shard_stats_packed
from apex1_tpu_torch.vmem_model import chunked_loss_check

_LANES = 128


def _ceil_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def check_chunk_geometry(chunk_v: int, hidden: int = _LANES,
                         esize: int = 2) -> int:
    """Validate a vocab chunk loudly: a multiple of 128, and the
    linear-xent kernels it rides within the card's budget at ``hidden``
    and ``esize`` (`vmem_model.chunked_loss_check`)."""
    if chunk_v < _LANES or chunk_v % _LANES:
        raise ValueError(
            f"chunked_loss: chunk_v={chunk_v} must be a multiple of "
            f"{_LANES} (vocab tiles are lane-aligned)")
    fits, est = chunked_loss_check({"chunk_v": chunk_v},
                                   {"Hp": _ceil_to(hidden, _LANES)}, esize,
                                   smem_budget())
    if not fits:
        raise ValueError(f"chunked_loss: chunk_v={chunk_v} at H={hidden} "
                         f"prices {est.smem} B of shared memory a block, "
                         f"past the budget {smem_budget()} B")
    return chunk_v


def _auto_chunk(V: int, chunk_v, hidden: int = _LANES,
                dtype=torch.float32) -> int:
    """Resolve chunk_v: explicit (checked) > the tuning table's entry for
    the padded hidden size > the heuristic."""
    if chunk_v is not None:
        return check_chunk_geometry(int(chunk_v), hidden,
                                    tuning.itemsize(dtype))
    return tuning.resolve(
        "chunked_loss", None, lambda: {"Hp": tuning.padded_lanes(hidden)},
        dtype, lambda: {"chunk_v": min(_ceil_to(V, _LANES), 8192)}
    )[0]["chunk_v"]


def _chunks(V: int, cv: int) -> int:
    return -(-V // cv)


# ---- chunked_logprob ------------------------------------------------------


def _merge_stats(m, l, tgt, mc, lc, tc):
    """Online-softmax merge of one chunk's (m, l) into the running pair;
    tgt is exact per chunk (out-of-chunk labels give 0), so it sums."""
    mn = torch.maximum(m, mc)
    l = l * torch.exp(m - mn) + lc * torch.exp(mc - mn)
    return mn, l, tgt + tc


class _LogProb(torch.autograd.Function):
    """The JAX package's ``_logprob`` custom VJP: residuals (x, W,
    targets, lse); each chunk's logits are recomputed in the backward."""

    @staticmethod
    def forward(ctx, x2, weight, t2, cv, k):
        T = x2.shape[0]
        m = torch.full((T,), NEG_INF, device=x2.device)
        l = torch.zeros(T, device=x2.device)
        tgt = torch.zeros(T, device=x2.device)
        for c in range(_chunks(weight.shape[0], cv)):
            pk = shard_stats_packed(x2, weight[c * cv:(c + 1) * cv], t2,
                                    col_offset=c * cv, num_classes=k)
            m, l, tgt = _merge_stats(m, l, tgt, pk[:, 0], pk[:, 1],
                                     pk[:, 2])
        lse = m + torch.log(l)
        ctx.save_for_backward(x2, weight, t2, lse)
        ctx.args = (cv, k)
        return tgt - lse

    @staticmethod
    def backward(ctx, g):
        x2, weight, t2, lse = ctx.saved_tensors
        cv, k = ctx.args
        # loss = lse - tgt (smoothing 0) has logp = -loss, so the chunk
        # gradients take the NEGATED cotangent
        dl = (-g).float()
        dx = torch.zeros(x2.shape, dtype=torch.float32, device=x2.device)
        dw = torch.empty_like(weight)
        for c in range(_chunks(weight.shape[0], cv)):
            dxc, dw[c * cv:(c + 1) * cv] = shard_grads(
                x2, weight[c * cv:(c + 1) * cv], t2, lse, dl,
                col_offset=c * cv, num_classes=k)
            dx += dxc.float()
        return dx.to(x2.dtype), dw, None, None, None


def chunked_logprob(x, weight, targets, *, chunk_v=None, num_classes=None,
                    block_t=None, block_v=None):
    """Per-token ``log p(target)`` of ``softmax(x @ weightᵀ)`` without a
    logits tensor: ``x`` (..., H), ``weight`` (V, H), ``targets`` (...,)
    int. Returns (...,) fp32, differentiable in ``x`` and ``weight``.
    ``block_t``/``block_v`` are accepted for the JAX signature and do not
    change the CUDA tiles."""
    lead = targets.shape
    H = x.shape[-1]
    x2 = x.reshape(-1, H)
    t2 = targets.reshape(-1).to(torch.int32)
    cv = _auto_chunk(weight.shape[0], chunk_v, H, x.dtype)
    k = weight.shape[0] if num_classes is None else int(num_classes)
    return _LogProb.apply(x2, weight, t2, cv, k).reshape(lead)


# ---- preference losses ----------------------------------------------------


def _seq_logp(hidden, weight, targets, padding_idx, kw):
    lp = chunked_logprob(hidden, weight, targets, **kw)
    if padding_idx is not None:
        mask = (targets != padding_idx).float()
    else:
        mask = torch.ones(targets.shape, device=lp.device)
    return (lp * mask).sum(dim=-1), mask.sum(dim=-1)


def chunked_dpo_loss(hidden_chosen, hidden_rejected, weight,
                     targets_chosen, targets_rejected,
                     ref_chosen_logp, ref_rejected_logp, *,
                     beta: float = 0.1, padding_idx=None, num_classes=None,
                     chunk_v=None, block_t=None, block_v=None):
    """DPO loss (Rafailov et al.) over chunked per-sequence logps:
    ``hidden_*`` (B, S, H) policy hidden states, ``targets_*`` (B, S)
    int, ``ref_*_logp`` (B,) precomputed reference sequence logps
    (``chunked_logprob`` under ``torch.no_grad``). Returns the scalar
    mean ``-log σ(β·((π_c - π_r) - (ref_c - ref_r)))``."""
    kw = dict(num_classes=num_classes, chunk_v=chunk_v)
    seq_c, _ = _seq_logp(hidden_chosen, weight, targets_chosen,
                         padding_idx, kw)
    seq_r, _ = _seq_logp(hidden_rejected, weight, targets_rejected,
                         padding_idx, kw)
    margin = beta * ((seq_c - seq_r)
                     - (ref_chosen_logp - ref_rejected_logp))
    return -F.logsigmoid(margin).mean()


def _log_odds(avg_logp):
    """log(p / (1 - p)) from an average token logp, clamped away from
    the p -> 1 pole."""
    p = torch.clamp(torch.exp(avg_logp), max=1.0 - 1e-6)
    return avg_logp - torch.log1p(-p)


def chunked_orpo_loss(hidden_chosen, hidden_rejected, weight,
                      targets_chosen, targets_rejected, *,
                      lam: float = 0.1, padding_idx=None, num_classes=None,
                      chunk_v=None, block_t=None, block_v=None):
    """ORPO (Hong et al.): chosen NLL plus λ times the odds-ratio
    penalty, both from chunked logps (no reference model). Returns the
    scalar ``mean(NLL_c) + λ·mean(-log σ(log-odds(avg_c) -
    log-odds(avg_r)))``."""
    kw = dict(num_classes=num_classes, chunk_v=chunk_v)
    seq_c, len_c = _seq_logp(hidden_chosen, weight, targets_chosen,
                             padding_idx, kw)
    seq_r, len_r = _seq_logp(hidden_rejected, weight, targets_rejected,
                             padding_idx, kw)
    len_c = torch.clamp(len_c, min=1.0)
    len_r = torch.clamp(len_r, min=1.0)
    nll = -seq_c / len_c
    ratio = _log_odds(seq_c / len_c) - _log_odds(seq_r / len_r)
    return nll.mean() + lam * (-F.logsigmoid(ratio)).mean()


# ---- streamed KL distillation ---------------------------------------------


def _kl_chunk(xsf, xtf, ws, wt, c, cv, k):
    """One chunk's student and teacher logits (already / temperature)
    and the validity of its columns."""
    wsc = ws[c * cv:(c + 1) * cv].float()
    ss = xsf @ wsc.t()
    st = xtf @ wt[c * cv:(c + 1) * cv].float().t()
    gcol = c * cv + torch.arange(ss.shape[1], device=ss.device)[None, :]
    return ss, st, wsc, gcol < k


class _KL(torch.autograd.Function):
    """The JAX package's ``_kl`` custom VJP: residuals (student and
    teacher inputs, both lse); the teacher gets zero cotangents."""

    @staticmethod
    def forward(ctx, xs2, ws, xt2, wt, cv, k, temp):
        T = xs2.shape[0]
        dev = xs2.device
        xsf = xs2.float() / temp
        xtf = xt2.float() / temp
        neg = torch.full((T,), NEG_INF, device=dev)
        zero = torch.zeros(T, device=dev)
        m_s, l_s, m_t, l_t, u_tt, u_ts = neg, zero, neg, zero, zero, zero
        for c in range(_chunks(ws.shape[0], cv)):
            ss, st, _, valid = _kl_chunk(xsf, xtf, ws, wt, c, cv, k)
            ssm = torch.where(valid, ss, NEG_INF)
            stm = torch.where(valid, st, NEG_INF)
            mn_s = torch.maximum(m_s, ssm.amax(dim=1))
            l_s = (l_s * torch.exp(m_s - mn_s)
                   + torch.where(valid, torch.exp(ssm - mn_s[:, None]),
                                 0.0).sum(dim=1))
            mn_t = torch.maximum(m_t, stm.amax(dim=1))
            corr = torch.exp(m_t - mn_t)
            e_t = torch.where(valid, torch.exp(stm - mn_t[:, None]), 0.0)
            l_t = l_t * corr + e_t.sum(dim=1)
            # cross moments under the teacher measure, exp-corrected like l_t
            u_tt = u_tt * corr + (e_t * torch.where(valid, st, 0.0)).sum(1)
            u_ts = u_ts * corr + (e_t * torch.where(valid, ss, 0.0)).sum(1)
            m_s, m_t = mn_s, mn_t
        lse_s = m_s + torch.log(l_s)
        lse_t = m_t + torch.log(l_t)
        # KL = Σ_v p_t (s_t - s_s) - lse_t + lse_s, Σ p_t s_• = u_t• / l_t
        kl = (u_tt - u_ts) / l_t - lse_t + lse_s
        ctx.save_for_backward(xs2, ws, xt2, wt, lse_s, lse_t)
        ctx.args = (cv, k, temp)
        return kl

    @staticmethod
    def backward(ctx, g):
        xs2, ws, xt2, wt, lse_s, lse_t = ctx.saved_tensors
        cv, k, temp = ctx.args
        xsf = xs2.float() / temp
        xtf = xt2.float() / temp
        xs_raw = xs2.float()
        gl = (g.float() / temp)[:, None]
        dx = torch.zeros(xs2.shape, dtype=torch.float32, device=xs2.device)
        dw = torch.empty(ws.shape, dtype=torch.float32, device=xs2.device)
        for c in range(_chunks(ws.shape[0], cv)):
            ss, st, wsc, valid = _kl_chunk(xsf, xtf, ws, wt, c, cv, k)
            ps = torch.where(valid, torch.exp(ss - lse_s[:, None]), 0.0)
            pt = torch.where(valid, torch.exp(st - lse_t[:, None]), 0.0)
            gt = (ps - pt) * gl  # dKL/ds_s = p_s - p_t, scaled by g / T
            dw[c * cv:(c + 1) * cv] = gt.t() @ xs_raw
            dx += gt @ wsc
        # the teacher is stop-grad by construction: zero cotangents
        return (dx.to(xs2.dtype), dw.to(ws.dtype),
                torch.zeros_like(xt2), torch.zeros_like(wt), None, None,
                None)


def chunked_kl_loss(student_hidden, student_weight, teacher_hidden,
                    teacher_weight, *, temperature: float = 1.0,
                    num_classes=None, chunk_v=None):
    """Per-token ``KL(teacher ‖ student)`` over temperature-scaled heads,
    streamed a vocab chunk at a time: ``*_hidden`` (..., H),
    ``*_weight`` (V, H); returns (...,) fp32. The teacher is stop-grad
    (zero cotangents); the student's backward recomputes both chunks."""
    lead = student_hidden.shape[:-1]
    H = student_hidden.shape[-1]
    if teacher_weight.shape[0] != student_weight.shape[0]:
        raise ValueError(
            f"chunked_kl_loss: student V={student_weight.shape[0]} != "
            f"teacher V={teacher_weight.shape[0]} (distill over one vocab)")
    xs2 = student_hidden.reshape(-1, H)
    xt2 = teacher_hidden.reshape(-1, teacher_hidden.shape[-1])
    cv = _auto_chunk(student_weight.shape[0], chunk_v, H,
                     student_hidden.dtype)
    k = student_weight.shape[0] if num_classes is None else int(num_classes)
    kl = _KL.apply(xs2, student_weight, xt2, teacher_weight, cv, k,
                   float(temperature))
    return kl.reshape(lead)
