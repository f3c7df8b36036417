"""RNN-T transducer joint and loss (the port of
``apex1_tpu/contrib/transducer.py``; reference
``apex/contrib/transducer``).

- `transducer_joint`: the broadcast sum f (B, T, H) + g (B, U, H) ->
  (B, T, U, H), with an optional ReLU and dropout. The dropout mask is
  drawn from a ``torch.Generator`` (an int seed or a generator), not
  from ``jax.random.bernoulli``: the port cannot draw JAX's mask, so its
  keep rate and 1 / (1 - p) scale are what it shares with JAX (a
  difference by design). Packed varlen output is not
  supported, as in the JAX package: lengths are honoured in the loss.
- `transducer_loss`: the forward α recursion
  α[t, u] = logaddexp(α[t-1, u] + blank[t-1, u], α[t, u-1] + emit[t, u-1])
  as the JAX package computes it: each row t a first-order recurrence
  along u in the (log, +) semiring, solved by an inclusive scan of the
  compose (a1 + a2, logaddexp(b2, a2 + b1)) in log2 U doubling steps
  (a cumulative-sum rewrite would add the -1e30 sentinels together and
  can reach inf - inf), a loop over t. Gradients are autograd's through
  the scans.

Losses are per-utterance negative log-likelihoods; ``f_len`` / ``y_len``
give the valid time steps and target lengths.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

NEG = -1e30


def transducer_joint(f: torch.Tensor, g: torch.Tensor, *, relu: bool = False,
                     dropout: float = 0.0,
                     dropout_rng: Union[int, torch.Generator, None] = None,
                     deterministic: bool = True) -> torch.Tensor:
    """``f`` (B, T, H) audio encodings, ``g`` (B, U, H) text predictions:
    (B, T, U, H). Dropout (``dropout`` > 0 and not ``deterministic``)
    keeps each element with probability 1 - p, drawn from
    ``dropout_rng`` (an int seed or a ``torch.Generator`` on h's
    device), and scales the kept ones by 1 / (1 - p)."""
    h = f[:, :, None, :] + g[:, None, :, :]
    if relu:
        h = F.relu(h)
    if dropout > 0.0 and not deterministic:
        if dropout_rng is None:
            raise ValueError("dropout needs dropout_rng (an int seed or a "
                             "torch.Generator)")
        gen = dropout_rng
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=h.device).manual_seed(int(gen))
        keep = torch.rand(h.shape, generator=gen, device=h.device) \
            < 1.0 - dropout
        h = torch.where(keep, h / (1.0 - dropout), 0.0)
    return h


def _row_recurrence(base: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """x[u] = logaddexp(base[u], x[u-1] + coeff[u]) along the last axis:
    the inclusive scan of the affine maps x -> logaddexp(b, a + x),
    composed as (a1 + a2, logaddexp(b2, a2 + b1)), in log2 U doubling
    steps (each element composed with the one ``d`` before it)."""
    a, b = coeff, base
    U = a.shape[-1]
    d = 1
    while d < U:
        a_new = torch.cat([a[..., :d], a[..., :-d] + a[..., d:]], dim=-1)
        b_new = torch.cat([b[..., :d], torch.logaddexp(
            b[..., d:], a[..., d:] + b[..., :-d])], dim=-1)
        a, b = a_new, b_new
        d *= 2
    return b


def transducer_loss(logits: torch.Tensor, targets: torch.Tensor,
                    f_len: torch.Tensor, y_len: torch.Tensor, *,
                    blank_idx: int = 0,
                    reduction: str = "mean") -> torch.Tensor:
    """``logits`` (B, T, U, V) joint outputs (U = the longest target + 1);
    ``targets`` (B, U-1) label ids; ``f_len`` (B,) valid time steps;
    ``y_len`` (B,) valid target lengths. The per-utterance NLL
    (``reduction`` "none") or its "sum" or "mean"."""
    B, T, U, V = logits.shape
    dev = logits.device
    lp = torch.log_softmax(logits.float(), dim=-1)
    blank = lp[..., blank_idx]                               # (B, T, U)
    emit = torch.gather(
        lp[:, :, :-1, :], -1,
        targets.long()[:, None, :, None].expand(B, T, U - 1, 1))[..., 0]
    # no emission at u >= y_len
    u_ids = torch.arange(U - 1, device=dev)[None, None, :]
    emit = torch.where(u_ids < y_len.to(dev)[:, None, None], emit, NEG)
    head = torch.full((B, 1), NEG, device=dev)
    base0 = torch.cat([torch.zeros(B, 1, device=dev),
                       torch.full((B, U - 1), NEG, device=dev)], dim=1)
    alpha = _row_recurrence(base0, torch.cat([head, emit[:, 0]], dim=1))
    alphas = [alpha]
    for t in range(1, T):
        alpha = _row_recurrence(alpha + blank[:, t - 1],
                                torch.cat([head, emit[:, t]], dim=1))
        alphas.append(alpha)
    alphas = torch.stack(alphas)                              # (T, B, U)
    # ll = α[f_len-1, y_len] + blank[f_len-1, y_len]
    t_last = torch.clamp(f_len.to(dev).long() - 1, 0, T - 1)
    u_last = torch.clamp(y_len.to(dev).long(), 0, U - 1)
    b_ids = torch.arange(B, device=dev)
    nll = -(alphas[t_last, b_ids, u_last] + blank[b_ids, t_last, u_last])
    if reduction == "none":
        return nll
    if reduction == "sum":
        return nll.sum()
    if reduction == "mean":
        return nll.mean()
    raise ValueError(f"unknown reduction {reduction!r}")


class TransducerJoint:
    """``apex.contrib.transducer.TransducerJoint``: ``pack_output`` is
    accepted for the signature and raises, as in the JAX package (mask
    with the loss's ``f_len``/``y_len`` instead)."""

    def __init__(self, pack_output: bool = False, relu: bool = False,
                 dropout: float = 0.0):
        if pack_output:
            raise NotImplementedError(
                "packed varlen output is not supported (the JAX package "
                "has none either): mask through transducer_loss's "
                "f_len/y_len")
        self.relu = relu
        self.dropout = dropout

    def __call__(self, f, g, *, dropout_rng=None, deterministic=True):
        return transducer_joint(f, g, relu=self.relu, dropout=self.dropout,
                                dropout_rng=dropout_rng,
                                deterministic=deterministic)


class TransducerLoss:
    """``apex.contrib.transducer.TransducerLoss(blank_idx, reduction)``."""

    def __init__(self, blank_idx: int = 0, reduction: str = "mean"):
        self.blank_idx = blank_idx
        self.reduction = reduction

    def __call__(self, logits, targets, f_len, y_len):
        return transducer_loss(logits, targets, f_len, y_len,
                               blank_idx=self.blank_idx,
                               reduction=self.reduction)
