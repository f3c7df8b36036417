"""Mixture-of-Experts with expert parallelism over the ``ep`` group (the
port of ``apex1_tpu/transformer/moe.py``).

The JAX module's dataflow, op for op:

- **Router**: a dense fp32 gate, softmax, top-k (k of 1 or 2) with the
  lower expert index first among equal probabilities (``jax.lax.top_k``'s
  order; ``torch.topk`` promises none, so the choice is made here by
  repeated first-index ``argmax``); the combine weights renormalized
  over the chosen experts; the Switch load-balance aux loss
  ``w · E · Σ_e f_e · p̄_e``.
- **Capacity dispatch**: each expert takes at most ``capacity =
  ceil(capacity_factor · k · T / E)`` tokens; a token's slot is its
  exclusive fp32 ``cumsum`` position among the tokens routed there (the
  k-th choices after every (k−1)-th), so the same tokens overflow and
  drop as in JAX. Dispatch and combine are one-hot (T, E, C) tensors.
- **Expert parallelism** (`moe_shard_map_apply`): tokens sharded over the
  ep group, expert weights sharded over their leading dimension; two
  ``all_to_all_single``s route the (expert, capacity) slots to their
  expert's rank and back.

``stats_axes`` (mesh axis names or process groups) sum the router's
statistics over every group that shards one batch's tokens, so each
rank's aux is that of the whole token set. The sum is an all-reduce
whose backward is again an all-reduce, JAX's ``psum`` and its transpose.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from apex1_tpu_torch.core.mesh import AXIS_EP
from apex1_tpu_torch.ops._common import resolve_device
from apex1_tpu_torch.transformer.parallel_state import (group_size_rank,
                                                        resolve_group)
from apex1_tpu_torch.transformer.tensor_parallel import mappings as mp


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2                 # 1 = Switch, 2 = GShard-style
    capacity_factor: float = 1.25
    hidden_size: int = 64
    ffn_size: int = 256
    aux_loss_weight: float = 1e-2


def _capacity(cfg: MoEConfig, n_tokens: int) -> int:
    # ceil: capacity_factor=1.0 must not drop tokens under balanced routing
    cap = math.ceil(cfg.capacity_factor * cfg.top_k * n_tokens
                    / cfg.num_experts)
    return max(1, cap)


class _PSum(torch.autograd.Function):
    """A sum all-reduce whose backward is a sum all-reduce (``psum``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return mp.all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return mp.all_reduce(g, ctx.group), None


def psum(x: torch.Tensor, groups) -> torch.Tensor:
    """``x`` summed over each of ``groups`` (axis names or process
    groups) in turn; differentiable, JAX's ``psum``."""
    for g in groups:
        group = resolve_group(g)
        if group_size_rank(group)[0] > 1:
            x = _PSum.apply(x, group)
    return x


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last dimension: the k largest values
    in descending order, the lower index first among equals."""
    vals, idx = [], []
    work = probs
    for _ in range(k):
        i = torch.argmax(work, dim=-1)
        idx.append(i)
        vals.append(torch.gather(probs, -1, i[..., None])[..., 0])
        work = work.scatter(-1, i[..., None], float("-inf"))
    return torch.stack(vals, -1), torch.stack(idx, -1)


def _one_hot(i: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot; an index outside [0, n) gives a zero row (as
    ``jax.nn.one_hot``)."""
    return (i[..., None] == torch.arange(n, device=i.device)).float()


def router(x2, wg, cfg: MoEConfig, token_mask=None, *, stats_axes=None):
    """Top-k routing of flat tokens ``x2`` (T, H) by the gate ``wg``
    (H, E). Returns ``(dispatch (T, E, C) fp32 0/1, combine (T, E, C)
    fp32, aux scalar)``. ``token_mask`` (T,) bool: False tokens
    (padding) claim no capacity and leave the statistics. With
    ``stats_axes`` the statistics are summed over those groups first.
    Dispatch and combine stay local; capacity is per shard."""
    T = x2.shape[0]
    E, k = cfg.num_experts, cfg.top_k
    C = _capacity(cfg, T)
    logits = x2.float() @ wg.float()
    probs = torch.softmax(logits, dim=-1)              # (T, E)
    gate_vals, gate_idx = top_k(probs, k)              # (T, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)
    mask = (torch.ones((T,), dtype=torch.float32, device=x2.device)
            if token_mask is None else token_mask.float())

    # Switch aux loss over the TOP-1 assignment fraction (valid tokens)
    top1_hot = _one_hot(gate_idx[:, 0], E) * mask[:, None]
    n_sum = mask.sum()
    f_sum = top1_hot.sum(0)                            # count per expert
    p_sum = (probs * mask[:, None]).sum(0)             # prob mass
    if stats_axes is not None:
        n_sum, f_sum, p_sum = (psum(v, stats_axes)
                               for v in (n_sum, f_sum, p_sum))
    n_valid = torch.clamp(n_sum, min=1.0)
    f = f_sum / n_valid
    p = p_sum / n_valid
    aux = cfg.aux_loss_weight * E * (f * p).sum()

    dispatch = torch.zeros((T, E, C), dtype=torch.float32, device=x2.device)
    combine = torch.zeros_like(dispatch)
    # k-th choices claim capacity after all (k-1)-th choices (GShard
    # order); positions by an exclusive cumsum per expert
    used = torch.zeros((E,), dtype=torch.float32, device=x2.device)
    for j in range(k):
        hot = _one_hot(gate_idx[:, j], E) * mask[:, None]   # (T, E)
        pos = (torch.cumsum(hot, 0) - hot) + used[None, :]  # (T, E)
        within = (pos < C) & (hot > 0)
        pos_c = _one_hot(pos.to(torch.int64), C) * within[..., None]
        dispatch = dispatch + hot[..., None] * pos_c
        combine = combine + (gate_vals[:, j, None, None]
                             * hot[..., None] * pos_c)
        used = used + (hot * within).sum(0)
    return dispatch, combine, aux


def _experts(xe, w1, w2, act, dtype):
    h = act(torch.einsum("ech,ehf->ecf", xe, w1.to(dtype)))
    return torch.einsum("ecf,efh->ech", h, w2.to(dtype))


class MoEMLP(nn.Module):
    """The dense-dispatch MoE FFN: stacked expert weights ``w1`` (E, H,
    F) and ``w2`` (E, F, H) and the fp32 ``router`` (H, E), named as the
    flax module's; ``forward(x, token_mask=None) -> (y, aux)``.
    Parameters are zeros: load them (`interop`) or draw them."""

    def __init__(self, cfg: MoEConfig, dtype=torch.float32,
                 act: Callable = gelu, device=None):
        super().__init__()
        self.cfg, self.dtype, self.act = cfg, dtype, act
        E, H, Fs = cfg.num_experts, cfg.hidden_size, cfg.ffn_size
        kw = dict(dtype=torch.float32, device=resolve_device(device))
        self.router = nn.Parameter(torch.zeros((H, E), **kw))
        self.w1 = nn.Parameter(torch.zeros((E, H, Fs), **kw))
        self.w2 = nn.Parameter(torch.zeros((E, Fs, H), **kw))

    def forward(self, x, token_mask=None):
        lead, H = x.shape[:-1], x.shape[-1]
        x2 = x.reshape(-1, H)
        if token_mask is not None:
            token_mask = token_mask.reshape(-1)
        dispatch, combine, aux = router(x2, self.router, self.cfg,
                                        token_mask)
        dt = self.dtype
        xe = torch.einsum("tec,th->ech", dispatch.to(dt), x2.to(dt))
        ye = _experts(xe, self.w1, self.w2, self.act, dt)
        y = torch.einsum("tec,ech->th", combine.to(dt), ye)
        return y.reshape(*lead, H).to(x.dtype), aux


def param_specs(params, *, axis=AXIS_EP) -> dict:
    """The sharding of a `MoEMLP` tree (``{name: tensor}``), one entry a
    dimension as JAX's PartitionSpecs: the stacked expert weights shard
    their leading dimension over ``axis``, the router stays replicated.
    `shard_params` takes this rank's slice by it."""
    return {k: ((axis,) + (None,) * (v.dim() - 1)
                if k.split(".")[-1] in ("w1", "w2") else ())
            for k, v in params.items()}


def shard_params(params, specs, mesh=None) -> dict:
    """This rank's shard of each tensor of ``params`` under ``specs``
    (`param_specs`' form) on ``mesh`` (`parallel_state`'s by default;
    `core.mesh.Mesh.local_shard`)."""
    if mesh is None:
        from apex1_tpu_torch.transformer import parallel_state
        mesh = parallel_state.get_mesh()
    return {k: mesh.local_shard(v, specs[k]) for k, v in params.items()}


def moe_shard_map_apply(x_local, wg, w1_local, w2_local, cfg: MoEConfig,
                        *, axis_name=AXIS_EP, act: Callable = gelu,
                        token_mask=None, stats_axes=None):
    """The expert-parallel dataflow over the ``axis_name`` group (an axis
    name of `parallel_state`'s mesh or a process group): ``x_local``
    (T_local, H) this rank's tokens, ``w1_local`` (E_local, H, F) and
    ``w2_local`` this rank's experts.

    Route the local tokens against all E experts (local dispatch,
    capacity from the local token count), all-to-all the (E, C_l, H)
    expert inputs so each rank holds its experts' slots from every rank
    ((E_l, ep·C_l, H)), run its expert FFNs, and all-to-all back. Returns
    ``(y (T_local, H), aux)``; differentiable."""
    group = resolve_group(axis_name)
    ep = group_size_rank(group)[0]
    E = cfg.num_experts
    if E % ep:
        raise ValueError(f"num_experts {E} must divide by ep={ep}")
    dispatch, combine, aux = router(x_local, wg, cfg, token_mask,
                                    stats_axes=stats_axes)
    dtype = x_local.dtype
    xe = torch.einsum("tec,th->ech", dispatch.to(dtype), x_local)
    if ep > 1:
        xe = mp.all_to_all_region(xe, group, 0, 1)
    ye = _experts(xe, w1_local, w2_local, act, dtype)
    if ep > 1:
        ye = mp.all_to_all_region(ye, group, 1, 0)
    y = torch.einsum("tec,ech->th", combine.to(dtype), ye)
    return y, aux
