"""ASP, 2:4 structured sparsity (the port of
``apex1_tpu/contrib/sparsity.py``; reference ``apex/contrib/sparsity``):
the masks, their re-application after each step, and the greedy
channel-permutation search that makes the 2:4 pattern keep more
magnitude.

The masks are the accuracy half of ASP; the speed half, Hopper's 2:4
sparse tensor cores, needs a sparse GEMM that the JAX package does not
have and the port does not add. The search is the JAX package's: an
all-pairs swap-gain matrix a step (`_swap_gains`), the best swap
applied until none gains more than ``tol``. Permuting the producing
layer to compensate stays with the caller, as in the reference's
offline flow.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


#: the relative gap under which two swap gains tie (2^-20: a few fp32
#: ulps of the largest, the rounding of a sum of its R terms)
TIE = 2.0 ** -20


def compute_m4n2_mask(w: torch.Tensor) -> torch.Tensor:
    """The 2:4 mask along the last dim: the 2 largest |w| of each group
    of 4, ties to the lower index (stable sorts, as ``jnp.argsort``)."""
    if w.shape[-1] % 4:
        raise ValueError("last dim must be a multiple of 4 for 2:4")
    groups = w.reshape(*w.shape[:-1], -1, 4)
    order = torch.argsort(-groups.abs(), dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    return (ranks < 2).reshape(w.shape)


def mask_efficacy(w: torch.Tensor, mask: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """|w| kept by the 2:4 mask over the total |w|: what the permutation
    search maximises."""
    if mask is None:
        mask = compute_m4n2_mask(w)
    aw = w.abs()
    return (aw * mask).sum() / aw.sum()


def _swap_gains(aw_perm: torch.Tensor) -> torch.Tensor:
    """The (C, C) gain in kept magnitude from swapping the columns at
    permuted positions i and j of ``aw_perm`` (R, C) = |w| in the current
    order (0 within a group of 4). Per (group g, slot m): with the slot's
    column out, the other three sorted a <= b <= c, a column x in its
    place keeps max(c, x) + max(b, min(c, x))."""
    R, C = aw_perm.shape
    G = C // 4
    g_vals = aw_perm.t().reshape(G, 4, R)                     # (G, 4, R)
    top2 = torch.sort(g_vals, dim=1).values[:, 2:].sum(dim=1)  # (G, R)
    q_cur = top2.sum(dim=1)                                   # (G,)
    idx = torch.arange(4, device=aw_perm.device)
    keep = idx[None, :] != idx[:, None]                       # (slot, member)
    rem = torch.where(keep[None, :, :, None], g_vals[:, None, :, :], 0.0)
    rem_sorted = torch.sort(rem, dim=2).values                # zeros first
    b3, c3 = rem_sorted[:, :, 2, :, None], rem_sorted[:, :, 3, :, None]
    top2_rep = (torch.maximum(c3, aw_perm)
                + torch.maximum(b3, torch.minimum(c3, aw_perm)))
    q_rep = top2_rep.sum(dim=2)                               # (G, 4, C)
    dq = (q_rep - q_cur[:, None, None]).reshape(C, C)
    gain = dq + dq.t()
    col = torch.arange(C, device=aw_perm.device)
    same = (col[:, None] // 4) == (col[None, :] // 4)
    return torch.where(same, 0.0, gain)


def permutation_search(w: torch.Tensor, *, max_swaps: int = 256,
                       tol: float = 1e-6):
    """The greedy channel-permutation search: ``(perm, mask, efficacy)``,
    ``perm`` the (C,) int64 column order whose 2:4 mask keeps the most
    magnitude, ``mask`` that pattern in the ORIGINAL column order (for
    `ASP`), ``efficacy`` its kept share. Each step swaps the pair of the
    largest `_swap_gains` entry, until no swap gains more than ``tol``
    or after ``max_swaps``. Gains within `TIE` (relative) of the largest
    are ties, broken to the first in row-major order (``np.argmax``'s
    rule): a gain sums R terms in fp32, so two swaps of equal gain can
    come out a few ulps apart in one summation order and equal in
    another (the JAX package's XLA sums), and the pick must not hinge on
    that."""
    if w.dim() != 2 or w.shape[-1] % 4:
        raise ValueError("permutation_search expects (rows, cols) with "
                         "cols a multiple of 4")
    aw = w.float().abs()
    C = aw.shape[1]
    perm = np.arange(C)
    for _ in range(max_swaps):
        gain = _swap_gains(aw[:, torch.from_numpy(perm).to(aw.device)])
        gain = gain.cpu().numpy()
        best = gain.max()
        i, j = np.unravel_index(np.argmax(gain >= best - abs(best) * TIE),
                                gain.shape)
        if gain[i, j] <= tol:
            break
        perm[i], perm[j] = perm[j], perm[i]
    perm_t = torch.from_numpy(perm).to(w.device)
    mask = compute_m4n2_mask(w[:, perm_t])[:, torch.argsort(perm_t)]
    return perm_t, mask, mask_efficacy(w, mask)


class ASP:
    """Mask bookkeeping: ``compute_sparse_masks(params)``, then
    ``apply_masks(params)`` after each optimizer step (the reference
    patches ``optimizer.step``; here call it in the train step).

    ``params`` is a flat ``{name: tensor}`` dict, e.g.
    ``dict(model.named_parameters())``, and the masks are keyed by those
    names. The JAX package keys them by ``jax.tree_util.keystr`` of the
    leaf's path in a nested tree: its ``['dense']['kernel']`` is the
    name ``dense.kernel`` here (the flax path joined by dots, as
    `interop` names parameters). Each mask runs along the last dim of
    its tensor: a flax (in, out) kernel groups output channels, a torch
    (out, in) ``weight`` input channels."""

    def __init__(self, mask_fn: Callable = compute_m4n2_mask):
        self.mask_fn = mask_fn
        self.masks: Optional[dict] = None

    def compute_sparse_masks(self, params: dict, *, predicate=None) -> dict:
        """Masks for every ``params`` entry that ``predicate(name,
        tensor)`` accepts (default: 2-D or more, last dim a multiple of
        4)."""
        predicate = predicate or (
            lambda name, x: x.dim() >= 2 and x.shape[-1] % 4 == 0)
        self.masks = {name: self.mask_fn(x.detach())
                      for name, x in params.items() if predicate(name, x)}
        return self.masks

    def apply_masks(self, params: dict) -> dict:
        """A new dict with every masked tensor multiplied by its mask."""
        if self.masks is None:
            raise RuntimeError("call compute_sparse_masks first")
        return {name: x if name not in self.masks
                else x * self.masks[name].to(x.dtype)
                for name, x in params.items()}
