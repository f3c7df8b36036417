"""Judging two greedy token streams that should agree: equal, or apart
first at a near-tie.

Two decoding paths that compute the same logits in another order (a
verify chunk against one-token steps, a ragged batch against a row
alone, kernels against their plain versions) round differently in bf16,
so where the reference's top two scores nearly tie, the argmax may
flip, and from there the streams part. The rule: each stream's first
differing token is allowed only where the reference's top-2 gap
(relative to its top score) is below the two runs' logit difference at
that step (relative to the reference's largest logit), and that
difference is at most twice the largest the two runs show where the
streams still agree. Where every agreeing logit is equal bit for bit
(fp32 at O0 through one path), no flip is allowed.

`serving_llama` (speculative against greedy, the ragged row against
the row alone) and ``chip_smoke.py``'s generation phases use it.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def top2_gap(logits: torch.Tensor, row: int, step: int,
             temperature: float, vocab: int) -> float:
    """(top1 - top2) / |top1| of the scores the sampler took its argmax
    over at ``step`` for ``row`` of the (B, V) ``logits``: the logits
    (greedy), or logits / temperature plus the step's gumbel noise (the
    key(0) chain split once a step, as `generate` does)."""
    from apex1_tpu_torch.core.random import split
    from apex1_tpu_torch.ops.paged_decode import (_bits_to_gumbel,
                                                  _uniform_bits)
    B, V = logits.shape
    sc = logits[row].double().clone()
    sc[vocab:] = -1e30
    if temperature:
        key = (0, 0)
        for _ in range(step + 1):
            key, sub = split(key)
        col = torch.arange(V, device=logits.device) + row * V
        g = _bits_to_gumbel(_uniform_bits(sub[0], sub[1], col.cpu(), B * V))
        sc = sc / temperature + g.to(sc.device).double()
    top = torch.topk(sc, 2).values
    return ((top[0] - top[1]) / top[0].abs()).item()


def first_flips(got, want, gap_at: Callable) -> list:
    """(row, step, top-2 gap) at the first differing token of each
    differing stream; ``gap_at(row, step)`` reads the reference's
    sampling scores there."""
    out = []
    for r in range(len(want)):
        g, w = list(got[r]), list(want[r])
        if g == w:
            continue
        t = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                 min(len(g), len(w)))
        out.append((r, t, gap_at(r, t)))
    return out


def logits_moved(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest difference of two (B, V) logit rows over the largest
    |want|, the worst row."""
    return ((got.float() - want.float()).abs().amax(-1)
            / want.float().abs().amax(-1)).max().item()


def judge(got, want, got_at: Callable, want_at: Callable,
          vocab: int) -> dict:
    """The module's rule on the (B, N) token streams ``got`` against
    ``want``. ``got_at(row, step)`` and ``want_at(row, step)`` return
    the (1, V) logits each run chose token ``step`` of ``row`` from (or
    None where the run kept none). Returns ``{"flips": [(row, step,
    gap)], "moved": [difference at each flip or None], "floor": the
    largest difference where the streams agree, "bad": the flips that
    are not near-ties}``."""
    flips = first_flips(got, want,
                        lambda r, t: top2_gap(want_at(r, t), 0, t, 0.0,
                                              vocab))
    first = {r: t for r, t, _ in flips}
    n = len(want[0]) if len(want) else 0

    def moved_at(r, t) -> Optional[float]:
        g, w = got_at(r, t), want_at(r, t)
        return None if g is None or w is None else logits_moved(g, w)

    agreeing = [moved_at(r, t) for r in range(len(want))
                for t in range(first.get(r, n))]
    floor = max([m for m in agreeing if m is not None], default=0.0)
    moved = [moved_at(r, t) for r, t, _ in flips]
    bad = [f for f, m in zip(flips, moved)
           if m is None or f[2] >= m or m > 2 * floor]
    return {"flips": flips, "moved": moved, "floor": floor, "bad": bad}


def recorder(apply_fn: Callable, record: list, *, chunks: bool = False):
    """``apply_fn`` (a decoder's ``(tokens, cache, cache_index, **kw) ->
    (logits, cache)``) that also appends to ``record``: each call's
    last-position fp32 logits (B, V), or with ``chunks`` each
    ``chunk_decode`` call's ``(cache_index on the host, fp32 logits (B,
    K + 1, V))`` (a speculative verify round)."""

    def rec(tokens, cache, idx, **kw):
        logits, cache = apply_fn(tokens, cache, idx, **kw)
        if not chunks:
            record.append(logits[:, -1].float())
        elif kw.get("chunk_decode"):
            record.append((torch.as_tensor(idx).cpu(), logits.float()))
        return logits, cache

    return rec


def step_logits(record: list) -> Callable:
    """``at(row, step)`` over a `recorder` record of one-token steps: the
    (1, V) logits token ``step`` of ``row`` was chosen from."""
    return lambda r, t: record[t][r:r + 1] if t < len(record) else None


def verify_logits(record: list, prompt_len: int, num_draft: int) -> Callable:
    """``at(row, step)`` over a `recorder` record of verify chunks: the
    (1, V) logits the last verify round that scored token ``step`` of
    ``row`` computed for it (None for the prefill's token 0 and for a
    token no round scored)."""

    def at(r, t):
        if t == 0:
            return None
        pos = prompt_len + t - 1
        for idx, lg in reversed(record):
            j = pos - int(idx.reshape(-1)[r] if idx.dim() else idx)
            if 0 <= j <= num_draft:
                return lg[r, j:j + 1]
        return None

    return at
