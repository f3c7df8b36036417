"""Host-side draft proposal for the engine's speculative verify (a copy
of ``apex1_tpu/serving/spec.py``, which imports no JAX; the port keeps
its own).

The engine's speculative mode (``EngineConfig.num_draft > 0``) needs K
proposed tokens per active slot per step. The default is prompt-lookup
/ n-gram self-drafting (`ngram_propose`): the request's own known
history (prompt plus everything emitted so far) is the draft model —
the longest recent n-gram is looked up at its most recent earlier
occurrence and the tokens that followed it are proposed. A small draft
model rides the same seam: ``Engine(draft_propose=fn)`` with
``fn(history, k) -> k ints``.

Drafts are pure latency hints under the engine's exact-match verify: a
wrong draft costs a wasted row in one verify forward, never a changed
token.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["ngram_propose"]


def ngram_propose(history: Sequence[int], k: int, *,
                  max_ngram: int = 3) -> np.ndarray:
    """Propose ``k`` draft tokens by prompt-lookup over ``history``.

    Tries the longest suffix n-gram first (``max_ngram`` down to 1):
    finds its most recent earlier occurrence in the history and
    proposes the tokens that followed it, padded by repeating the last
    proposed token when the occurrence sits too near the end. Falls
    back to repeating the final token. Returns a ``(k,)`` int32 array;
    ``history`` must be non-empty."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    h = [int(t) for t in history]
    n = len(h)
    if n == 0:
        raise ValueError("ngram_propose needs a non-empty history")
    for g in range(min(int(max_ngram), n - 1), 0, -1):
        pat = h[n - g:]
        for s in range(n - g - 1, -1, -1):
            if h[s:s + g] == pat:
                cont = h[s + g:s + g + k]
                if cont:
                    while len(cont) < k:
                        cont.append(cont[-1])
                    return np.asarray(cont, np.int32)
    return np.full((k,), h[-1], np.int32)
