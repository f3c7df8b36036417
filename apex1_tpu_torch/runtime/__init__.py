"""Host-side data plumbing (the port of part of ``apex1_tpu/runtime``).

Only :func:`pack_documents` is ported: the packed batches that
``GPT2(segment_ids=, positions=)`` and `flash_attention`'s segments
train on. It is the JAX package's NumPy first-fit packing; its native
(C) branch is not carried over, and both give the same arrays.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def pack_documents(docs: Sequence[np.ndarray], seq_len: int,
                   *, pad_id: int = 0,
                   restart_chunk_positions: bool = False):
    """Greedy first-fit packing of variable-length documents into fixed
    (rows, seq_len) batches.

    Returns ``(tokens, segment_ids, positions)``, each (rows, seq_len)
    int32. ``segment_ids`` are unique per document within a row and -1
    on padding; ``positions`` restart at 0 per document. A document
    longer than ``seq_len`` is split into ``seq_len`` chunks, each its
    own segment, whose positions continue within the document unless
    ``restart_chunk_positions`` is set (required for learned-position
    models like GPT-2, whose table would otherwise be indexed past its
    end). First fit looks at the 256 most recently opened rows that
    still have room."""
    if seq_len <= 0:
        raise ValueError(f"seq_len must be positive, got {seq_len}")
    docs = [np.ascontiguousarray(np.asarray(d).ravel(), np.int32)
            for d in docs]
    doc_lens = np.asarray([len(d) for d in docs], np.int64)
    doc_starts = np.zeros(len(docs) + 1, np.int64)
    np.cumsum(doc_lens, out=doc_starts[1:])
    flat = (np.concatenate(docs) if docs else np.zeros(0, np.int32))

    space: list[int] = []
    fill: list[int] = []       # next free column per row
    nseg: list[int] = []       # segments placed per row
    open_rows: list[int] = []  # bounded first-fit window
    max_open = 256
    plan: list[tuple[int, int, int, int, int, int]] = []
    for di, doc in enumerate(docs):
        for lo in range(0, len(doc), seq_len):
            ln = min(seq_len, len(doc) - lo)
            for r in open_rows:
                if space[r] >= ln:
                    break
            else:
                r = len(space)
                space.append(seq_len)
                fill.append(0)
                nseg.append(0)
                if ln < seq_len:   # full rows never enter the window
                    open_rows.append(r)
                    if len(open_rows) > max_open:
                        open_rows.pop(0)  # evict by age
            plan.append((int(doc_starts[di]) + lo, ln, r, fill[r],
                         nseg[r], 0 if restart_chunk_positions else lo))
            space[r] -= ln
            fill[r] += ln
            nseg[r] += 1
            if space[r] == 0 and r in open_rows:
                open_rows.remove(r)
    n = len(space)
    tokens = np.full((n, seq_len), pad_id, np.int32)
    segs = np.full((n, seq_len), -1, np.int32)
    pos = np.zeros((n, seq_len), np.int32)
    for start, ln, r, c, sid, pos0 in plan:
        tokens[r, c:c + ln] = flat[start:start + ln]
        segs[r, c:c + ln] = sid
        pos[r, c:c + ln] = np.arange(pos0, pos0 + ln)
    return tokens, segs, pos


__all__ = ["pack_documents"]
