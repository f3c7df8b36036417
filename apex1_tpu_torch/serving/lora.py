"""Multi-tenant LoRA adapter pages — the store beside the KV pool (the
port of ``apex1_tpu/serving/lora.py``).

Each tenant's low-rank LM-head adapter ``(A (H, r), B (r, V))`` lives as
``r`` pages of a pair of pools on the engine's device (``a_pages``
(P, H) / ``b_pages`` (P, V), fp32), allocated by the refcounted
`kv_pool.PageAllocator` the paged KV pool uses. A serving slot carries
a rank-length block-table row of page ids, and
`ops.lora_epilogue.lora_delta` reads those pages into the logits
epilogue.

Page 0 is the zero page (all-zero payload, never allocated): a slot
with no adapter keeps an all-zero row and its delta is exactly 0.0.
``num_pages = 1 + max_adapters * rank``, so ``max_adapters``
registrations can never exhaust the pool.

Publish order: `register` writes every page payload first and publishes
the adapter's row last, so nothing can name a page before its payload
is written; `unregister` drops only the registry's ref, and a page is
freed when the last slot holding it releases. ``scale / r`` is folded
into the B pages (fp32) at registration.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from apex1_tpu_torch.ops._common import resolve_device
from apex1_tpu_torch.serving.kv_pool import PageAllocator


class LoraAdapterStore:
    """Paged store of per-tenant LoRA LM-head adapters on ``device``
    (CUDA unless the caller names another).

    ``register``/``unregister`` manage an adapter's lifetime; the
    engine calls ``acquire(adapter_id, slot)`` at admission (pins the
    pages, returns the slot's block-table row) and ``release(slot)`` at
    retirement. Host bookkeeping plus one page write per registration,
    never on the decode step path."""

    def __init__(self, hidden: int, vocab: int, rank: int,
                 max_adapters: int, dtype=torch.float32, device=None):
        if rank < 1:
            raise ValueError(f"LoRA rank must be >= 1, got {rank}")
        if max_adapters < 1:
            raise ValueError(
                f"max_adapters must be >= 1, got {max_adapters}")
        self.hidden = int(hidden)
        self.vocab = int(vocab)
        self.rank = int(rank)
        self.max_adapters = int(max_adapters)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.num_pages = 1 + self.max_adapters * self.rank
        self.a_pages = torch.zeros((self.num_pages, self.hidden),
                                   dtype=dtype, device=self.device)
        self.b_pages = torch.zeros((self.num_pages, self.vocab),
                                   dtype=dtype, device=self.device)
        self._alloc = PageAllocator(self.num_pages)
        self._adapters: Dict[str, Tuple[int, ...]] = {}
        self._slot_pages: Dict[int, Tuple[int, ...]] = {}

    # ---- registration ---------------------------------------------------

    def register(self, adapter_id: str, A, B, *,
                 scale: float = 1.0) -> Tuple[int, ...]:
        """Install adapter ``adapter_id``: ``A`` (H, r), ``B`` (r, V)
        (numpy or torch); ``scale / r`` is folded into the stored B
        pages. Page payloads land first, the adapter's row publishes
        last. Returns the page ids."""
        A, B = (t if torch.is_tensor(t) else torch.from_numpy(np.array(t))
                for t in (A, B))
        if tuple(A.shape) != (self.hidden, self.rank):
            raise ValueError(
                f"adapter {adapter_id!r}: A shape {tuple(A.shape)} != "
                f"({self.hidden}, {self.rank})")
        if tuple(B.shape) != (self.rank, self.vocab):
            raise ValueError(
                f"adapter {adapter_id!r}: B shape {tuple(B.shape)} != "
                f"({self.rank}, {self.vocab})")
        if adapter_id in self._adapters:
            raise ValueError(
                f"adapter {adapter_id!r} already registered — "
                f"unregister first (in-flight slots keep their pages)")
        pages = tuple(self._alloc.take() for _ in range(self.rank))
        kw = dict(dtype=self.dtype, device=self.device)
        a_rows = A.t().to(**kw)                               # (r, H)
        b_rows = B.to(**kw) * torch.full((), scale / self.rank, **kw)
        # phase 1: the page payloads
        idx = torch.as_tensor(pages, dtype=torch.int64, device=self.device)
        self.a_pages[idx] = a_rows
        self.b_pages[idx] = b_rows
        # phase 2: publish — nothing could name these pages before now
        self._adapters[adapter_id] = pages
        return pages

    def unregister(self, adapter_id: str) -> None:
        """Drop the registry's ref. Pages that slots still hold stay
        readable until the last `release`; the others return to the
        free list (the next `register` overwrites their payloads)."""
        pages = self._adapters.pop(adapter_id, None)
        if pages is None:
            raise KeyError(f"adapter {adapter_id!r} not registered")
        for pid in pages:
            self._alloc.unref(pid)

    def has(self, adapter_id: Optional[str]) -> bool:
        return adapter_id is not None and adapter_id in self._adapters

    # ---- per-slot lifetime ----------------------------------------------

    def acquire(self, adapter_id: Optional[str],
                slot: int) -> Tuple[np.ndarray, bool]:
        """Pin ``adapter_id``'s pages for ``slot``; returns the slot's
        ``(rank,)`` int32 block-table row and an on-flag. An unknown or
        ``None`` adapter gives the all-zero row (page 0) and ``False``."""
        if slot in self._slot_pages:
            raise ValueError(f"slot {slot} already holds adapter pages")
        if not self.has(adapter_id):
            return np.zeros((self.rank,), np.int32), False
        pages = self._adapters[adapter_id]
        for pid in pages:
            self._alloc.ref(pid)
        self._slot_pages[slot] = pages
        return np.asarray(pages, np.int32), True

    def release(self, slot: int) -> None:
        """Unpin whatever ``slot`` acquired (nothing for an adapterless
        slot)."""
        pages = self._slot_pages.pop(slot, None)
        if pages is None:
            return
        for pid in pages:
            self._alloc.unref(pid)

    @property
    def n_free(self) -> int:
        return self._alloc.n_free

    def page_refcount(self, pid: int) -> int:
        return self._alloc.refs[pid]
