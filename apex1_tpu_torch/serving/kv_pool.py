"""Paged KV pool + radix-matched shared-prefix store for the serving
engine (the paged half of ``apex1_tpu/serving/kv_pool.py``).

The device side is ``{"layer{i}": {"k","v": (num_pages, Hkv, page_size,
D)}}`` torch tensors on the engine's device — one POOL of pages shared
by every slot, wired through per-slot block tables. This module is the
HOST-side bookkeeping around it: which slots are free, which pages each
slot's block-table row names, and which shared prefixes exist.

CROSS-REQUEST MATCHING (`RadixIndex` + `match`): prefixes are keyed by
their token tuple and indexed in a token-granular radix trie, so an
arriving request deduplicates against the LONGEST registered prefix of
its full prompt. A paged prefix is shared by REFERENCE: sharers' block
tables name the donor's pages, so a hit costs a table row, not a copy.

EVICTION is LRU-by-last-hit under pressure (``max_pages``): refcount-0
entries go first; live entries are never touched, so a store full of
live entries runs over its soft bound — correctness before memory.

The dense ``KVPool`` (slot lanes, copy-on-admit) comes with the dense
pool's port (ROADMAP.md queue A item 4).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass
class PrefixPage:
    """One shared-prefix K/V snapshot: a batch-1 cache pytree holding
    ``length`` real positions (the tail beyond ``length`` is write-noise
    the attention masks — see `cached_attention`'s chunk mode)."""

    lane: Any                    # batch-1 cache pytree (device arrays)
    length: int                  # real positions held
    refcount: int = 0            # live slots currently built on it
    hits: int = 0                # admissions served (the saved prefills)
    last_hit: int = 0            # LRU stamp (pool tick at last acquire)


class _Node:
    """One radix-trie node (token-granular; chunk alignment is a
    REGISTRATION policy, not a structural constraint — explicit
    ``prefix=`` pages land at arbitrary lengths in the same index)."""

    __slots__ = ("children", "terminal")

    def __init__(self):
        self.children: Dict[int, "_Node"] = {}
        self.terminal = False


class RadixIndex:
    """Longest-prefix matcher over registered token tuples.

    ``insert``/``remove`` maintain the trie; ``match(tokens, max_len)``
    returns the longest registered key that is a prefix of ``tokens``
    with length <= ``max_len`` (None when nothing matches). All walks
    are O(len(tokens)) dict hops — host-side bookkeeping, never on the
    dispatch path.
    """

    def __init__(self):
        self._root = _Node()
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def insert(self, key: Tuple[int, ...]) -> None:
        node = self._root
        for t in key:
            node = node.children.setdefault(int(t), _Node())
        if not node.terminal:
            node.terminal = True
            self._n += 1

    def remove(self, key: Tuple[int, ...]) -> None:
        path = [self._root]
        for t in key:
            node = path[-1].children.get(int(t))
            if node is None:
                return
            path.append(node)
        if not path[-1].terminal:
            return
        path[-1].terminal = False
        self._n -= 1
        # prune now-empty suffix nodes so dead keys cost no memory
        for depth in range(len(key), 0, -1):
            node = path[depth]
            if node.children or node.terminal:
                break
            del path[depth - 1].children[int(key[depth - 1])]

    def match(self, tokens, max_len: int) -> Optional[Tuple[int, ...]]:
        node = self._root
        best = 0
        for depth, t in enumerate(tokens):
            if depth >= max_len:
                break
            node = node.children.get(int(t))
            if node is None:
                break
            if node.terminal:
                best = depth + 1
        if best == 0:
            return None
        return tuple(int(t) for t in tokens[:best])


@dataclasses.dataclass
class PagedPrefix:
    """One shared prefix in the PAGED store: not a K/V snapshot but a
    tuple of page ids into the pool — sharers attend the SAME pages the
    donor wrote (reference sharing; the dense store's copy-on-admit
    install is gone). ``length`` is page-aligned by construction."""

    page_ids: Tuple[int, ...]
    length: int
    refcount: int = 0            # live slots currently built on it
    hits: int = 0
    last_hit: int = 0


class PageAllocator:
    """Refcounted free-list over a fixed page pool — the page-granular
    alloc core of `PagedKVPool` (and, once ported, of the LoRA
    adapter-page store). Page 0 is reserved
    (the trash/zero page): it is never handed out, and unref of it is a
    no-op, so all-zero block-table rows are always safe."""

    def __init__(self, num_pages: int):
        self.num_pages = int(num_pages)
        self.refs = [0] * self.num_pages
        self.free_list: List[int] = list(range(1, self.num_pages))

    def take(self) -> int:
        """Pop the lowest free page with refcount 1."""
        if not self.free_list:
            raise RuntimeError(
                "page pool out of pages — sizing invariant broken")
        pid = self.free_list.pop(0)
        self.refs[pid] = 1
        return pid

    def ref(self, pid: int) -> None:
        self.refs[pid] += 1

    def unref(self, pid: int) -> None:
        if pid == 0:
            return
        self.refs[pid] -= 1
        if self.refs[pid] < 0:
            raise ValueError(f"page {pid} refcount below zero")
        if self.refs[pid] == 0:
            self.free_list.append(pid)
            self.free_list.sort()

    @property
    def n_free(self) -> int:
        return len(self.free_list)


class PagedKVPool:
    """Page-granular slot allocator + radix-matched prefix store.

    The device pytree is ``{"layer{i}": {"k","v": (num_pages, Hkv,
    page_size, D)}}`` — one POOL of pages shared by every slot, wired
    through per-slot block tables (host lists here; the engine patches
    a device mirror at admission/retire boundaries only, so the decode
    dispatch path stays host-free). Page 0 is the TRASH page: freed
    slots' block-table rows point at it, inactive decode rows scatter
    their garbage there, and nothing ever attends it.

    Differences from the dense `KVPool`, by design:

    - ``alloc`` hands out a slot AND populates its block-table row with
      freshly owned pages for the full lane (sizing in ``__init__``
      guarantees this never fails — no per-step page faults, the
      steady-state decode loop stays dispatch-only).
    - prefix pages are SHARED by id, not installed by value:
      ``acquire_prefix`` swaps the shared ids into the slot's row
      (releasing the owned pages they displace) — admission pays zero
      K/V copies for a hit, and ``register_prefix`` simply pins the
      registrant's own pages (zero copies there too).
    - every page carries a refcount = block-table rows + registry
      entries holding it; a shared page is freed only when BOTH the
      last sharing slot retires and the registry entry is evicted
      (`test_paged_decode::TestPagedPool`).

    The prefix-entry API (match/has/get/acquire/release/evict/stats,
    ``store_version``) mirrors the dense pool so the engine's admission
    logic is pool-agnostic.
    """

    def __init__(self, make_cache, max_slots: int, lane_len: int,
                 page_size: int, dtype=None,
                 max_pages: Optional[int] = None):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.max_slots = int(max_slots)
        self.page_size = int(page_size)
        self.pages_per_lane = -(-int(lane_len) // self.page_size)
        self.lane_len = self.pages_per_lane * self.page_size
        self.max_pages = None if max_pages is None else int(max_pages)
        entries_cap = (self.max_slots if self.max_pages is None
                       else self.max_pages)
        # worst case: every slot owns a full lane AND every registry
        # entry pins a full lane of retired-donor pages (+1 trash) —
        # sized so page allocation can NEVER fail mid-admission
        self.num_pages = 1 + (self.max_slots + entries_cap
                              ) * self.pages_per_lane
        kw = {} if dtype is None else {"dtype": dtype}
        self.pages = make_cache(self.num_pages, self.page_size, **kw)
        self.block_tables = [[0] * self.pages_per_lane
                             for _ in range(self.max_slots)]
        self._alloc = PageAllocator(self.num_pages)
        self._free: List[int] = list(range(self.max_slots))
        self._slot_prefix: Dict[int, List[tuple]] = {}
        self._prefixes: Dict[tuple, PagedPrefix] = {}
        self._radix = RadixIndex()
        self._tick = 0
        self._version = 0

    # ---- pages ----------------------------------------------------------

    def page_refcount(self, pid: int) -> int:
        return self._alloc.refs[pid]

    @property
    def n_free_pages(self) -> int:
        return self._alloc.n_free

    # ---- slots ----------------------------------------------------------

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def occupancy(self) -> float:
        return 1.0 - len(self._free) / self.max_slots

    def alloc(self) -> Optional[int]:
        """Lowest free slot, its block-table row populated with a full
        lane of freshly owned pages."""
        if not self._free:
            return None
        slot = self._free.pop(0)
        self.block_tables[slot] = [self._alloc.take()
                                   for _ in range(self.pages_per_lane)]
        return slot

    def free(self, slot: int) -> None:
        if slot in self._free:
            raise ValueError(f"slot {slot} double-freed")
        if not 0 <= slot < self.max_slots:
            raise ValueError(f"slot {slot} out of range")
        for key in self._slot_prefix.pop(slot, []):
            self.release_prefix(key)
        for pid in self.block_tables[slot]:
            self._alloc.unref(pid)
        self.block_tables[slot] = [0] * self.pages_per_lane
        self._free.append(slot)
        self._free.sort()

    @property
    def store_version(self) -> int:
        return self._version

    def lane_bytes(self) -> int:
        """HBM bytes of one slot's worth of pages (`pool_bytes` /
        physical pages × pages-per-lane)."""
        return self.pool_bytes() // self.num_pages * self.pages_per_lane

    def pool_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for entry in self.pages.values() for t in entry.values())

    # ---- prefix pages ---------------------------------------------------

    def has_prefix(self, key: tuple) -> bool:
        return tuple(key) in self._prefixes

    def match(self, tokens, max_len: int
              ) -> Tuple[Optional[tuple], Optional[PagedPrefix]]:
        key = self._radix.match(tokens, int(max_len))
        if key is None:
            return None, None
        return key, self._prefixes[key]

    def register_prefix(self, slot: int, key: tuple,
                        length: int) -> Optional[PagedPrefix]:
        """Pin ``slot``'s first pages as a shared prefix — the paged
        analog of the dense pool's ``put_prefix``, with NO copy: the
        registry entry takes a reference on the registrant's own pages
        (they outlive the slot). ``length`` floors to a page multiple
        (sub-page tails hold registrant-specific tokens sharers must
        re-compute); returns None when nothing page-aligned remains."""
        key = tuple(key)
        if key in self._prefixes:
            raise ValueError(f"prefix {key!r} already registered")
        n = int(length) // self.page_size
        if n == 0:
            return None
        ids = tuple(self.block_tables[slot][:n])
        for pid in ids:
            self._alloc.ref(pid)
        page = PagedPrefix(page_ids=ids, length=n * self.page_size,
                           last_hit=self._tick)
        self._prefixes[key] = page
        self._radix.insert(key)
        self._version += 1
        self.evict_lru(exclude=key)
        return page

    def acquire_prefix(self, key: tuple, slot: int) -> PagedPrefix:
        """Build ``slot`` on a shared prefix: swap the entry's page ids
        into the slot's block-table row (releasing the owned pages they
        displace) and take the usual entry refcount. For the slot that
        just registered its OWN pages this is a pure bookkeeping no-op
        (the ids already match) — one code path for donor and sharers."""
        key = tuple(key)
        page = self._prefixes[key]
        row = self.block_tables[slot]
        for i, pid in enumerate(page.page_ids):
            if row[i] != pid:
                self._alloc.unref(row[i])
                row[i] = pid
                self._alloc.ref(pid)
        page.refcount += 1
        page.hits += 1
        self._tick += 1
        page.last_hit = self._tick
        self._slot_prefix.setdefault(slot, []).append(key)
        return page

    def release_prefix(self, key: tuple) -> None:
        page = self._prefixes[tuple(key)]
        if page.refcount <= 0:
            raise ValueError(f"prefix {key!r} released below zero")
        page.refcount -= 1

    def evict_prefix(self, key: tuple, force: bool = False) -> bool:
        """Drop a registry entry and its page references; the pages
        themselves are freed only if no slot still shares them (the
        refcount test's central property). Same live-entry refusal
        semantics as the dense pool."""
        key = tuple(key)
        page = self._prefixes.get(key)
        if page is None:
            return False
        if page.refcount > 0:
            if force:
                raise RuntimeError(
                    f"prefix {key!r} has {page.refcount} live slot(s) — "
                    f"refusing to free a live page")
            return False
        del self._prefixes[key]
        self._radix.remove(key)
        for pid in page.page_ids:
            self._alloc.unref(pid)
        self._version += 1
        return True

    def evict_lru(self, exclude: Optional[tuple] = None) -> int:
        if self.max_pages is None:
            return 0
        evicted = 0
        while len(self._prefixes) > self.max_pages:
            dead = [(p.last_hit, k) for k, p in self._prefixes.items()
                    if p.refcount == 0 and k != exclude]
            if not dead:
                break
            _, dead_key = min(dead)
            self.evict_prefix(dead_key)
            evicted += 1
        return evicted

    def prefix_stats(self) -> dict:
        return {repr(k): {"length": p.length, "refcount": p.refcount,
                          "hits": p.hits, "last_hit": p.last_hit,
                          "pages": list(p.page_ids)}
                for k, p in self._prefixes.items()}
