"""Manifest-verified KV page transfer — the handoff leg of disaggregated
serving (the port of ``apex1_tpu/serving/disagg/kv_transfer.py``).

A prefill-pool engine finishes a prompt and leaves its chunk-aligned
prefix page in its pool's radix store; this module moves that page to a
decode-pool engine under a checkpoint-style integrity contract:

- `extract_page` copies the page to the host and digests every leaf at
  DEPARTURE (`tree_entries`: path, shape, dtype, sha256 over the
  C-contiguous little-endian bytes; a bf16 leaf is digested over its raw
  bytes, which numpy has no dtype for).
- `verify_page` re-digests the same leaves at ARRIVAL and compares
  entry by entry. A torn or corrupt transfer is a typed `HandoffError`:
  the router re-routes, it never installs silent garbage.
- `install_page` is verify + ``put_prefix`` into the destination
  engine's pool: the decode-side admission then radix-hits the
  installed page and prefills only the page-to-prompt remainder.

A dense pool's page is its batch-1 lane snapshot; a paged pool's is the
prefix's pages, gathered from the page pool and installed into freshly
taken pages of the destination's. Token parity across the handoff falls
out of the counter-keyed seed contract: position ``i`` samples with
``fold_in(key(seed), i)`` on whichever engine holds the stream.

On one card the "transfer" is a device -> host -> device round trip,
as on the JAX package's CPU proxy; across cards the same page would
move over NVLink. The digest contract is transport-agnostic.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, List, Tuple

import torch


class HandoffError(RuntimeError):
    """A KV handoff failed integrity or availability checks (corrupt or
    torn page, page evicted before transfer, no live source). Typed so
    the router's answer is a re-route, never silent garbage tokens."""


def _leaf_digest(t: torch.Tensor) -> str:
    """sha256 over the C-contiguous little-endian bytes of ``t`` (the
    port's hosts are little-endian), raw bytes for any dtype."""
    a = t.detach().contiguous().reshape(-1)
    return hashlib.sha256(a.view(torch.uint8).numpy().tobytes()).hexdigest()


def tree_entries(tree: dict) -> List[dict]:
    """Per-leaf manifest entries of a host ``{name: {kv: tensor}}`` tree,
    leaves in sorted key order with jax-style key paths
    (``['layer0']['k']``)."""
    out = []
    for name in sorted(tree):
        for kv in sorted(tree[name]):
            t = tree[name][kv]
            out.append({"path": f"[{name!r}][{kv!r}]",
                        "shape": list(t.shape),
                        "dtype": str(t.dtype).replace("torch.", ""),
                        "sha256": _leaf_digest(t)})
    return out


@dataclasses.dataclass
class KVPage:
    """One in-flight KV transfer: the page's radix key, its length in
    cached positions, the HOST copy of its K/V (this buffer IS the
    simulated wire), and its departure-time manifest entries."""

    key: Tuple[int, ...]
    length: int
    lane: Any                       # host {name: {kv: tensor}} tree
    entries: List[dict]             # tree_entries at departure

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for entry in self.lane.values() for t in entry.values())


def extract_page(engine, key: tuple) -> KVPage:
    """Copy ``key``'s prefix page out of ``engine``'s pool to the host
    and digest it at departure. Raises `HandoffError` when the page is
    gone (LRU-evicted between prefill completion and transfer — the
    caller re-routes)."""
    key = tuple(int(t) for t in key)
    page = engine.kv.get_prefix(key)
    if page is None:
        raise HandoffError(
            f"prefix page ({len(key)} tokens) not in the source "
            f"engine's store (evicted before transfer?)")
    if hasattr(page, "page_ids"):
        ids = torch.as_tensor(page.page_ids, dtype=torch.long)
        src = {name: {kv: t[ids.to(t.device)] for kv, t in e.items()}
               for name, e in engine.kv.pages.items()}
    else:
        src = page.lane
    # a fresh host copy: the wire buffer must not alias the pool
    lane = {name: {kv: t.detach().to("cpu", copy=True)
                   for kv, t in e.items()} for name, e in src.items()}
    return KVPage(key=key, length=int(page.length), lane=lane,
                  entries=tree_entries(lane))


def verify_page(page: KVPage) -> None:
    """Re-digest ``page.lane`` and compare against the departure
    entries — the ARRIVAL gate. Any structure/shape/dtype/content
    mismatch is a `HandoffError` naming the first divergent leaf."""
    got = tree_entries(page.lane)
    want = page.entries
    if len(got) != len(want):
        raise HandoffError(
            f"page ({page.length} tokens): {len(got)} leaves on "
            f"arrival, {len(want)} at departure")
    for g, w in zip(got, want):
        for field in ("path", "shape", "dtype", "sha256"):
            if g[field] != w[field]:
                raise HandoffError(
                    f"page ({page.length} tokens): leaf {w['path']} "
                    f"{field} mismatch on arrival "
                    f"({g[field]!r} != departed {w[field]!r})")


def install_page(engine, page: KVPage) -> bool:
    """Verify ``page`` at arrival, then register it in ``engine``'s pool
    so the decode-side admission radix-hits it. Returns False (nothing
    installed) when the destination already holds the key. Raises
    `HandoffError` on an integrity mismatch, before touching the
    destination pool."""
    verify_page(page)
    if engine.kv.has_prefix(page.key):
        return False
    dev = engine.device
    lane = {name: {kv: t.to(dev) for kv, t in e.items()}
            for name, e in page.lane.items()}
    engine.kv.put_prefix(page.key, lane, page.length)
    return True
