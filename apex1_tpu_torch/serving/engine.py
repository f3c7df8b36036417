"""Continuous-batching inference engine over the paged KV pool (the port
of ``apex1_tpu/serving/engine.py``, ``EngineConfig(paged=True)``).

Requests join a fixed set of ``max_slots`` KV slots the moment one
frees and leave on EOS or length; the decode step never stops for
them. The KV cache is one pool of pages per layer
(`kv_pool.PagedKVPool`), addressed through per-slot block tables, and
the model runs the JAX package's KERNEL-PATH structure
(``engine.py:636-742`` there) on every device:

- **prefill** — one ``(1, prefill_chunk)`` chunk-decode forward of the
  model through `ops.paged_decode.PagedCache` entries over the slot's
  block-table row. Every prompt is fed as right-padded fixed-width
  chunks at its cache index; the first token is sampled from the last
  real position with `ops.paged_decode.fused_sample`.
- **decode** — ONE batch-N forward over every slot: each row carries
  its own cache index (rows are at different depths), attention runs
  `ops.paged_decode.paged_attend` over the pages and sampling runs
  `fused_sample` over the (N, V) logits rows. Inactive rows compute
  masked garbage into the trash page (page 0).

On CUDA tensors those are the port's kernels; on the CPU their plain
PyTorch versions. PyTorch runs eagerly, so the JAX engine's
``trace_counts`` (its compile-count hook) has no meaning here and is
not kept. The K/V writes update the page pool in place.

SAMPLING is counter-based and per request: token i of a request is
drawn with ``fold_in(key(seed), i)`` in jax's threefry stream, so the
stream is a pure function of (params, prompt, seed) and equals the JAX
engine's token for token on the same params.

RADIX PREFIX CACHE (always on): admission matches the request's prompt
against registered prefixes, shares the longest match's pages by
reference and prefills only the rest. Prompts auto-register at the
chunk-aligned share point.

DEVICE-RESIDENT CONTROL: the per-slot token / index / active / seed /
output-position vectors and the block tables live on the device and
are patched in place only at join/leave boundaries. With
``eos_id=None`` the engine never reads a step's tokens back before
dispatching the next: per-step outputs collect in a device-side log,
read once at retirement. With an ``eos_id`` each step's tokens are read
back (one small blocking copy per step) to retire rows.

Not ported yet (each raises `NotImplementedError` naming its ROADMAP.md
item): speculative decode (``num_draft > 0``), multi-tenant LoRA
(``lora_rank > 0``) and the dense pool (``paged=False``). Nor are the
JAX engine's cancellation, deadlines, explicit ``prefix=`` share points
or ``prefix_cache=False``: each comes with the slice that needs it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from apex1_tpu_torch.ops._common import resolve_device
from apex1_tpu_torch.ops.paged_decode import PagedCache, fused_sample
from apex1_tpu_torch.serving.kv_pool import PagedKVPool
from apex1_tpu_torch.serving.metrics import ServingMetrics
from apex1_tpu_torch.serving.scheduler import (Backpressure, Request,
                                               Scheduler)
from apex1_tpu_torch.utils.observability import MetricsLogger, annotate


def _mix32(x: int) -> int:
    """Deterministic 32-bit avalanche (xorshift-multiply), a copy of
    ``apex1_tpu/resilience/retry.py::_mix32``."""
    x &= 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * 0x846CA68B) & 0xFFFFFFFF
    x ^= x >> 16
    return x


def derive_request_seed(engine_seed: int, req_id: int) -> int:
    """The per-request sampling seed when the caller supplies none: a
    deterministic avalanche of (engine seed, request id), so a stable
    request id gives a stable stream."""
    return _mix32(int(engine_seed) ^ _mix32(int(req_id) + 0x5EED)) \
        & 0x7FFFFFFF


@dataclasses.dataclass
class EngineConfig:
    """Engine shape/sampling/admission knobs, static for the life of
    the engine; per-request variation rides device operands. The fields
    and their meaning are the JAX package's (less ``prefix_cache``: the
    radix cache is always on); ``cache_dtype`` takes a torch dtype."""

    max_slots: int = 8           # concurrent requests (pool batch)
    max_len: int = 256           # cache positions per slot
    prefill_chunk: int = 16      # prompt tokens per prefill call
    temperature: float = 0.0     # 0 = greedy (engine-global)
    top_k: Optional[int] = None
    eos_id: Optional[int] = None
    pad_id: int = 0
    vocab_size: Optional[int] = None
    seed: int = 0                # base for derived per-request seeds
    max_queue: int = 64          # admission backpressure bound
    policy: str = "fifo"         # or "sjf" (see serving.scheduler)
    max_prefix_pages: int = 32   # LRU-by-last-hit prefix bound
    num_draft: int = 0           # speculative decode (not ported yet)
    cache_dtype: Optional[object] = None  # e.g. torch.int8; None = the
    #                                       decoder's compute dtype
    paged: bool = True           # the port serves the paged pool only
    page_size: Optional[int] = None  # None = max(8, ceil8(chunk))
    lora_rank: int = 0           # multi-tenant LoRA (not ported yet)

    def __post_init__(self):
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if self.max_len < 2:
            raise ValueError("max_len must be >= 2")
        if self.num_draft < 0:
            raise ValueError(
                f"num_draft must be >= 0, got {self.num_draft}")
        if self.max_prefix_pages < 1:
            raise ValueError("max_prefix_pages must be >= 1")
        if self.page_size is not None and self.page_size < 1:
            raise ValueError(
                f"page_size must be >= 1, got {self.page_size}")
        if self.lora_rank < 0:
            raise ValueError(
                f"lora_rank must be >= 0, got {self.lora_rank}")


@dataclasses.dataclass
class RequestResult:
    """Terminal outcome. ``tokens`` holds whatever was generated before
    the terminal event."""

    req_id: int
    status: str                  # done | evicted (shed from the queue)
    tokens: np.ndarray
    reason: str = ""


@dataclasses.dataclass
class _Slot:
    """Host-side state of one occupied pool slot."""

    req: Request
    first_tok: object            # device scalar (or int once read)
    start_step: int              # engine step its first DECODE lands at
    n_out: int = 1               # tokens emitted so far (first included)
    in_batch: bool = False       # joined the decode batch
    eos_seen: bool = False
    produced: List[int] = dataclasses.field(default_factory=list)


class Engine:
    """Continuous-batching engine over a ``(apply_fn, make_cache)``
    decoder pair (`models.generate.gpt2_decoder`), on ``device`` (CUDA
    unless the caller names another; asking for CUDA without a card
    raises). The model's parameters and cache must live there.

    Drive it with `submit` + `step`/`run`; finished requests appear in
    `results`. One `step()` = admit queued requests into free slots
    (chunked prefill) -> one pooled decode step.
    """

    def __init__(self, apply_fn: Callable, make_cache: Callable,
                 config: Optional[EngineConfig] = None, *, device=None,
                 metrics_logger: Optional[MetricsLogger] = None):
        self.device = resolve_device(device)
        self.cfg = cfg = config or EngineConfig()
        if not cfg.paged:
            raise NotImplementedError(
                "the port serves the paged pool only; the dense pool "
                "(paged=False) is ROADMAP.md queue A item 4 (decode, "
                "quant, LoRA, speculative, dense pool)")
        if cfg.num_draft > 0:
            raise NotImplementedError(
                "speculative decode (num_draft > 0) is not ported yet: "
                "ROADMAP.md queue A item 4 (decode, quant, LoRA, "
                "speculative, dense pool)")
        if cfg.lora_rank > 0:
            raise NotImplementedError(
                "multi-tenant LoRA (lora_rank > 0) needs the LoRA "
                "epilogue kernel (TPU kernel row 23), not ported yet: "
                "ROADMAP.md queue A item 4 (decode, quant, LoRA, "
                "speculative, dense pool)")
        self._apply_fn = apply_fn
        # the final prefill chunk is right-padded to the full width, so
        # its write can run up to prefill_chunk - 1 positions past the
        # last real token: the pool carries that slack past max_len
        slack = cfg.prefill_chunk - 1
        page_size = cfg.page_size or max(8, -(-cfg.prefill_chunk // 8) * 8)
        self.kv = PagedKVPool(make_cache, cfg.max_slots,
                              cfg.max_len + slack, page_size=page_size,
                              dtype=cfg.cache_dtype,
                              max_pages=cfg.max_prefix_pages)
        pool_dev = next(iter(self.kv.pages.values()))["k"].device
        if pool_dev.type != self.device.type:
            raise ValueError(f"the decoder's cache lives on {pool_dev}, "
                             f"the engine on {self.device}")
        self.scheduler = Scheduler(max_queue=cfg.max_queue,
                                   policy=cfg.policy)
        self.metrics = ServingMetrics(metrics_logger)
        self.results: Dict[int, RequestResult] = {}
        self._slots: List[Optional[_Slot]] = [None] * cfg.max_slots
        self._sample_kw = dict(temperature=cfg.temperature,
                               top_k=cfg.top_k, vocab_size=cfg.vocab_size)
        # device-resident control vectors and block tables, patched in
        # place at join/leave boundaries only; freed rows name the trash
        # page so an inactive row's garbage write never lands on a page
        # a new request owns
        dev, i32 = self.device, torch.int32
        n = cfg.max_slots
        self._d_bt = torch.zeros((n, self.kv.pages_per_lane), dtype=i32,
                                 device=dev)
        self._d_toks = torch.zeros((n,), dtype=i32, device=dev)
        self._d_idxs = torch.zeros((n,), dtype=i32, device=dev)
        self._d_active = torch.zeros((n,), dtype=torch.bool, device=dev)
        self._d_seeds = torch.zeros((n,), dtype=i32, device=dev)
        self._d_pos = torch.zeros((n,), dtype=i32, device=dev)
        self._n_active = 0
        # eos_id=None: retirement is length-based, so step tokens are
        # only READ at retirement — the log keeps each step's (N,)
        # output (a device tensor until its first fetch memoizes it)
        self._defer = cfg.eos_id is None
        self._tok_log: Dict[int, object] = {}
        self._step_no = 0
        self._probe_cache: Dict[int, bool] = {}
        self._probe_cache_ver = -1

    def _sync_bt(self, slot: int) -> None:
        """Push one slot's host block-table row to the device mirror —
        called wherever the host row changes, never on the step path."""
        self._d_bt[slot] = torch.as_tensor(
            self.kv.block_tables[slot], dtype=torch.int32).to(self.device)

    def _paged_cache(self, bt) -> dict:
        L = self.kv.lane_len
        return {layer: PagedCache(entry["k"], entry["v"], bt, L)
                for layer, entry in self.kv.pages.items()}

    # ---- the two steps ---------------------------------------------------

    def _prefill(self, slot: int, tokens: np.ndarray, idx: int,
                 n_real: int, seed: int) -> torch.Tensor:
        """One (1, C) chunk of slot ``slot`` at cache index ``idx``;
        returns the device token sampled after its last real position
        (the request's output #0)."""
        C, dev = self.cfg.prefill_chunk, self.device
        positions = (idx + torch.arange(C, device=dev))[None]
        logits, _ = self._apply_fn(
            torch.from_numpy(tokens).to(dev),
            self._paged_cache(self._d_bt[slot:slot + 1]), idx,
            positions=positions, chunk_decode=True)
        seeds = torch.full((1,), seed, dtype=torch.int32, device=dev)
        pos0 = torch.zeros((1,), dtype=torch.int32, device=dev)
        return fused_sample(logits[:, n_real - 1], seeds, pos0,
                            **self._sample_kw)[0]

    def _decode(self):
        """One batch-N decode step over every slot."""
        logits, _ = self._apply_fn(
            self._d_toks[:, None], self._paged_cache(self._d_bt),
            self._d_idxs, positions=self._d_idxs[:, None])
        nxt = fused_sample(logits[:, -1], self._d_seeds, self._d_pos,
                           **self._sample_kw)
        nxt = torch.where(self._d_active, nxt, self.cfg.pad_id)
        adv = self._d_active.to(torch.int32)
        return nxt, self._d_idxs + adv, self._d_pos + adv

    # ---- submission -----------------------------------------------------

    def submit(self, tokens, max_new_tokens: int, *,
               req_id: Optional[int] = None,
               qos: str = "best_effort",
               seed: Optional[int] = None) -> int:
        """Enqueue a request. Raises `Backpressure` when the queue is
        full and holds no weaker-class victim to shed, and `ValueError`
        when the request can never fit (prompt +
        max_new_tokens - 1 > max_len). ``seed`` pins the request's
        sampling stream; None derives one from the request id."""
        req = Request(tokens=tokens, max_new_tokens=max_new_tokens,
                      req_id=req_id, qos=qos, seed=seed)
        if req.seed is None:
            req.seed = derive_request_seed(self.cfg.seed, req.req_id)
        if req.total_len > self.cfg.max_len:
            raise ValueError(
                f"request needs {req.total_len} cache positions but "
                f"slots hold max_len={self.cfg.max_len}")
        try:
            rid = self.scheduler.submit(req)
        except Backpressure as e:
            self.metrics.event(req.req_id, "queued",
                               n_prompt=req.tokens.size)
            self.metrics.event(req.req_id, "rejected", reason=e.reason)
            raise
        for victim in self.scheduler.drain_shed():
            self.metrics.incr("sheds")
            self._finish(victim.req_id, "evicted",
                         f"shed ({victim.qos})", [])
        self.metrics.event(rid, "queued", n_prompt=req.tokens.size)
        return rid

    # ---- the engine loop ------------------------------------------------

    @torch.inference_mode()
    def step(self) -> int:
        """One engine iteration: admit -> one decode step over every
        occupied slot. Returns the number of active slots that decoded
        (0 = idle). Runs under inference mode: serving records no
        autograd graph."""
        self._admit_all()
        n_active = self._n_active
        if n_active:
            self._decode_step()
        self.metrics.step_sample(n_active, self.cfg.max_slots,
                                 self.scheduler.depth)
        return n_active

    def _decode_step(self):
        with annotate("serving/decode_step"):
            nxt, self._d_idxs, self._d_pos = self._decode()
        self.metrics.incr("decode_steps")
        self._d_toks = nxt
        if self._defer:
            self._tok_log[self._step_no] = nxt     # fetched at retire
            toks = None
        else:
            toks = nxt.cpu().numpy()               # eos needs the values
        self._step_no += 1
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            slot.n_out += 1
            self.metrics.event(slot.req.req_id, "token")
            if toks is not None:
                tok = int(toks[i])
                slot.produced.append(tok)
                if tok == self.cfg.eos_id:
                    slot.eos_seen = True
                    self._retire(i, "done", "eos")
                    continue
            if slot.n_out >= slot.req.max_new_tokens:
                self._retire(i, "done", "length")

    def run(self, max_steps: Optional[int] = None
            ) -> Dict[int, RequestResult]:
        """Step until queue and slots drain (or ``max_steps``)."""
        steps = 0
        while self.scheduler.depth > 0 or any(
                s is not None for s in self._slots):
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return self.results

    # ---- admission ------------------------------------------------------

    def _admit_all(self):
        while self.kv.n_free > 0:
            prefer = None
            if self.scheduler.depth > self.kv.n_free:
                # near capacity: a radix hit turns a slot over sooner,
                # so prefer hits WITHIN a QoS class
                prefer = self._would_hit
            batch = self.scheduler.pop(1, prefer=prefer)
            if not batch:
                return
            self._admit(batch[0])

    def _would_hit(self, req: Request) -> bool:
        """Prefix-aware admission probe (a host-side radix walk),
        memoized per (request, page-store version)."""
        ver = self.kv.store_version
        if self._probe_cache_ver != ver:
            self._probe_cache_ver = ver
            self._probe_cache.clear()
        hit = self._probe_cache.get(req.req_id)
        if hit is None:
            full = req.tokens
            hit = self.kv.match(full, int(full.size) - 1)[1] is not None
            if len(self._probe_cache) >= 2 * self.cfg.max_queue:
                self._probe_cache.clear()
            self._probe_cache[req.req_id] = hit
        return hit

    def _admit(self, req: Request):
        slot = self.kv.alloc()
        if slot is None:
            raise RuntimeError("admission without a free slot")
        # the freshly owned page row must be on the device before any
        # prefill chunk writes through it
        self._sync_bt(slot)
        full = req.tokens
        # cap at len-1: a full-prompt hit must still leave >= 1 real
        # token to prefill (the logit the first token samples from)
        key, page = self.kv.match(full, int(full.size) - 1)
        self.metrics.incr("prefix_lookups")
        idx0 = 0 if page is None else page.length
        if page is not None:
            self.metrics.incr("prefix_hits")
            self.metrics.incr("prefix_saved_tokens", idx0)
        self.metrics.event(req.req_id, "prefill",
                           prefix_hit=page is not None, prefix_saved=idx0)
        try:
            with annotate("serving/prefill"):
                if page is not None:
                    # the acquire rewires the slot's block table onto
                    # the shared pages: the pages themselves are the hit
                    self.kv.acquire_prefix(key, slot)
                    self._sync_bt(slot)
                tok0 = self._run_chunks(slot, full[idx0:], idx0, req.seed)
            # auto-registration at the chunk-aligned share point; the
            # last token stays uncached
            C = self.cfg.prefill_chunk
            lstar = ((int(full.size) - 1) // C) * C
            if lstar >= C and lstar > idx0:
                akey = tuple(int(t) for t in full[:lstar])
                if not self.kv.has_prefix(akey):
                    self._register_page(slot, akey, lstar)
        except BaseException:
            # a prefill chain that dies mid-flight must not leak the
            # slot or any acquired page refs; the verdict belongs to
            # the caller (re-raise)
            self.kv.free(slot)
            self._sync_bt(slot)
            raise
        self.metrics.event(req.req_id, "first_token")
        idx = int(full.size)
        st = _Slot(req=req, first_tok=tok0, start_step=self._step_no)
        self._slots[slot] = st
        if not self._defer:                  # eos_id is set: read it now
            st.first_tok = int(tok0)
            st.produced.append(st.first_tok)
            if st.first_tok == self.cfg.eos_id:
                st.eos_seen = True
                self._retire(slot, "done", "eos")
                return
        if req.max_new_tokens == 1:
            self._retire(slot, "done", "length")
            return
        # device-side boundary patch: the slot joins the decode batch
        # (pos=1: prefill already drew output #0). The token vector may
        # be the step log's tensor, so it is patched on a copy.
        toks = self._d_toks.clone()
        toks[slot] = tok0
        self._d_toks = toks
        self._d_idxs[slot] = idx
        self._d_active[slot] = True
        self._d_seeds[slot] = int(req.seed)
        self._d_pos[slot] = 1
        st.in_batch = True
        self._n_active += 1

    def _register_page(self, slot: int, pkey: tuple, length: int):
        """Pin ``slot``'s first pages as a shared prefix (by reference,
        no copy) and take the owner's ref; the length floors to a page
        multiple."""
        if self.kv.register_prefix(slot, pkey, length) is not None:
            self.kv.acquire_prefix(pkey, slot)

    def _run_chunks(self, slot: int, tokens: np.ndarray, idx0: int,
                    seed: int):
        """Feed ``tokens`` through prefill in fixed-width right-padded
        chunks starting at cache position ``idx0``; returns the device
        token sampled after the final chunk."""
        C = self.cfg.prefill_chunk
        tok = None
        for c in range(math.ceil(int(tokens.size) / C)):
            seg = tokens[c * C:(c + 1) * C]
            buf = np.zeros((1, C), np.int32)
            buf[0, :seg.size] = seg
            tok = self._prefill(slot, buf, idx0 + c * C, int(seg.size),
                                seed)
            self.metrics.incr("prefill_chunks")
        return tok

    # ---- retirement -----------------------------------------------------

    def _materialize(self, st: _Slot, slot_idx: int) -> List[int]:
        """Collect a deferred-mode slot's tokens from the step log (the
        only point the engine blocks on decode outputs)."""
        out = [int(st.first_tok)]
        for s in range(st.start_step,
                       st.start_step + max(st.n_out - 1, 0)):
            buf = self._tok_log[s]
            if not isinstance(buf, np.ndarray):     # memoize the fetch
                buf = buf.cpu().numpy()
                self._tok_log[s] = buf
            out.append(int(buf[slot_idx]))
        return out

    def _prune_log(self):
        if not self._tok_log:
            return
        live = [s.start_step for s in self._slots if s is not None]
        floor = min(live) if live else self._step_no
        for s in [s for s in self._tok_log if s < floor]:
            del self._tok_log[s]

    def _retire(self, slot_idx: int, status: str, reason: str):
        slot = self._slots[slot_idx]
        self._slots[slot_idx] = None
        if self._defer:
            produced = self._materialize(slot, slot_idx)
            self._prune_log()
        else:
            produced = slot.produced
        if slot.in_batch:
            # the freed row keeps computing masked garbage (values only)
            self._d_active[slot_idx] = False
            self._n_active -= 1
        self.kv.free(slot_idx)
        # REQUIRED, not hygiene: the retired row keeps writing its
        # garbage every step, and its old pages may be reallocated (or
        # live on as shared prefix pages) immediately
        self._sync_bt(slot_idx)
        self._finish(slot.req.req_id, status, reason, produced)

    def _finish(self, req_id: int, status: str, reason: str,
                produced: List[int]):
        if status == "evicted" and not reason.startswith("shed"):
            self.metrics.incr("evictions")
        self.metrics.event(req_id, status, reason=reason,
                           n_generated=len(produced))
        self.results[req_id] = RequestResult(
            req_id=req_id, status=status,
            tokens=np.asarray(produced, np.int32), reason=reason)

    # ---- introspection --------------------------------------------------

    @property
    def n_active(self) -> int:
        return self._n_active

    def slot_view(self) -> List[Optional[int]]:
        """req_id per slot (None = free)."""
        return [None if s is None else s.req.req_id for s in self._slots]
