"""Continuous-batching inference engine (the port of
``apex1_tpu/serving/engine.py``).

Requests join a fixed set of ``max_slots`` KV slots the moment one
frees and leave on EOS, length, deadline or cancellation; the decode
step never stops for them. Two pools, one admission logic:

- ``paged=True`` (the port's default, where its paged-attention kernel
  runs): one pool of pages per layer (`kv_pool.PagedKVPool`), addressed
  through per-slot block tables; the model runs the JAX package's
  kernel-path structure through `ops.paged_decode.PagedCache` entries.
- ``paged=False`` (the JAX package's default): the dense pool
  (`kv_pool.KVPool`), slot s is lane s of a (max_slots, Hkv, L, D) cache
  per layer, written in place through `models.generate.DenseCache`
  entries at each row's own device index; attention is the
  `ops.paged_decode.cache_attend` composite.

Either way:

- **prefill** — one ``(1, prefill_chunk)`` chunk-decode forward of the
  slot (its block-table row, or its lane). Every prompt is fed as
  right-padded fixed-width chunks at its cache index; the first token
  is sampled from the last real position with
  `ops.paged_decode.fused_sample`.
- **decode** — ONE batch-N forward over every slot: each row carries
  its own cache index (rows are at different depths) and sampling runs
  `fused_sample` over the (N, V) logits rows. Inactive rows compute
  masked garbage (into the trash page, or their own free lane).
- **verify** (``num_draft = K > 0``) replaces decode: the host proposes
  K draft tokens per slot (`spec.ngram_propose`, or ``draft_propose=``)
  and ONE ``(N, K + 1)`` chunk-decode forward scores each slot's last
  token plus its drafts at the row's own cache index; `fused_sample`
  draws the target's counter-keyed token at every position, and a slot
  emits its longest accepted prefix plus the correction token. Drafts
  are hints: draft j is accepted only if it equals the token the engine
  would have sampled there, so a spec engine emits the non-spec
  engine's tokens.

MULTI-TENANT LORA (``lora_rank > 0``): adapter pages live in a
`lora.LoraAdapterStore` beside the KV pool; each slot carries a
rank-length page row and an on-flag. The forward returns the hidden
states (``return_hidden=True``), the logits are the model's own head
(`models.gpt2.head_logits` on ``lora_head``), and
`ops.lora_epilogue.lora_delta` adds each row's delta where its flag is
on; an off row keeps the model's logits bit for bit.

On CUDA tensors those are the port's kernels; on the CPU their plain
PyTorch versions. PyTorch runs eagerly, so the JAX engine's
``trace_counts`` (its compile-count hook) has no meaning here and is
not kept.

SAMPLING is counter-based and per request: token i of a request is
drawn with ``fold_in(key(seed), i)`` in jax's threefry stream, so the
stream is a pure function of (params, prompt, seed) and equals the JAX
engine's token for token on the same params — the property replica
restarts, failover and hedging resubmit on.

RADIX PREFIX CACHE (``prefix_cache=True``, the default): admission
matches the request's full prompt (an explicit ``prefix=`` concatenated
in front) against registered prefixes, installs the longest match (a
page copy in the dense pool, shared page ids in the paged one) and
prefills only the rest. Prompts without an explicit prefix
auto-register at the chunk-aligned share point; an explicit prefix
registers at its own length. ``prefix_cache=False`` keeps only the
explicit prefix's exact-tuple sharing.

CANCEL AND DEADLINES: `cancel` retires a queued request at once, a
running one at once (its slot, prefix references and adapter pages
released before it returns), and one whose admission is being built by
the engine loop right now (a cancel from another thread) the moment its
prefill chain completes (``_admit_lock`` / ``_mid_admit`` /
``_cancel_mid``). `step` evicts queued and running requests whose
deadline (on ``clock``, ``time.monotonic`` unless given) has passed.
`pop_result` removes a finished result.

DEVICE-RESIDENT CONTROL: the per-slot token / index / active / seed /
output-position vectors and the block tables live on the device and
are patched in place only at join/leave boundaries. With
``eos_id=None`` the engine never reads a step's tokens back before
dispatching the next: per-step outputs collect in a device-side log,
read once at retirement. With an ``eos_id`` each step's tokens are read
back (one small blocking copy per step) to retire rows; speculative mode
always reads back (drafting needs the history, accept counts gate
retirement).
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from apex1_tpu_torch.models.generate import DenseCache
from apex1_tpu_torch.models.gpt2 import head_logits
from apex1_tpu_torch.ops._common import resolve_device
from apex1_tpu_torch.ops.lora_epilogue import lora_delta
from apex1_tpu_torch.ops.paged_decode import PagedCache, fused_sample
from apex1_tpu_torch.resilience.retry import _mix32
from apex1_tpu_torch.serving.kv_pool import KVPool, PagedKVPool
from apex1_tpu_torch.serving.lora import LoraAdapterStore
from apex1_tpu_torch.serving.metrics import ServingMetrics
from apex1_tpu_torch.serving.scheduler import (Backpressure, Request,
                                               Scheduler)
from apex1_tpu_torch.serving.spec import ngram_propose
from apex1_tpu_torch.utils.observability import MetricsLogger, annotate


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
    and their meaning are the JAX package's; ``cache_dtype`` takes a
    torch dtype, and ``paged`` defaults to True (the JAX package's
    default is False): the paged pool is where the port's kernels run."""

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
    prefix_cache: bool = True    # radix cross-request prefix matching
    max_prefix_pages: int = 32   # LRU-by-last-hit prefix bound
    num_draft: int = 0           # >0: speculative verify, K drafts
    max_ngram: int = 3           # self-draft prompt-lookup n-gram cap
    cache_dtype: Optional[object] = None  # e.g. torch.int8; None = the
    #                                       decoder's compute dtype
    paged: bool = True           # False: the dense slot pool (KVPool)
    page_size: Optional[int] = None  # None = max(8, ceil8(chunk))
    lora_rank: int = 0           # >0: multi-tenant LoRA adapter pages
    lora_max_adapters: int = 4   # adapter pages = 1 + max_adapters * rank

    def __post_init__(self):
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if self.max_len < 2:
            raise ValueError("max_len must be >= 2")
        if self.num_draft < 0:
            raise ValueError(
                f"num_draft must be >= 0, got {self.num_draft}")
        if self.max_ngram < 1:
            raise ValueError(f"max_ngram must be >= 1, got {self.max_ngram}")
        if self.max_prefix_pages < 1:
            raise ValueError("max_prefix_pages must be >= 1")
        if self.page_size is not None and self.page_size < 1:
            raise ValueError(
                f"page_size must be >= 1, got {self.page_size}")
        if self.lora_rank < 0:
            raise ValueError(
                f"lora_rank must be >= 0, got {self.lora_rank}")
        if self.lora_rank > 0 and self.lora_max_adapters < 1:
            raise ValueError(
                f"lora_max_adapters must be >= 1, "
                f"got {self.lora_max_adapters}")


@dataclasses.dataclass
class RequestResult:
    """Terminal outcome. ``tokens`` holds whatever was generated before
    the terminal event."""

    req_id: int
    status: str                  # done | evicted | cancelled
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
    # speculative bookkeeping: the request's known tokens (prompt +
    # emitted, the self-draft corpus) and its accept-rate numerators
    history: List[int] = dataclasses.field(default_factory=list)
    drafted: int = 0
    accepted: int = 0


class Engine:
    """Continuous-batching engine over a ``(apply_fn, make_cache)``
    decoder pair (`models.generate.gpt2_decoder`), on ``device`` (CUDA
    unless the caller names another; asking for CUDA without a card
    raises). The model's parameters and cache must live there.

    Drive it with `submit` + `step`/`run`; finished requests appear in
    `results` (`pop_result` removes one). One `step()` = retire
    (deadline) -> admit queued requests into free slots (chunked
    prefill) -> one pooled decode (or speculative verify) step.
    ``draft_propose(history, k) -> k ints`` plugs a draft source into
    speculative mode (default: n-gram prompt lookup). ``lora_head``,
    required with ``lora_rank > 0``, is the model's own (vocab, hidden)
    LM-head weight (``model.output`` for `Llama`); the decoder's
    ``apply_fn`` must then take ``return_hidden=True``. ``cache_dtype``
    overrides the config's (degraded-mode restarts pass it); ``clock``
    is the deadline clock.
    """

    def __init__(self, apply_fn: Callable, make_cache: Callable,
                 config: Optional[EngineConfig] = None, *, device=None,
                 metrics_logger: Optional[MetricsLogger] = None,
                 cache_dtype=None,
                 draft_propose: Optional[Callable] = None,
                 lora_head: Optional[torch.Tensor] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.device = resolve_device(device)
        self.cfg = cfg = config or EngineConfig()
        self._apply_fn = apply_fn
        self._clock = clock or time.monotonic
        self._spec = cfg.num_draft > 0
        self._lora = self._lora_head = None
        if cfg.lora_rank > 0:
            if lora_head is None:
                raise ValueError(
                    "lora_rank > 0 requires lora_head= (the model's "
                    "(vocab, hidden) LM-head weight)")
            V, H = lora_head.shape
            self._lora = LoraAdapterStore(H, V, cfg.lora_rank,
                                          cfg.lora_max_adapters,
                                          device=self.device)
            self._lora_head = lora_head
        self._draft_propose = draft_propose or (
            lambda hist, k: ngram_propose(hist, k,
                                          max_ngram=cfg.max_ngram))
        # the final prefill chunk is right-padded to the full width, and
        # a verify writes num_draft + 1 entries at a row's index: the
        # pool carries the wider write's overhang past max_len
        slack = max(cfg.prefill_chunk, cfg.num_draft + 1) - 1
        if cache_dtype is None:
            cache_dtype = cfg.cache_dtype
        self._paged = bool(cfg.paged)
        if self._paged:
            page_size = cfg.page_size or max(
                8, -(-cfg.prefill_chunk // 8) * 8)
            self.kv = PagedKVPool(make_cache, cfg.max_slots,
                                  cfg.max_len + slack, page_size=page_size,
                                  dtype=cache_dtype,
                                  max_pages=cfg.max_prefix_pages)
            leaf = next(iter(self.kv.pages.values()))["k"]
        else:
            self.kv = KVPool(make_cache, cfg.max_slots,
                             cfg.max_len + slack, dtype=cache_dtype,
                             max_pages=cfg.max_prefix_pages)
            leaf = next(iter(self.kv.cache.values()))
            leaf = next(iter(leaf.values()))
        if leaf.device.type != self.device.type:
            raise ValueError(f"the decoder's cache lives on {leaf.device}, "
                             f"the engine on {self.device}")
        self.scheduler = Scheduler(max_queue=cfg.max_queue,
                                   policy=cfg.policy)
        self.metrics = ServingMetrics(metrics_logger)
        self.results: Dict[int, RequestResult] = {}
        self._slots: List[Optional[_Slot]] = [None] * cfg.max_slots
        self._sample_kw = dict(temperature=cfg.temperature,
                               top_k=cfg.top_k, vocab_size=cfg.vocab_size)
        # device-resident control vectors (and block tables), patched in
        # place at join/leave boundaries only; freed rows name the trash
        # page so an inactive row's garbage write never lands on a page
        # a new request owns
        dev, i32 = self.device, torch.int32
        n = cfg.max_slots
        if self._paged:
            self._d_bt = torch.zeros((n, self.kv.pages_per_lane),
                                     dtype=i32, device=dev)
        self._d_toks = torch.zeros((n,), dtype=i32, device=dev)
        self._d_idxs = torch.zeros((n,), dtype=i32, device=dev)
        self._d_active = torch.zeros((n,), dtype=torch.bool, device=dev)
        self._d_seeds = torch.zeros((n,), dtype=i32, device=dev)
        self._d_pos = torch.zeros((n,), dtype=i32, device=dev)
        if self._lora is not None:
            # per-slot adapter page row + on-flag, patched at the same
            # join/leave boundaries; all-zero rows name the zero page
            self._d_lora_bt = torch.zeros((n, cfg.lora_rank), dtype=i32,
                                          device=dev)
            self._d_lora_on = torch.zeros((n,), dtype=torch.bool,
                                          device=dev)
        self._n_active = 0
        # eos_id=None: retirement is length-based, so step tokens are
        # only READ at retirement — the log keeps each step's (N,)
        # output (a device tensor until its first fetch memoizes it).
        # Speculative mode always reads back.
        self._defer = cfg.eos_id is None and not self._spec
        self._tok_log: Dict[int, object] = {}
        self._step_no = 0
        # the mid-admission cancel window: a cancel from another thread
        # while `_admit` runs this request's prefill chain. The lock
        # serializes the handshake (check + add against clear + read),
        # so a cancel that saw _mid_admit cannot land after _admit
        # drained the set
        self._mid_admit: Optional[int] = None
        self._cancel_mid: set = set()
        self._admit_lock = threading.Lock()
        self._probe_cache: Dict[int, bool] = {}
        self._probe_cache_ver = -1

    def _sync_bt(self, slot: int) -> None:
        """Push one slot's host block-table row to the device mirror —
        called wherever the host row changes, never on the step path
        (paged pool only)."""
        if self._paged:
            self._d_bt[slot] = torch.as_tensor(
                self.kv.block_tables[slot], dtype=torch.int32).to(
                    self.device)

    def _cache(self, slot: Optional[int] = None) -> dict:
        """The per-layer cache entries of every slot (``slot`` None) or
        of one slot: `PagedCache` over the block tables, or
        `DenseCache` views of the pool's lanes (written in place)."""
        if self._paged:
            bt = self._d_bt if slot is None else self._d_bt[slot:slot + 1]
            L = self.kv.lane_len
            return {layer: PagedCache(e["k"], e["v"], bt, L)
                    for layer, e in self.kv.pages.items()}
        tree = self.kv.cache if slot is None else self.kv.lane(slot)
        # an entry that is not K/V (a toy decoder's) goes to the model
        # as its dict of pool views, which the model writes in place
        return {layer: (DenseCache(e["k"], e["v"]) if set(e) == {"k", "v"}
                        else e)
                for layer, e in tree.items()}

    # ---- the forwards ---------------------------------------------------

    def _forward(self, tokens, cache, idx, **kw):
        """The model's (B, S, V) fp32 logits, and with LoRA on its
        (B, S, H) final hidden states (the logits then the model's own
        head on ``lora_head``), else None."""
        if self._lora is None:
            return self._apply_fn(tokens, cache, idx, **kw)[0], None
        h, _ = self._apply_fn(tokens, cache, idx, return_hidden=True, **kw)
        return head_logits(h, self._lora_head.to(h.dtype)), h

    def _add_lora(self, logits, h, lbt, on):
        """(R, V) logits plus the adapter delta of the (R, H) hidden rows
        through their (R, rank) page rows, where ``on``; off rows keep
        the model's logits bit for bit (no ``+ 0.0``)."""
        delta = lora_delta(h, self._lora.a_pages, self._lora.b_pages, lbt)
        return torch.where(on[:, None], logits + delta, logits)

    def _install(self, slot: int, lane: dict) -> None:
        """Copy a batch-1 lane (zeros or a prefix page) over the slot's
        lane (dense pool only)."""
        for layer, entry in self.kv.lane(slot).items():
            for kv, t in entry.items():
                t.copy_(lane[layer][kv])

    def _prefill(self, slot: int, tokens: np.ndarray, idx: int,
                 n_real: int, seed: int) -> torch.Tensor:
        """One (1, C) chunk of slot ``slot`` at cache index ``idx``;
        returns the device token sampled after its last real position
        (the request's output #0)."""
        C, dev = self.cfg.prefill_chunk, self.device
        positions = (idx + torch.arange(C, device=dev))[None]
        logits, h = self._forward(
            torch.from_numpy(tokens).to(dev), self._cache(slot), idx,
            positions=positions, chunk_decode=True)
        lg = logits[:, n_real - 1]
        if self._lora is not None:
            lg = self._add_lora(lg, h[:, n_real - 1],
                                self._d_lora_bt[slot:slot + 1],
                                self._d_lora_on[slot:slot + 1])
        seeds = torch.full((1,), seed, dtype=torch.int32, device=dev)
        pos0 = torch.zeros((1,), dtype=torch.int32, device=dev)
        return fused_sample(lg, seeds, pos0, **self._sample_kw)[0]

    def _decode(self):
        """One batch-N decode step over every slot."""
        logits, h = self._forward(
            self._d_toks[:, None], self._cache(), self._d_idxs,
            positions=self._d_idxs[:, None])
        lg = logits[:, -1]
        if self._lora is not None:
            lg = self._add_lora(lg, h[:, -1], self._d_lora_bt,
                                self._d_lora_on)
        nxt = fused_sample(lg, self._d_seeds, self._d_pos,
                           **self._sample_kw)
        nxt = torch.where(self._d_active, nxt, self.cfg.pad_id)
        adv = self._d_active.to(torch.int32)
        return nxt, self._d_idxs + adv, self._d_pos + adv

    def _verify(self, drafts: torch.Tensor):
        """One (N, K + 1) verify forward over every slot: each row's
        last token and its K drafts at the row's cache index. Returns
        the target tokens (N, K + 1), the accepted draft counts (N,)
        and the next tokens, indices and output positions."""
        K, i32 = self.cfg.num_draft, torch.int32
        active = self._d_active
        ar = torch.arange(K + 1, dtype=i32, device=self.device)
        chunks = torch.cat([self._d_toks[:, None], drafts], 1)
        logits, h = self._forward(
            chunks, self._cache(), self._d_idxs,
            positions=self._d_idxs[:, None] + ar, chunk_decode=True)
        N, V = logits.shape[0], logits.shape[-1]
        flat = logits.reshape(-1, V)
        if self._lora is not None:
            # the (N, K + 1) rows flattened into the delta's batch, each
            # repeating its slot's page row
            flat = self._add_lora(
                flat, h.reshape(N * (K + 1), -1),
                self._d_lora_bt.repeat_interleave(K + 1, dim=0),
                self._d_lora_on.repeat_interleave(K + 1, dim=0))
        posm = self._d_pos[:, None] + ar
        seedm = self._d_seeds[:, None].expand(N, K + 1)
        tgt = fused_sample(flat, seedm.reshape(-1), posm.reshape(-1),
                           **self._sample_kw).reshape(N, K + 1)
        acc = torch.cumprod((tgt[:, :K] == drafts).to(i32), dim=1).sum(1)
        acc = torch.where(active, acc.to(i32), 0)
        adv = torch.where(active, acc + 1, 0)
        nxt = torch.where(active, tgt.gather(1, acc[:, None].long())[:, 0],
                          self.cfg.pad_id)
        return tgt, acc, nxt, self._d_idxs + adv, self._d_pos + adv

    # ---- multi-tenant LoRA adapters -------------------------------------

    def register_adapter(self, tenant: str, A, B, *, scale: float = 1.0):
        """Install ``tenant``'s LM-head adapter (``A`` (H, r), ``B``
        (r, V)); later ``submit(tenant=...)`` requests decode through
        it."""
        if self._lora is None:
            raise RuntimeError(
                "register_adapter requires EngineConfig(lora_rank > 0)")
        return self._lora.register(tenant, A, B, scale=scale)

    def unregister_adapter(self, tenant: str) -> None:
        """Retire ``tenant``'s adapter. Running requests keep their
        pinned pages until retirement; new submits with this tenant
        decode adapterless."""
        if self._lora is None:
            raise RuntimeError(
                "unregister_adapter requires EngineConfig(lora_rank > 0)")
        self._lora.unregister(tenant)

    def _lora_release(self, slot: int) -> None:
        """Unpin a slot's adapter pages and zero its device row (the
        freed row keeps computing, so it must stop naming live pages)."""
        if self._lora is None:
            return
        self._lora.release(slot)
        self._d_lora_bt[slot] = 0
        self._d_lora_on[slot] = False

    # ---- submission -----------------------------------------------------

    def submit(self, tokens, max_new_tokens: int, *, prefix=None,
               deadline: Optional[float] = None,
               req_id: Optional[int] = None,
               qos: str = "best_effort", tenant: Optional[str] = None,
               seed: Optional[int] = None) -> int:
        """Enqueue a request. Raises `Backpressure` when the queue is
        full and holds no weaker-class victim to shed (or the deadline
        already passed), and `ValueError` when the request can never fit
        (prefix + prompt + max_new_tokens - 1 > max_len). ``prefix``:
        shared-prefix ids in front of ``tokens``; ``deadline``: on the
        engine's clock; ``tenant`` names a registered LoRA adapter
        (unknown or None: adapterless); ``seed`` pins the request's
        sampling stream (None derives one from the request id)."""
        req = Request(tokens=tokens, max_new_tokens=max_new_tokens,
                      prefix=prefix, deadline=deadline, req_id=req_id,
                      qos=qos, tenant=tenant, seed=seed)
        if req.seed is None:
            req.seed = derive_request_seed(self.cfg.seed, req.req_id)
        if req.total_len > self.cfg.max_len:
            raise ValueError(
                f"request needs {req.total_len} cache positions but "
                f"slots hold max_len={self.cfg.max_len}")
        try:
            rid = self.scheduler.submit(req, now=self._clock())
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

    def cancel(self, req_id: int) -> bool:
        """Cancel a queued or running request. A running request is
        retired at once: its slot, prefix references and adapter pages
        are released before this returns. A request whose admission the
        engine loop is building right now (a cancel from another thread)
        is flagged and retired the moment its prefill chain completes."""
        if self.scheduler.cancel(req_id):
            self._finish(req_id, "cancelled", "cancelled queued", [])
            return True
        with self._admit_lock:
            if req_id == self._mid_admit:
                self._cancel_mid.add(req_id)
                return True
        for i, slot in enumerate(self._slots):
            if slot is not None and slot.req.req_id == req_id:
                self._retire(i, "cancelled", "cancelled running")
                return True
        return False

    # ---- the engine loop ------------------------------------------------

    @torch.inference_mode()
    def step(self) -> int:
        """One engine iteration: retire expired deadlines -> admit -> one
        decode step over every occupied slot. Returns the number of
        active slots that decoded (0 = idle). Runs under inference mode:
        serving records no autograd graph."""
        now = self._clock()
        for req in self.scheduler.expire(now):
            self._finish(req.req_id, "evicted", "deadline (queued)", [])
        for i, slot in enumerate(self._slots):
            if (slot is not None and slot.req.deadline is not None
                    and slot.req.deadline <= now):
                self._retire(i, "evicted", "deadline")
        self._admit_all()
        n_active = self._n_active
        if n_active and self._spec:
            self._spec_step()
        elif n_active:
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
                slot.history.append(tok)
                if tok == self.cfg.eos_id:
                    slot.eos_seen = True
                    self._retire(i, "done", "eos")
                    continue
            if slot.n_out >= slot.req.max_new_tokens:
                self._retire(i, "done", "length")

    def _spec_step(self):
        """One draft -> verify round for every occupied slot: the host
        proposes K tokens per slot from its history, one verify forward
        scores all slots, and each slot emits its accepted prefix plus
        the correction token (1..K+1 tokens, clamped to the request's
        length). The accept counts gate retirement, so this step reads
        the (small) verify outputs back."""
        cfg = self.cfg
        K = cfg.num_draft
        drafts = np.zeros((cfg.max_slots, K), np.int32)
        for i, st in enumerate(self._slots):
            if st is not None and st.in_batch:
                drafts[i] = np.asarray(
                    self._draft_propose(st.history, K),
                    np.int32).reshape(K)
        with annotate("serving/verify_step"):
            tgt, acc, nxt, self._d_idxs, self._d_pos = self._verify(
                torch.from_numpy(drafts).to(self.device))
        self.metrics.incr("verify_steps")
        self._d_toks = nxt
        tgt_np = tgt.cpu().numpy()
        acc_np = acc.cpu().numpy()
        self._step_no += 1
        for i, st in enumerate(self._slots):
            if st is None or not st.in_batch:
                continue
            a = int(acc_np[i])
            remaining = st.req.max_new_tokens - st.n_out
            emitted = [int(t) for t in tgt_np[i, :a + 1][:remaining]]
            # the accept rate counts only the draft positions that could
            # land inside the emission window
            d_used = min(K, remaining)
            a_used = min(a, d_used)
            st.drafted += d_used
            st.accepted += a_used
            self.metrics.incr("spec_drafted", d_used)
            self.metrics.incr("spec_accepted", a_used)
            done_reason = None
            n_emit = 0
            for t in emitted:
                st.produced.append(t)
                st.history.append(t)
                st.n_out += 1
                n_emit += 1
                if cfg.eos_id is not None and t == cfg.eos_id:
                    st.eos_seen = True
                    done_reason = "eos"
                    break
            self.metrics.event(st.req.req_id, "token", n=n_emit)
            if done_reason is None and st.n_out >= st.req.max_new_tokens:
                done_reason = "length"
            if done_reason is not None:
                self._retire(i, "done", done_reason)

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
            if (self.cfg.prefix_cache
                    and self.scheduler.depth > self.kv.n_free):
                # near capacity: a radix hit turns a slot over sooner,
                # so prefer hits WITHIN a QoS class
                prefer = self._would_hit
            batch = self.scheduler.pop(1, prefer=prefer)
            if not batch:
                return
            self._admit(batch[0])

    @staticmethod
    def _full_prompt(req: Request) -> np.ndarray:
        if req.prefix:
            return np.concatenate([np.asarray(req.prefix, np.int32),
                                   req.tokens])
        return req.tokens

    def _would_hit(self, req: Request) -> bool:
        """Prefix-aware admission probe (a host-side radix walk),
        memoized per (request, page-store version)."""
        ver = self.kv.store_version
        if self._probe_cache_ver != ver:
            self._probe_cache_ver = ver
            self._probe_cache.clear()
        hit = self._probe_cache.get(req.req_id)
        if hit is None:
            full = self._full_prompt(req)
            hit = self.kv.match(full, int(full.size) - 1)[1] is not None
            if len(self._probe_cache) >= 2 * self.cfg.max_queue:
                self._probe_cache.clear()
            self._probe_cache[req.req_id] = hit
        return hit

    def _admit(self, req: Request):
        cfg = self.cfg
        if req.deadline is not None and req.deadline <= self._clock():
            # expired between the step's sweep and this admission (an
            # earlier admission's prefill ran meanwhile): evict before
            # touching the pool
            self._finish(req.req_id, "evicted", "deadline (queued)", [])
            return
        slot = self.kv.alloc()
        if slot is None:
            raise RuntimeError("admission without a free slot")
        # the freshly owned page row must be on the device before any
        # prefill chunk writes through it
        self._sync_bt(slot)
        if self._lora is not None:
            # pin the tenant's pages and patch the slot's row BEFORE the
            # prefill chain: token 0 already samples through the delta
            lrow, on = self._lora.acquire(req.tenant, slot)
            self._d_lora_bt[slot] = torch.as_tensor(
                lrow, dtype=torch.int32).to(self.device)
            self._d_lora_on[slot] = bool(on)
        prefix = tuple(req.prefix) if req.prefix else ()
        full = self._full_prompt(req)
        key = page = None
        if cfg.prefix_cache:
            # cap at len-1: a full-prompt hit must still leave >= 1 real
            # token to prefill (the logit the first token samples from)
            key, page = self.kv.match(full, int(full.size) - 1)
            self.metrics.incr("prefix_lookups")
            if page is not None:
                self.metrics.incr("prefix_hits")
                self.metrics.incr("prefix_saved_tokens", page.length)
        elif prefix:
            # radix matching off: a second sharer of the same explicit
            # prefix reuses (not re-registers) its page
            page = self.kv.get_prefix(prefix)
            key = prefix if page is not None else None
        hit = page is not None
        self.metrics.event(
            req.req_id, "prefill",
            prefix_hit=(hit if cfg.prefix_cache else None),
            prefix_saved=(page.length if hit else 0))
        with self._admit_lock:
            self._mid_admit = req.req_id
        try:
            with annotate("serving/prefill"):
                if hit:
                    self.kv.acquire_prefix(key, slot)
                    if self._paged:
                        # the acquire rewired the slot's block table
                        # onto the shared pages: they are the hit
                        self._sync_bt(slot)
                        install_lane, idx0 = None, page.length
                    else:
                        install_lane, idx0 = page.lane, page.length
                    if (prefix and idx0 < len(prefix)
                            and not self.kv.has_prefix(prefix)):
                        # a partial hit below the stated share point:
                        # pay the prefix's remainder, then pin the
                        # explicit page at its stated length
                        self._run_chunks(slot, full[idx0:len(prefix)],
                                         idx0, install_lane, req.seed)
                        self._register_page(slot, prefix, len(prefix))
                        install_lane, idx0 = None, len(prefix)
                    tok0 = self._run_chunks(slot, full[idx0:], idx0,
                                            install_lane, req.seed)
                elif prefix:
                    # the first sharer pays: the prefix's own chunks,
                    # then its page, then the rest
                    self._run_chunks(slot, full[:len(prefix)], 0,
                                     self.kv.zeros_lane, req.seed)
                    self._register_page(slot, prefix, len(prefix))
                    tok0 = self._run_chunks(slot, full[len(prefix):],
                                            len(prefix), None, req.seed)
                else:
                    tok0 = self._run_chunks(slot, full, 0,
                                            self.kv.zeros_lane, req.seed)
            if cfg.prefix_cache and not prefix:
                # auto-registration at the chunk-aligned share point:
                # canonical lengths, so requests that split the same
                # prompt differently converge on one key; the last
                # token stays uncached
                C = cfg.prefill_chunk
                lstar = ((int(full.size) - 1) // C) * C
                if lstar >= C and lstar > (page.length if hit else 0):
                    akey = tuple(int(t) for t in full[:lstar])
                    if not self.kv.has_prefix(akey):
                        self._register_page(slot, akey, lstar)
        except BaseException:
            # a prefill chain that dies mid-flight must not leak the
            # slot or any acquired page refs; the verdict belongs to
            # the caller (re-raise)
            self.kv.free(slot)
            self._sync_bt(slot)
            self._lora_release(slot)
            with self._admit_lock:
                self._mid_admit = None
                self._cancel_mid.discard(req.req_id)
            raise
        self.metrics.event(req.req_id, "first_token")
        idx = int(full.size)
        st = _Slot(req=req, first_tok=tok0, start_step=self._step_no,
                   history=[int(t) for t in full])
        self._slots[slot] = st
        # close the mid-admission window only AFTER the slot is
        # published (a later cancel finds it in _slots), then drain a
        # cancel that landed during the chain
        with self._admit_lock:
            self._mid_admit = None
            cancelled = req.req_id in self._cancel_mid
            self._cancel_mid.discard(req.req_id)
        first = None
        if not self._defer:             # eos_id or spec: read it now
            first = int(tok0)
            st.first_tok = first
            st.produced.append(first)
            st.history.append(first)
        if cancelled:
            # the cancel preceded any published result: it wins over an
            # eos or length finish in this same admission
            self._retire(slot, "cancelled", "cancelled running")
            return
        if first is not None and cfg.eos_id is not None \
                and first == cfg.eos_id:
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
        """Make ``slot``'s first ``length`` positions a shared prefix and
        take the owner's ref. The paged pool pins the slot's own pages
        (no copy; the length floors to a page multiple); the dense pool
        snapshots the slot's lane."""
        if self._paged:
            if self.kv.register_prefix(slot, pkey, length) is not None:
                self.kv.acquire_prefix(pkey, slot)
            return
        lane = {layer: {kv: t.clone() for kv, t in e.items()}
                for layer, e in self.kv.lane(slot).items()}
        self.kv.put_prefix(pkey, lane, length)
        self.kv.acquire_prefix(pkey, slot)

    def _run_chunks(self, slot: int, tokens: np.ndarray, idx0: int,
                    install_lane, seed: int):
        """Feed ``tokens`` through prefill in fixed-width right-padded
        chunks starting at cache position ``idx0``. ``install_lane``: a
        batch-1 lane written over the slot's lane before the first chunk
        (zeros, or a shared-prefix page; dense pool only), None to
        continue on the lane as it is. Returns the device token sampled
        after the final chunk."""
        if install_lane is not None and not self._paged:
            self._install(slot, install_lane)
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
        self._lora_release(slot_idx)
        spec = ({"n_drafted": slot.drafted, "n_accepted": slot.accepted}
                if self._spec else {})
        self._finish(slot.req.req_id, status, reason, produced, **spec)

    def _finish(self, req_id: int, status: str, reason: str,
                produced: List[int], **fields):
        if status == "evicted" and not reason.startswith("shed"):
            self.metrics.incr("evictions")
        self.metrics.event(req_id, status, reason=reason,
                           n_generated=len(produced), **fields)
        self.results[req_id] = RequestResult(
            req_id=req_id, status=status,
            tokens=np.asarray(produced, np.int32), reason=reason)

    # ---- introspection --------------------------------------------------

    def pop_result(self, req_id: int) -> Optional[RequestResult]:
        """Remove and return a finished request's result (a long-running
        server's valve: `results` otherwise grows with every request
        served; pair with `metrics.drain()`)."""
        return self.results.pop(req_id, None)

    @property
    def n_active(self) -> int:
        return self._n_active

    def slot_view(self) -> List[Optional[int]]:
        """req_id per slot (None = free)."""
        return [None if s is None else s.req.req_id for s in self._slots]
