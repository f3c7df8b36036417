"""Host-side data plumbing (the port of part of ``apex1_tpu/runtime``).

- :func:`pack_documents`: the packed batches that ``GPT2(segment_ids=,
  positions=)`` and `flash_attention`'s segments train on. It is the
  JAX package's NumPy first-fit packing; its native (C) branch is not
  carried over, and both give the same arrays.
- :class:`RequestFeeder`: the serving engine's background ingest thread
  (tokenize off the engine's critical path, submit under bounded
  backoff), on `resilience.retry.backoff_delays` (re-exported here).
"""

from __future__ import annotations

import threading
import time as _time
from typing import Callable, Iterable, Optional, Sequence

import numpy as np

from apex1_tpu_torch.resilience.retry import backoff_delays


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


__all__ = ["pack_documents", "backoff_delays", "RequestFeeder"]


class RequestFeeder:
    """Background request-ingest thread for the serving engine: pulls
    raw prompts from ``source`` (an iterable of anything — text lines,
    token lists), tokenizes them OFF the engine's critical path, and
    pushes them through ``submit`` (the engine/scheduler entry point),
    absorbing `Backpressure` with the scheduler docstring's promised
    429/retry contract: BOUNDED EXPONENTIAL BACKOFF with deterministic
    jitter (`backoff_delays` — base ``retry_wait_s``,
    doubling, capped at ``retry_cap_s``, jittered so a burst of rejected
    feeders doesn't re-slam the queue in lockstep) and a
    drop-after-deadline rule: once an item has spent ``deadline_s``
    total in retries it is shed (``dropped``), because an overloaded
    engine must shed load, not stretch tail latency unboundedly.

    A structured rejection's ``retry_after_s`` is the server's backoff
    hint and is honored as a FLOOR on the next sleep: the exponential
    schedule may wait longer, never shorter — a thousand feeders
    retrying "soon" against a server that said "50 ms" is exactly the
    re-slam the hint exists to prevent. The floored delay still counts
    against ``deadline_s``.

    ``tokenize(item) -> (tokens, kwargs)`` where kwargs go straight to
    ``submit(tokens, **kwargs)`` (``max_new_tokens`` etc.). Rejections
    that outlive ``retries``/``deadline_s`` land in ``dropped`` with the
    reason. ``counters`` tracks the aggregate: ``submitted``,
    ``retries`` (backoff sleeps taken), ``dropped_backpressure``,
    ``dropped_error`` — the feed-side metrics record.

    The worker only SUBMITS; stepping the engine stays with the caller
    (the engine is not thread-safe by design — one loop owns the
    device). Typical shape::

        feeder = RequestFeeder(prompts, tokenize, engine.submit)
        feeder.start()
        while not feeder.idle or engine.n_active or engine.scheduler.depth:
            engine.step()
        feeder.join()
    """

    def __init__(self, source: Iterable, tokenize: Callable,
                 submit: Callable, *, retries: int = 100,
                 retry_wait_s: float = 0.005,
                 retry_cap_s: float = 0.25,
                 deadline_s: Optional[float] = None,
                 jitter: float = 0.5, seed: int = 0):
        self.source = source
        self.tokenize = tokenize
        self.submit = submit
        self.retries = int(retries)
        self.retry_wait_s = float(retry_wait_s)
        self.retry_cap_s = float(retry_cap_s)
        self.deadline_s = deadline_s
        self.jitter = float(jitter)
        self.seed = int(seed)
        self.submitted: list = []
        self.dropped: list = []          # (item, reason)
        self.errors: list = []
        self.counters = {"submitted": 0, "retries": 0,
                         "dropped_backpressure": 0, "dropped_error": 0}
        self._thread: Optional[threading.Thread] = None
        self._done = threading.Event()

    @property
    def idle(self) -> bool:
        """True once the source is drained and every item dispatched."""
        return self._done.is_set()

    def start(self) -> "RequestFeeder":
        from apex1_tpu_torch.serving.scheduler import (Backpressure,
                                                       new_request_id)

        def work():
            try:
                for n_item, item in enumerate(self.source):
                    # a PER-ITEM failure (tokenizer bug, contract
                    # ValueError from submit) drops THAT item and keeps
                    # feeding — one malformed request must not silently
                    # starve the rest of the stream
                    try:
                        tokens, kw = self.tokenize(item)
                    except Exception as e:
                        self.dropped.append((item, f"tokenize: {e!r}"))
                        self.counters["dropped_error"] += 1
                        self.errors.append(e)
                        continue
                    # one id across every retry attempt: transient
                    # backpressure rejections then update ONE metrics
                    # record instead of minting a phantom rejected
                    # record per attempt
                    kw.setdefault("req_id", new_request_id())
                    delays = backoff_delays(
                        self.retries, base_s=self.retry_wait_s,
                        cap_s=self.retry_cap_s, jitter=self.jitter,
                        seed=self.seed ^ n_item)
                    t0 = _time.monotonic()
                    while True:
                        try:
                            self.submitted.append(
                                self.submit(tokens, **kw))
                            self.counters["submitted"] += 1
                            break
                        except Backpressure as e:
                            d = next(delays, None)
                            if d is not None:
                                # server hint = the floor, not the value:
                                # back off MORE than asked, never less
                                floor = getattr(e, "retry_after_s", None)
                                if floor:
                                    d = max(d, float(floor))
                            waited = _time.monotonic() - t0
                            if d is None:
                                reason = f"{e.reason} (retries exhausted)"
                            elif (self.deadline_s is not None
                                  and waited + d > self.deadline_s):
                                reason = (f"{e.reason} (deadline "
                                          f"{self.deadline_s}s after "
                                          f"{waited:.3f}s)")
                            else:
                                self.counters["retries"] += 1
                                _time.sleep(d)
                                continue
                            self.dropped.append((item, reason))
                            self.counters["dropped_backpressure"] += 1
                            break
                        except Exception as e:
                            self.dropped.append((item, repr(e)))
                            self.counters["dropped_error"] += 1
                            self.errors.append(e)
                            break
            except BaseException as e:   # source iteration died —
                self.errors.append(e)    # surfaced via join()
            finally:
                self._done.set()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        return self

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)
        if self.errors:
            raise self.errors[0]
