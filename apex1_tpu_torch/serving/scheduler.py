"""Admission queue for the serving engine (a copy of
``apex1_tpu/serving/scheduler.py``, which imports no JAX; the port keeps
its own): bounded backpressure, FIFO /
shortest-prompt-first policies, per-tenant QoS classes, per-request
deadlines, cancellation.

The scheduler is pure host-side bookkeeping — it decides WHICH request
enters a freed KV slot; the engine decides WHEN (whenever a slot is
free at a step boundary). Policies:

- ``fifo`` — arrival order. Predictable TTFT ordering; long prompts at
  the head delay everyone (head-of-line blocking).
- ``sjf`` — shortest prompt first. Minimizes mean TTFT under mixed
  lengths (a short prompt's prefill is cheap, so serving it first costs
  the long one little); starvation is bounded by the queue's deadline
  mechanism, not by the policy.

QoS classes (`Request.qos`) generalize the deadline mechanism into a
tenant contract, ordered strongest to weakest:

- ``guaranteed`` — dequeued first; NEVER shed while weaker-class load
  is present (the overload drill's pinned property).
- ``best_effort`` — the default; dequeued after guaranteed, shed only
  once every sheddable request is gone.
- ``sheddable`` — batch/backfill traffic; first out the airlock under
  overload, both at the queue (`submit` sheds it to admit a stronger
  class) and at the frontend (degraded-mode load shedding).

Within a class the dequeue policy (fifo/sjf) applies unchanged, so the
class lattice never reorders same-class tenants — cross-class priority,
intra-class fairness.

Backpressure is a bounded queue: `submit` on a full queue first tries
to SHED a strictly-weaker queued request (weakest class first, youngest
first — it has waited least); only when no weaker victim exists does it
raise `Backpressure`, carrying structured fields — ``queue_depth`` and
``retry_after_s`` (the backoff floor `runtime.RequestFeeder` honors) —
so the caller's 429 tells the client WHEN to come back, not just no.
A silent unbounded queue would instead convert overload into unbounded
TTFT, the failure mode continuous batching exists to avoid.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

POLICIES = ("fifo", "sjf")

#: QoS classes, strongest first; index = priority rank (lower = first
#: dequeued, last shed)
QOS_CLASSES = ("guaranteed", "best_effort", "sheddable")

_ids = itertools.count()


def new_request_id() -> int:
    """Reserve a request id up front — for callers that may SUBMIT the
    same logical request several times (`runtime.RequestFeeder`'s
    bounded backpressure retry, `serving.replica`'s failover
    resubmission): a stable id keeps metrics at one record per request
    AND (via the engine's derived per-request sampling seed) makes the
    regenerated token stream bit-identical to the lost one."""
    return next(_ids)


def qos_rank(qos: str) -> int:
    """Priority rank of a QoS class (0 = strongest). Raises on unknown
    classes — a typo'd class silently becoming best-effort would void
    the tenant contract."""
    try:
        return QOS_CLASSES.index(qos)
    except ValueError:
        raise ValueError(f"qos must be one of {QOS_CLASSES}, got {qos!r}")


class Backpressure(Exception):
    """Admission rejected; ``reason`` says why (machine-readable).

    Structured fields (both optional — None when the rejecting layer
    can't estimate them):

    - ``queue_depth``: queued requests at rejection time.
    - ``retry_after_s``: the server's backoff hint — the FLOOR for any
      client retry delay (`runtime.RequestFeeder` clamps its
      exponential-backoff schedule up to it). 0.0 means "retrying is
      pointless" (e.g. the deadline already passed at submit).
    """

    def __init__(self, reason: str, *,
                 queue_depth: Optional[int] = None,
                 retry_after_s: Optional[float] = None):
        super().__init__(reason)
        self.reason = reason
        self.queue_depth = queue_depth
        self.retry_after_s = retry_after_s


@dataclasses.dataclass
class Request:
    """One generation request.

    ``tokens``: prompt ids (1-D). ``prefix``: optional shared-prefix ids
    (e.g. a system prompt) — requests with an identical prefix tuple
    share its K/V through the pool's prefix pages. ``deadline``:
    absolute `time.monotonic()` instant; past it the request is evicted
    wherever it is (queued or mid-decode) and its slot freed. ``qos``:
    tenant class (see `QOS_CLASSES`). ``seed``: per-request sampling
    seed — the engine derives one from the request id when None, so a
    resubmitted request (same id) regenerates the identical stream.
    """

    tokens: np.ndarray
    max_new_tokens: int
    prefix: Optional[Tuple[int, ...]] = None
    deadline: Optional[float] = None
    req_id: Optional[int] = None
    qos: str = "best_effort"
    tenant: Optional[str] = None
    seed: Optional[int] = None
    submitted_at: float = 0.0

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens, np.int32).reshape(-1)
        if self.tokens.size < 1:
            raise ValueError("empty prompt (after the shared prefix, a "
                             "request needs >= 1 token of its own)")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        if self.prefix is not None:
            self.prefix = tuple(int(t) for t in self.prefix)
        qos_rank(self.qos)                     # validate loudly
        if self.seed is not None:
            # the engine's counter keys take int32 seeds; an unmasked
            # 64-bit seed would pass admission and then crash the
            # engine step — under a supervisor that reads as a replica
            # crash loop. Fold deterministically instead.
            self.seed = int(self.seed) & 0x7FFFFFFF
        if self.req_id is None:
            self.req_id = next(_ids)

    @property
    def total_len(self) -> int:
        """Cache positions the request needs: prefix + prompt +
        generated (the final sampled token is never written back)."""
        plen = len(self.prefix) if self.prefix else 0
        return plen + self.tokens.size + self.max_new_tokens - 1

    @property
    def rank(self) -> int:
        return qos_rank(self.qos)


class Scheduler:
    """Bounded admission queue with pluggable dequeue policy and QoS
    class priority. Shed victims land in an internal list the OWNER
    (engine/frontend) drains via `drain_shed` and finishes as evicted —
    the scheduler never invents terminal results itself."""

    def __init__(self, max_queue: int = 64, policy: str = "fifo",
                 retry_after_s: float = 0.05):
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, "
                             f"got {policy!r}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = int(max_queue)
        self.policy = policy
        # the 429 hint under a full queue scales with how much of the
        # queue must drain before a retry can land — depth/max_queue
        # full queues hint one full unit, near-empty ones a fraction
        self.retry_after_base_s = float(retry_after_s)
        self._queue: List[Request] = []
        self._shed: List[Request] = []
        # submit may run on an ingest thread (`runtime.RequestFeeder`)
        # while the engine loop pops — one lock keeps the bound exact
        self._lock = threading.Lock()

    @property
    def depth(self) -> int:
        return len(self._queue)

    def _retry_after(self) -> float:
        return self.retry_after_base_s * max(
            1.0, len(self._queue) / self.max_queue)

    def submit(self, req: Request, now: Optional[float] = None) -> int:
        """Enqueue or raise `Backpressure`. On a full queue, first
        sheds a strictly-weaker-class queued request (weakest class
        first, youngest first — it has waited least and its tenant
        signed up for shedding); the victim lands in `drain_shed`.
        Returns the request id."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if req.deadline is not None and req.deadline <= now:
                raise Backpressure("deadline already passed at submit",
                                   queue_depth=len(self._queue),
                                   retry_after_s=0.0)
            if len(self._queue) >= self.max_queue:
                victim = self._pick_shed_victim_locked(req.rank)
                if victim is None:
                    raise Backpressure(
                        f"queue full ({self.max_queue}); retry later",
                        queue_depth=len(self._queue),
                        retry_after_s=self._retry_after())
                # identity removal: dataclass == would compare the
                # numpy token arrays elementwise
                self._queue = [r for r in self._queue
                               if r is not victim]
                self._shed.append(victim)
            req.submitted_at = now
            self._queue.append(req)
            return req.req_id

    def _pick_shed_victim_locked(self, incoming_rank: int
                                 ) -> Optional[Request]:
        """Weakest class strictly below ``incoming_rank``'s priority,
        youngest arrival within it. A guaranteed request therefore
        never sheds another guaranteed one, and nothing sheds an
        equal-or-stronger class."""
        victim = None
        for r in self._queue:
            if r.rank <= incoming_rank:
                continue
            if (victim is None or r.rank > victim.rank
                    or (r.rank == victim.rank
                        and r.submitted_at > victim.submitted_at)):
                victim = r
        return victim

    def drain_shed(self) -> List[Request]:
        """Remove and return requests shed by `submit` since the last
        drain — the owner finishes them (evicted, reason shed)."""
        with self._lock:
            out, self._shed = self._shed, []
            return out

    def cancel(self, req_id: int) -> bool:
        """Remove a QUEUED request. Returns False if not queued (it may
        already be running — the engine owns cancellation there)."""
        with self._lock:
            for i, r in enumerate(self._queue):
                if r.req_id == req_id:
                    del self._queue[i]
                    return True
            return False

    def expire(self, now: Optional[float] = None) -> List[Request]:
        """Drop and return queued requests whose deadline has passed,
        ordered class-strongest-first then earliest-deadline-first
        within a class (the eviction observation order — metrics read
        causality off it)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            dead = [r for r in self._queue
                    if r.deadline is not None and r.deadline <= now]
            if dead:
                gone = {r.req_id for r in dead}
                self._queue = [r for r in self._queue
                               if r.req_id not in gone]
                dead.sort(key=lambda r: (r.rank, r.deadline))
            return dead

    def pop(self, n: int, prefer=None) -> List[Request]:
        """Up to ``n`` requests to admit: strongest QoS class first,
        the fifo/sjf policy within a class. Deadline expiry is the
        ENGINE's job (call `expire` first) so evictions are observed
        in one place.

        ``prefer`` (optional ``Request -> bool``) is a WITHIN-CLASS
        tiebreak ranked between the class and the policy: preferred
        requests dequeue first inside their QoS class, and the class
        lattice is never crossed (a preferred sheddable request still
        waits behind every guaranteed one). The engine's prefix-aware
        admission passes its radix-hit probe here when the pool is
        near capacity — a hit turns a slot over sooner."""
        with self._lock:
            if n <= 0 or not self._queue:
                return []

            def boost(i):
                if prefer is None:
                    return 0
                return 0 if prefer(self._queue[i]) else 1

            if self.policy == "sjf":
                def key(i):
                    return (self._queue[i].rank, boost(i),
                            self._queue[i].tokens.size, i)
            else:
                def key(i):
                    return (self._queue[i].rank, boost(i), i)
            order = sorted(range(len(self._queue)), key=key)
            take = order[:n]
            out = [self._queue[i] for i in take]
            taken = set(take)
            self._queue = [r for i, r in enumerate(self._queue)
                           if i not in taken]
            return out

    def snapshot(self) -> Sequence[int]:
        return [r.req_id for r in self._queue]
