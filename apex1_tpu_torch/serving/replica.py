"""Supervised engine replica — the fault boundary of the serving tier
(the port of ``apex1_tpu/serving/replica.py``).

One `Engine` in one process loses every in-flight stream to a wedged
decode step, a poisoned request, or a killed process. The supervisor
wraps the engine in the training loop's discipline: observe progress,
declare death loudly, recover to a bit-exact state.

- **Heartbeat + watchdog**: every completed serve iteration stamps a
  heartbeat. A replica that CRASHES (raises) is dead immediately; one
  that stops making step progress past ``watchdog_s`` is declared dead
  by the watchdog (`check` in threaded mode; in pump mode an
  over-deadline iteration is flagged the moment it finally returns).
  A hung thread cannot be killed in Python — it is ABANDONED, and a
  generation token keeps its late writes from corrupting the restarted
  replica's state.
- **Restart + idempotent resubmission**: a dead replica is torn down
  and restarted with a FRESH engine (counted in ``engines_built``; the
  JAX package re-pins its two traced executables through
  ``Engine.trace_counts`` instead — PyTorch traces nothing, and the
  kernel library loads once a process, `ops._build.load_count`, however
  many engines are built); every in-flight submission is resubmitted
  keyed on its stable request id. Because the engine samples token i of
  a request as ``fold_in(key(seed), i)`` with the seed fixed at submit,
  the regenerated stream is TOKEN-IDENTICAL to the lost one at any
  temperature — the serving analogue of a bit-exact training resume.
- **Poison quarantine**: a request whose ADMISSION kills the replica
  (the chaos `PoisonPill` model: deterministic, at the submit
  boundary) is counted per request id; past ``poison_threshold``
  deaths it is quarantined with an ``evicted``/"poisoned" result
  instead of resubmitted — one bad request must not keep a replica in
  a crash loop forever. Step-time crashes are attributed to the
  REPLICA, not a request (attribution there would be guesswork), so
  innocents are never quarantined for a flaky engine.
- **Restart budget**: past ``max_restarts`` the supervisor enters
  ``failed`` and stops restarting; the frontend drains its in-flight
  submissions (`drain_inflight`) and re-routes them to surviving
  replicas — failover, same idempotency contract.

Two drive modes: ``start()`` spawns the serve thread (production /
bench shape); ``pump()`` runs serve iterations inline on the caller's
thread — single-threaded and fully deterministic, which is what lets
the tests assert "kill a replica mid-stream, every token bit-identical"
instead of hoping.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np

from apex1_tpu_torch.serving.engine import (Engine, RequestResult,
                                            derive_request_seed)
from apex1_tpu_torch.serving.metrics import ServingMetrics
from apex1_tpu_torch.serving.scheduler import Backpressure, new_request_id


class ReplicaKilled(RuntimeError):
    """A replica's serve loop was killed (chaos `ReplicaKill`, or any
    unexpected engine crash re-raised under supervision)."""


class PoisonedRequest(RuntimeError):
    """A request whose admission deterministically kills the replica
    (the chaos poison-pill model)."""

    def __init__(self, msg: str, req_id: Optional[int] = None):
        super().__init__(msg)
        self.req_id = req_id


@dataclasses.dataclass
class Submission:
    """The frozen resubmission record — everything needed to replay a
    request onto a fresh engine and get the identical stream: stable
    ``req_id`` (metrics identity), pinned ``seed`` (sampling
    identity), and the original shape/deadline/QoS contract."""

    tokens: np.ndarray
    max_new_tokens: int
    req_id: int
    seed: int
    prefix: Optional[tuple] = None
    deadline: Optional[float] = None
    qos: str = "best_effort"
    tenant: Optional[str] = None
    submitted_at: float = 0.0

    def kwargs(self) -> dict:
        return dict(max_new_tokens=self.max_new_tokens,
                    req_id=self.req_id, seed=self.seed,
                    prefix=self.prefix, deadline=self.deadline,
                    qos=self.qos, tenant=self.tenant)


@dataclasses.dataclass
class ReplicaConfig:
    """Supervision knobs.

    ``watchdog_s`` must exceed the replica's worst-case HEALTHY step.
    In pump mode the iteration that builds a fresh engine (and pays
    its first kernel build and allocations) is exempt; in threaded mode
    there is no such grace — size the deadline above the first step or
    pre-warm before `start`.
    """

    watchdog_s: float = 5.0       # no-progress deadline before declared
    max_restarts: int = 3         #  dead; restarts past this = failed
    poison_threshold: int = 1     # admission-kills tolerated per req_id
    idle_sleep_s: float = 0.001   #  before quarantine
    drain_join_s: float = 2.0     # stop(): max wait for the thread


class ReplicaSupervisor:
    """One supervised engine replica.

    ``make_engine() -> Engine`` is called per (re)start — a fresh
    engine per generation is the teardown contract (no state from the
    dead incarnation survives except the resubmission records).
    ``fault`` is a `testing.chaos.ServingFault` hook (None in
    production). ``metrics`` (shared `ServingMetrics`) receives
    restart counters + transitions.
    """

    def __init__(self, make_engine: Callable[[], Engine],
                 replica_id: int = 0, *,
                 config: Optional[ReplicaConfig] = None,
                 metrics: Optional[ServingMetrics] = None,
                 fault=None, seed: int = 0,
                 clock: Optional[Callable[[], float]] = None):
        self.make_engine = make_engine
        self.replica_id = int(replica_id)
        self.clock = clock or time.monotonic  # injectable so
        #  testing.fleetsim can drive pump-mode supervision on VIRTUAL
        #  time (deterministic replay); threaded mode needs a real
        #  clock — heartbeats race the wall there by design
        self.seed = int(seed)         # base for derived request seeds —
        #  the supervisor pins seeds BEFORE the engine sees a request
        #  (resubmission may land on a fresh engine), so the engine's
        #  own cfg.seed never participates through this path; give
        #  every interchangeable replica the same value (the frontend
        #  passes its FrontendConfig.seed)
        self.cfg = config or ReplicaConfig()
        self.metrics = metrics or ServingMetrics()
        self.fault = fault
        self.engine: Optional[Engine] = None
        self.state = "new"            # new|alive|dead|failed|stopped
        self.generation = 0
        self.restarts = 0
        self.steps = 0
        self.engines_built = 0
        self.step_ewma = 0.0          # smoothed iteration wall time —
        self.heartbeat = self.clock()      # the router's feasibility prior
        self.last_error: Optional[BaseException] = None
        self._inbox: deque = deque()  # ("submit", Submission)|("cancel", rid)
        self._inflight: Dict[int, Submission] = {}
        self._results: Dict[int, RequestResult] = {}
        self._kill_counts: Dict[int, int] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- the public surface (any thread) --------------------------------

    def submit(self, tokens, max_new_tokens: int, *,
               req_id: Optional[int] = None, seed: Optional[int] = None,
               prefix=None, deadline: Optional[float] = None,
               qos: str = "best_effort",
               tenant: Optional[str] = None) -> int:
        """Queue a request for this replica. The seed is pinned HERE
        (derived from the stable req_id when absent) so any later
        resubmission — this replica restarted, or failover to another —
        regenerates the identical stream."""
        rid = new_request_id() if req_id is None else int(req_id)
        if seed is None:
            seed = derive_request_seed(self.seed, rid)
        sub = Submission(
            tokens=np.asarray(tokens, np.int32).reshape(-1),
            max_new_tokens=int(max_new_tokens), req_id=rid,
            # int32 counter-key contract: fold oversized seeds here,
            # deterministically, instead of crashing the engine step
            seed=int(seed) & 0x7FFFFFFF, prefix=prefix,
            deadline=deadline, qos=qos,
            tenant=tenant, submitted_at=self.clock())
        self.submit_sub(sub)
        return rid

    def submit_sub(self, sub: Submission) -> None:
        with self._lock:
            self._inflight[sub.req_id] = sub
            self._inbox.append(("submit", sub))

    def cancel(self, req_id: int) -> None:
        """Cancel wherever the request is: still in the inbox (never
        reached the engine — finished as cancelled right here) or
        already submitted (engine cancellation command, processed next
        iteration; the engine releases the KV slot immediately)."""
        with self._lock:
            for i, (kind, payload) in enumerate(self._inbox):
                if kind == "submit" and payload.req_id == req_id:
                    del self._inbox[i]
                    self._inflight.pop(req_id, None)
                    self._results[req_id] = RequestResult(
                        req_id=req_id, status="cancelled",
                        tokens=np.zeros((0,), np.int32),
                        reason="cancelled before admission")
                    return
            self._inbox.append(("cancel", int(req_id)))

    def poll(self, req_id: int) -> Optional[RequestResult]:
        with self._lock:
            return self._results.get(req_id)

    def first_token_seen(self, req_id: int) -> bool:
        """Best-effort TTFT probe: has this replica's CURRENT engine
        sampled the request's first token? (Reads the engine's own
        metrics record; False while the request waits in the inbox or
        the engine queue, or after a death wiped the engine.) The
        frontend's hedge trigger keys on this — a streaming request is
        not 'blown', however long its full decode takes."""
        eng = self.engine
        if eng is None:
            return False
        rec = eng.metrics.records.get(req_id)
        return rec is not None and rec.t_first_token is not None

    def pending(self, req_id: int) -> bool:
        """True while this replica may still PUBLISH a result for the
        request: it is in flight here (inbox or engine) and the replica
        can still make progress. False = nothing will ever land, the
        caller may forget the route."""
        if self.state in ("failed", "stopped"):
            return False
        with self._lock:
            return req_id in self._inflight

    def pop_result(self, req_id: int) -> Optional[RequestResult]:
        with self._lock:
            return self._results.pop(req_id, None)

    @property
    def results(self) -> Dict[int, RequestResult]:
        with self._lock:
            return dict(self._results)

    @property
    def n_inflight(self) -> int:
        with self._lock:
            return len(self._inflight)

    @property
    def load(self) -> int:
        """Routing load: requests handed to this replica and not yet
        terminal (queued in the inbox, in the engine's queue, or
        decoding)."""
        return self.n_inflight

    def inflight_subs(self) -> List[Submission]:
        with self._lock:
            return sorted(self._inflight.values(),
                          key=lambda s: s.req_id)

    def drain_inflight(self) -> List[Submission]:
        """Remove and return every in-flight submission — the
        frontend's failover hook once this replica is ``failed``.

        An ACKNOWLEDGED cancel pending in the inbox must not be
        forwarded to the surviving replica: draining its request from
        ``_inflight`` would resurrect work the caller was told is
        cancelled (the hazard ``restart`` guards against too)."""
        with self._lock:
            cancelled = [p for k, p in self._inbox if k == "cancel"]
            for rid in cancelled:
                if self._inflight.pop(rid, None) is not None:
                    self._results[rid] = RequestResult(
                        req_id=rid, status="cancelled",
                        tokens=np.zeros((0,), np.int32),
                        reason="cancelled (pending at failover)")
            subs = sorted(self._inflight.values(), key=lambda s: s.req_id)
            self._inflight.clear()
            self._inbox.clear()
            return subs

    # ---- lifecycle ------------------------------------------------------

    def start(self) -> "ReplicaSupervisor":
        """Spawn the serve thread (production mode). `pump` is the
        inline alternative; don't mix the two for one generation."""
        self.state = "alive"
        self.heartbeat = self.clock()
        gen = self.generation
        self._thread = threading.Thread(
            target=self._serve, args=(gen,), daemon=True,
            name=f"replica-{self.replica_id}-gen{gen}")
        self._thread.start()
        return self

    def pump(self, iterations: int = 1) -> int:
        """Run up to ``iterations`` serve iterations INLINE — the
        deterministic drive mode the drills use. Returns iterations
        completed (0 when dead/failed/stopped). An iteration that
        crashes or overruns the watchdog marks the replica dead."""
        if self.state == "new":
            self.state = "alive"
        if self.state != "alive":
            return 0
        gen = self.generation
        done = 0
        for _ in range(iterations):
            fresh = self.engine is None   # this iteration pays the
            t0 = self.clock()             # engine build + first-call
            try:                          # kernel build
                self._ensure_engine()
                self._iterate(gen)
            except BaseException as e:
                self._mark_dead(e)
                return done
            took = self.clock() - t0
            if not fresh:
                self._observe_step(took)
            if not fresh and took > self.cfg.watchdog_s:
                # the iteration DID return, but past the deadline a
                # real watchdog would already have fired mid-flight —
                # same verdict, observed at the boundary (the pump-mode
                # hang model; threaded mode fires via check())
                self._mark_dead(ReplicaKilled(
                    f"watchdog: iteration took {took:.3f}s "
                    f"(> {self.cfg.watchdog_s}s)"))
                return done
            done += 1
        return done

    def check(self, now: Optional[float] = None) -> bool:
        """Watchdog probe (threaded mode): True while healthy. A
        heartbeat older than ``watchdog_s`` on a live replica declares
        it dead — the thread is abandoned (its generation token keeps
        late writes out) and the caller restarts."""
        if self.state != "alive":
            return self.state not in ("dead", "failed")
        if self._thread is None:      # pump mode: liveness is state
            return True
        now = self.clock() if now is None else now
        if now - self.heartbeat > self.cfg.watchdog_s:
            self._mark_dead(ReplicaKilled(
                f"watchdog: no heartbeat for {now - self.heartbeat:.3f}s"))
            return False
        return True

    def restart(self) -> bool:
        """Tear down the dead incarnation and bring up a fresh engine,
        resubmitting every in-flight request (idempotent: stable ids +
        pinned seeds). Returns False once the restart budget is spent
        (state ``failed`` — the frontend's cue to fail over)."""
        if self.state != "dead":
            raise RuntimeError(
                f"restart() on a {self.state} replica (only dead ones)")
        self.restarts += 1
        if self.restarts > self.cfg.max_restarts:
            self.state = "failed"
            self.metrics.transition(
                "replica_failed", replica=self.replica_id,
                restarts=self.restarts - 1,
                error=repr(self.last_error))
            return False
        threaded = self._thread is not None
        self.generation += 1
        self.engine = None            # fresh engine next iteration
        self._thread = None
        quarantined: List[RequestResult] = []
        with self._lock:
            # an ACKNOWLEDGED cancel pending in the inbox must survive
            # the restart — resubmitting its request from _inflight
            # would resurrect work the caller was told is cancelled
            cancelled = [p for k, p in self._inbox if k == "cancel"]
            for rid in cancelled:
                if self._inflight.pop(rid, None) is not None:
                    self._results[rid] = RequestResult(
                        req_id=rid, status="cancelled",
                        tokens=np.zeros((0,), np.int32),
                        reason="cancelled (pending at restart)")
            self._inbox.clear()       # stale commands die with the gen
            for sub in sorted(self._inflight.values(),
                              key=lambda s: s.req_id):
                kills = self._kill_counts.get(sub.req_id, 0)
                if kills > self.cfg.poison_threshold:
                    quarantined.append(RequestResult(
                        req_id=sub.req_id, status="evicted",
                        tokens=np.zeros((0,), np.int32),
                        reason=f"poisoned (killed replica {kills}x)"))
                    continue
                self._inbox.append(("submit", sub))
            for res in quarantined:
                self._inflight.pop(res.req_id, None)
                self._results[res.req_id] = res
        self.metrics.incr("replica_restarts")
        self.metrics.incr("retries", self.n_inflight)
        self.metrics.transition(
            "replica_restart", replica=self.replica_id,
            generation=self.generation, resubmitted=self.n_inflight,
            quarantined=[r.req_id for r in quarantined],
            error=repr(self.last_error))
        self.last_error = None
        self.state = "alive"
        self.heartbeat = self.clock()
        if threaded:
            gen = self.generation
            self._thread = threading.Thread(
                target=self._serve, args=(gen,), daemon=True,
                name=f"replica-{self.replica_id}-gen{gen}")
            self._thread.start()
        return True

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=self.cfg.drain_join_s)
        if self.state in ("alive", "new", "dead"):
            self.state = "stopped"

    @property
    def idle(self) -> bool:
        """No queued work and nothing decoding (alive replicas only)."""
        if self.engine is None:
            return self.n_inflight == 0
        with self._lock:
            inbox = len(self._inbox)
        return (inbox == 0 and self.engine.scheduler.depth == 0
                and self.engine.n_active == 0)

    # ---- the serve loop -------------------------------------------------

    def _ensure_engine(self):
        if self.engine is None:
            self.engine = self.make_engine()
            self.engines_built += 1
        return self.engine

    def _serve(self, gen: int):
        """Thread body: build the engine, iterate until stopped. Any
        exception marks the replica dead; a stale generation (the
        watchdog abandoned us while we slept in a wedged step) exits
        without touching shared state."""
        try:
            self._ensure_engine()
            while not self._stop.is_set():
                if gen != self.generation:
                    return            # abandoned: a new gen owns state
                t0 = self.clock()
                self._iterate(gen)
                if gen == self.generation:
                    self.heartbeat = self.clock()
                    self._observe_step(self.heartbeat - t0)
                if self.idle:
                    time.sleep(self.cfg.idle_sleep_s)
        except BaseException as e:
            if gen == self.generation:
                self._mark_dead(e)

    def _iterate(self, gen: int):
        """One serve iteration: drain the inbox into the engine, run
        one engine step, publish finished results, stamp progress."""
        engine = self.engine
        while True:
            with self._lock:
                if not self._inbox:
                    break
                kind, payload = self._inbox.popleft()
            if kind == "cancel":
                engine.cancel(payload)
                continue
            sub = payload
            try:
                if self.fault is not None:
                    self.fault.on_submit(self.replica_id, sub)
                engine.submit(sub.tokens, **sub.kwargs())
            except Backpressure:
                with self._lock:      # engine queue full: retry next
                    self._inbox.appendleft((kind, sub))  # iteration
                break
            except (PoisonedRequest, ReplicaKilled) as e:
                # admission killed the replica: attribute the death to
                # THIS request so restart() can quarantine a repeat
                # offender instead of crash-looping forever
                with self._lock:
                    self._kill_counts[sub.req_id] = \
                        self._kill_counts.get(sub.req_id, 0) + 1
                raise ReplicaKilled(
                    f"admission of request {sub.req_id} killed "
                    f"replica {self.replica_id}: {e}") from e
            except ValueError as e:
                # contract violation (can never fit): terminal per
                # request, not fatal per replica
                with self._lock:
                    self._inflight.pop(sub.req_id, None)
                    self._results[sub.req_id] = RequestResult(
                        req_id=sub.req_id, status="rejected",
                        tokens=np.zeros((0,), np.int32),
                        reason=f"contract: {e}")
        if self.fault is not None:
            self.fault.on_step(self.replica_id, self.steps)
        engine.step()
        for rid in list(engine.results.keys()):
            res = engine.pop_result(rid)
            with self._lock:
                if gen != self.generation:
                    return
                self._inflight.pop(rid, None)
                self._results[rid] = res
        self.steps += 1

    def _observe_step(self, took: float):
        self.step_ewma = (took if self.step_ewma == 0.0
                          else 0.8 * self.step_ewma + 0.2 * took)

    def _mark_dead(self, err: BaseException):
        if self.state == "alive":
            self.state = "dead"
            self.last_error = err
            self.metrics.transition(
                "replica_dead", replica=self.replica_id,
                generation=self.generation, error=repr(err),
                inflight=self.n_inflight)

    # ---- introspection --------------------------------------------------

    def build_counts(self) -> dict:
        """What this replica has built: engines (one a generation) and
        the process's kernel-library loads (`ops._build.load_count`: a
        restart must not load it again). The JAX package's counterpart
        is ``trace_counts`` (its engines' traced executables)."""
        from apex1_tpu_torch.ops import _build
        return {"engines_built": self.engines_built,
                "library_loads": _build.load_count()}
