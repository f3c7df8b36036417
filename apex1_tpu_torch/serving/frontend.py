"""Fault-tolerant multi-replica serving front — N supervised engine
replicas behind ONE submit/poll surface (the port of
``apex1_tpu/serving/frontend.py``).

- **Routing**: least-loaded replica, gated by a deadline FEASIBILITY
  check (load x smoothed step time vs time-to-deadline — an estimate,
  never a guarantee; an infeasible deadline is rejected at the door
  with ``retry_after_s=0`` rather than admitted to fail).
- **QoS admission**: per-tenant classes (`scheduler.QOS_CLASSES`).
  At frontend capacity, a guaranteed request displaces the youngest
  sheddable in-flight request (cancelled — the engine releases its KV
  slot immediately — and finished as evicted/"shed"); anything else
  gets a structured `Backpressure` (queue depth + retry-after floor).
- **Failover**: a dead replica is restarted with in-flight
  resubmission by its supervisor; once its restart budget is spent
  (``failed``) the frontend drains its in-flight submissions and
  re-routes them to surviving replicas. Stable ids + pinned seeds make
  both paths regenerate token-identical streams.
- **Hedged dispatch**: a guaranteed-class request with no result past
  its TTFT budget is duplicated to a second replica; first terminal
  result wins, the loser is cancelled. Hedging bounds TAIL latency
  against a slow/wedged replica — it does NOT add capacity (it spends
  it), and both executions produce the same tokens by construction, so
  the race has one observable winner and zero observable variance.
- **Degraded modes**: sustained overload walks ``normal → shedding →
  degraded`` (and back). Shedding cancels sheddable-class load first;
  degraded additionally caps new admissions' ``max_new_tokens`` to the
  `DegradeProfile` and (when the engine factory accepts
  ``cache_dtype``) restarts future replicas on the quantized-KV
  profile — pressure relief instead of hard failure. EVERY transition
  is banked as a JSON event through `ServingMetrics.transition`.

Drive modes mirror `ReplicaSupervisor`: `start()` + threaded
replicas for production/bench, `pump()` inline for deterministic
drills. `pump` is also the supervision tick in threaded mode
(watchdogs, restarts, hedges, mode transitions, result collection).

**Actuation surface**: the knobs a controller (the JAX package's
autopilot) turns at runtime, every call banked as a
transition with its caller (`by=`) and evidence attached:

- `add_replica()` / `retire_replica()` — elastic fleet size. A
  retiring replica takes no new routes, drains its in-flight work,
  then stops; its slot in ``replicas`` stays (ids are route indices).
- `set_mode()` — external overload-ladder control. With
  ``FrontendConfig.mode_control="external"`` the built-in
  load-fraction ladder is off and transitions are driven by whatever
  signal the controller watches (per-class latency percentiles, not
  raw queue depth).
- `set_admission_limit()` — admission setpoint: caps `capacity`
  below the structural ``n_alive * capacity_per_replica``.
- `set_hedge_budget()` — per-tenant TTFT/hedge budgets fit from
  measured distributions (falls back to ``cfg.hedge_after_s``).

The frontend also RECORDS every accepted request's lifecycle
(queued → first_token → terminal) into its own shared
`ServingMetrics`, so `summary()["window"]` carries the rolling
per-class percentiles the controller consumes — engine-level metrics
stay per-replica and are not aggregated here. ``clock`` is injectable
(`testing.fleetsim` passes virtual time for deterministic replay).
"""

from __future__ import annotations

import dataclasses
import inspect
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from apex1_tpu_torch.serving.engine import (Engine, RequestResult,
                                            derive_request_seed)
from apex1_tpu_torch.serving.metrics import TERMINAL, ServingMetrics
from apex1_tpu_torch.serving.replica import (ReplicaConfig,
                                             ReplicaSupervisor, Submission)
from apex1_tpu_torch.serving.scheduler import (Backpressure,
                                               new_request_id, qos_rank)

#: overload modes, escalation order
MODES = ("normal", "shedding", "degraded")


@dataclasses.dataclass
class DegradeProfile:
    """The pressure-relief admission profile: what the frontend trades
    away under sustained overload instead of hard-failing."""

    max_new_tokens_cap: int = 32
    cache_dtype: Optional[object] = None   # e.g. torch.int8 — applied
    #  to replicas (re)built while degraded, when make_engine accepts
    #  cache_dtype (the pool's dtype knob); None = length-cap only


@dataclasses.dataclass
class FrontendConfig:
    """Router + admission knobs. Load fractions are measured against
    ``n_alive_replicas * capacity_per_replica`` (in-flight requests a
    replica absorbs: engine slots + queue)."""

    n_replicas: int = 2
    capacity_per_replica: int = 16
    seed: int = 0                  # base for derived per-request seeds
    hedge_after_s: float = 0.25    # guaranteed-class TTFT budget before
    #                                a hedge fires (None disables)
    enter_shed: float = 0.75       # load fraction -> shedding
    enter_degraded: float = 0.95   # load fraction -> degraded
    exit_overload: float = 0.5     # load fraction to step back down
    sustain_rounds: int = 3        # consecutive pump rounds to flip
    degrade: DegradeProfile = dataclasses.field(
        default_factory=DegradeProfile)
    replica: ReplicaConfig = dataclasses.field(
        default_factory=ReplicaConfig)
    retry_after_s: float = 0.05    # frontend 429 backoff floor base
    mode_control: str = "load"     # "load" = the built-in load-fraction
    #  ladder walks modes; "external" = ONLY set_mode() flips them (an
    #  attached autopilot drives transitions from latency percentiles)
    metrics_window: int = 128      # rolling-percentile ring size for a
    #                                frontend-constructed ServingMetrics
    cache_dtype: Optional[object] = None  # STEADY-STATE KV tier for
    #  every replica build (e.g. torch.int8 — half the bytes/slot buys
    #  ~2x resident batch for the same HBM). Distinct from
    #  DegradeProfile.cache_dtype, which
    #  only kicks in for replicas (re)built while degraded and takes
    #  precedence there. Requires a make_engine that accepts
    #  ``cache_dtype``; silently unused otherwise (same rule as the
    #  degrade profile).


class ServingFrontend:
    """N supervised replicas behind one submit/poll surface.

    ``make_engine() -> Engine`` builds ONE replica's engine (fresh per
    restart). Give every replica the same params/config — routing and
    failover assume replicas are interchangeable. If the factory
    accepts a ``cache_dtype`` kwarg, degraded-mode restarts pass the
    profile's quantized-KV dtype through it.
    """

    def __init__(self, make_engine: Callable[..., Engine],
                 config: Optional[FrontendConfig] = None, *,
                 metrics: Optional[ServingMetrics] = None,
                 fault=None,
                 clock: Optional[Callable[[], float]] = None):
        self.cfg = cfg = config or FrontendConfig()
        if cfg.n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        if cfg.mode_control not in ("load", "external"):
            raise ValueError(
                f"mode_control must be 'load' or 'external', "
                f"got {cfg.mode_control!r}")
        # instance state seeded from the config: attaching an Autopilot
        # flips THIS frontend to external control without mutating a
        # (possibly shared) FrontendConfig object
        self.mode_control = cfg.mode_control
        self.clock = clock or time.monotonic
        self.metrics = metrics or ServingMetrics(
            window=cfg.metrics_window, clock=self.clock)
        self._make_engine = make_engine
        self._fault = fault
        self._takes_cache_dtype = "cache_dtype" in \
            inspect.signature(make_engine).parameters
        self.mode = "normal"
        self._above = 0                      # sustained-overload counters
        self._below = 0
        self.replicas: List[ReplicaSupervisor] = []
        self._rep_counters: Dict[int, Dict[str, int]] = {}
        for _ in range(cfg.n_replicas):
            self._new_replica()
        self._subs: Dict[int, Submission] = {}      # all accepted, by id
        self._live: set = set()                     # accepted, not terminal
        self._route: Dict[int, List[int]] = {}      # rid -> replica ids
        self._shed_rids: set = set()                # relabel cancelled->shed
        self._hedged: set = set()
        self._ttft_marked: set = set()              # first_token recorded
        self._retiring: set = set()                 # replica ids draining
        self._admission_limit: Optional[int] = None
        self._hedge_budgets: Dict[Optional[str], Optional[float]] = {}
        self._terminal: Dict[int, RequestResult] = {}
        self._threaded = False

    def _new_replica(self) -> ReplicaSupervisor:
        rep = ReplicaSupervisor(
            self._build_engine, len(self.replicas),
            config=self.cfg.replica, metrics=self.metrics,
            fault=self._fault, seed=self.cfg.seed, clock=self.clock)
        self.replicas.append(rep)
        self._rep_counters[rep.replica_id] = {"hedges": 0, "sheds": 0}
        return rep

    # ---- lifecycle ------------------------------------------------------

    def start(self) -> "ServingFrontend":
        """Spawn every replica's serve thread (production mode); keep
        calling `pump()` as the supervision tick."""
        self._threaded = True
        for rep in self.replicas:
            rep.start()
        return self

    def stop(self) -> None:
        for rep in self.replicas:
            rep.stop()

    # ---- submission -----------------------------------------------------

    def submit(self, tokens, max_new_tokens: int, *,
               qos: str = "best_effort", tenant: Optional[str] = None,
               deadline: Optional[float] = None, prefix=None,
               seed: Optional[int] = None,
               req_id: Optional[int] = None) -> int:
        """Admit + route one request; returns its id (poll with it).
        Raises `Backpressure` (structured) when admission control says
        no: frontend at capacity with nothing sheddable, sheddable
        class refused while shedding/degraded, or no replica can
        feasibly meet the deadline."""
        qos_rank(qos)                        # validate loudly
        now = self.clock()
        rid = new_request_id() if req_id is None else int(req_id)
        if seed is None:
            # pinned HERE, not per engine: failover must regenerate the
            # identical stream on ANY replica
            seed = derive_request_seed(self.cfg.seed, rid)
        seed = int(seed) & 0x7FFFFFFF    # int32 counter-key contract
        if self.mode in ("shedding", "degraded") and qos == "sheddable":
            raise self._reject(
                rid, now, qos, tenant,
                f"{self.mode}: sheddable admissions refused",
                retry_after_s=self._retry_after())
        if self.mode == "degraded":
            capped = min(int(max_new_tokens),
                         self.cfg.degrade.max_new_tokens_cap)
            if capped < int(max_new_tokens):
                self.metrics.incr("degraded_admissions")
            max_new_tokens = capped
        # feasibility BEFORE displacement: an admission that is going
        # to be rejected as infeasible must not first evict an
        # innocent sheddable victim for nothing
        rep = self._pick_replica(max_new_tokens, deadline, now)
        if rep is None:
            raise self._reject(
                rid, now, qos, tenant,
                "no replica can feasibly meet the deadline",
                retry_after_s=0.0)
        if self.total_inflight >= self.capacity:
            if qos == "guaranteed" and self._displace_sheddable():
                pass                         # freed a unit of capacity
            else:
                raise self._reject(
                    rid, now, qos, tenant,
                    f"frontend at capacity ({self.capacity})",
                    retry_after_s=self._retry_after())
        sub = Submission(
            tokens=np.asarray(tokens, np.int32).reshape(-1),
            max_new_tokens=int(max_new_tokens), req_id=rid,
            seed=int(seed), prefix=prefix, deadline=deadline, qos=qos,
            tenant=tenant, submitted_at=now)
        self._subs[rid] = sub
        self._live.add(rid)
        self._route[rid] = [rep.replica_id]
        # the frontend-level lifecycle record: per-class/tenant rolling
        # percentiles (summary()["window"]) are fed from THESE events,
        # which survive replica restarts and failover — engine-level
        # records die with their engine
        self.metrics.event(rid, "queued", now=now,
                           n_prompt=int(sub.tokens.size), qos=qos,
                           tenant=tenant)
        rep.submit_sub(sub)
        return rid

    def cancel(self, req_id: int) -> bool:
        if req_id in self._terminal:
            return False
        routed = self._route.get(req_id)
        if not routed:
            return False
        for r in routed:
            self.replicas[r].cancel(req_id)
        return True

    # ---- results --------------------------------------------------------

    def poll(self, req_id: int) -> Optional[RequestResult]:
        """Terminal result, or None while in flight. (Collection
        happens in `pump`; poll only reads.)"""
        return self._terminal.get(req_id)

    def pop_result(self, req_id: int) -> Optional[RequestResult]:
        """Remove and return a terminal result, dropping every trace of
        the request — the long-running server's pressure valve (pair
        with `metrics.drain()`); `_terminal`/`_subs` are otherwise
        bounded only by requests ever served."""
        res = self._terminal.pop(req_id, None)
        if res is not None:
            self._subs.pop(req_id, None)
            self._shed_rids.discard(req_id)
            self._hedged.discard(req_id)
            self._route.pop(req_id, None)
        return res

    @property
    def results(self) -> Dict[int, RequestResult]:
        return dict(self._terminal)

    # ---- the supervision tick -------------------------------------------

    def pump(self, rounds: int = 1) -> None:
        """One supervision round x ``rounds``: drive replicas (inline
        mode), fire watchdogs, restart/fail-over dead replicas, collect
        results, hedge blown TTFT budgets, walk the overload ladder."""
        for _ in range(rounds):
            for rep in self.replicas:
                if self._threaded:
                    rep.check()
                elif rep.state in ("new", "alive"):
                    rep.pump(1)
            self._recover_dead()
            # TTFT before collection: a request whose first token and
            # terminal result land in the same round must still get its
            # first_token stamp (collection pops it from _live)
            self._observe_first_tokens()
            self._collect()
            self._complete_retirements()
            self._hedge_blown_budgets()
            self._update_mode()
            if self._threaded:
                time.sleep(0.001)            # supervision cadence, not
        #                                      the serve loop's

    def run_until_drained(self, *, timeout_s: float = 60.0,
                          max_rounds: int = 100_000
                          ) -> Dict[int, RequestResult]:
        """Pump until every accepted request is terminal (drills /
        benches). Raises on timeout — a drained=False return would just
        get asserted anyway."""
        t0 = time.monotonic()
        for _ in range(max_rounds):
            if not self._live:
                return self.results
            if time.monotonic() - t0 > timeout_s:
                break
            self.pump()
        if self._live:
            raise TimeoutError(
                f"undrained after {time.monotonic() - t0:.1f}s "
                f"(budget {timeout_s}s/{max_rounds} rounds): "
                f"{sorted(self._live)} "
                f"(states: {[r.state for r in self.replicas]})")
        return self.results

    # ---- internals ------------------------------------------------------

    @property
    def n_alive(self) -> int:
        """Routable replicas: alive and not draining toward
        retirement."""
        return sum(r.state in ("new", "alive")
                   and r.replica_id not in self._retiring
                   for r in self.replicas)

    @property
    def capacity(self) -> int:
        cap = max(1, self.n_alive) * self.cfg.capacity_per_replica
        if self._admission_limit is not None:
            cap = min(cap, self._admission_limit)
        return cap

    @property
    def total_inflight(self) -> int:
        return len(self._live)

    @property
    def load_fraction(self) -> float:
        return self.total_inflight / self.capacity

    @property
    def admission_limit(self) -> Optional[int]:
        return self._admission_limit

    def _retry_after(self) -> float:
        return self.cfg.retry_after_s * max(1.0, self.load_fraction)

    def _reject(self, rid: int, now: float, qos: str,
                tenant: Optional[str], reason: str, *,
                retry_after_s: float) -> Backpressure:
        """Build the structured 429 AND record the refusal in the
        lifecycle stream: a rejected guaranteed request is an SLO miss
        the latency percentiles can never see (they survive only on
        accepted traffic) — the rolling window's per-class done-rate
        is the control signal that sees it (`policy.SLOTarget
        .success_rate`)."""
        self.metrics.event(rid, "queued", now=now, n_prompt=0,
                           qos=qos, tenant=tenant)
        self.metrics.event(rid, "rejected", now=now, reason=reason)
        return Backpressure(reason, queue_depth=self.total_inflight,
                            retry_after_s=retry_after_s)

    def _build_engine(self) -> Engine:
        prof = self.cfg.degrade
        dtype = self.cfg.cache_dtype        # the steady-state tier;
        if self.mode == "degraded" and prof.cache_dtype is not None:
            dtype = prof.cache_dtype        # degraded relief wins
        if dtype is not None and self._takes_cache_dtype:
            return self._make_engine(cache_dtype=dtype)
        return self._make_engine()

    def _alive(self) -> List[ReplicaSupervisor]:
        """Replicas new/routable work may target — a retiring replica
        finishes what it has but takes no new routes."""
        return [r for r in self.replicas if r.state in ("new", "alive")
                and r.replica_id not in self._retiring]

    def _pick_replica(self, max_new_tokens: int,
                      deadline: Optional[float], now: float
                      ) -> Optional[ReplicaSupervisor]:
        """Least-loaded alive replica passing the deadline-feasibility
        estimate; least-loaded overall when the deadline is None or no
        replica has timing history yet."""
        alive = self._alive()
        if not alive:
            return None
        ranked = sorted(alive, key=lambda r: (r.load, r.replica_id))
        if deadline is None:
            return ranked[0]
        left = deadline - now
        for rep in ranked:
            est = (rep.load + 1) * max_new_tokens * rep.step_ewma
            if rep.step_ewma == 0.0 or est <= left:
                return rep
        return None

    def _displace_sheddable(self) -> bool:
        """Shed the YOUNGEST in-flight sheddable request to admit a
        guaranteed one — the QoS contract's teeth: sheddable capacity
        is borrowed, guaranteed capacity is owed. A victim already
        being shed (cancelled, result not yet collected) is skipped —
        it must not 'free' the same unit of capacity twice under a
        guaranteed burst."""
        victim = None
        for rid in self._live:
            sub = self._subs[rid]
            if sub.qos != "sheddable" or rid in self._shed_rids:
                continue
            if victim is None or sub.submitted_at > victim.submitted_at:
                victim = sub
        if victim is None:
            return False
        self._shed(victim, "shed (displaced by guaranteed)")
        return True

    def _shed(self, sub: Submission, reason: str):
        self._shed_rids.add(sub.req_id)
        self.metrics.incr("sheds")
        routed = self._route.get(sub.req_id, [])
        if routed:
            self._rep_counters[routed[0]]["sheds"] += 1
        self.metrics.transition("shed", req=sub.req_id, qos=sub.qos,
                                reason=reason)
        for r in routed:
            self.replicas[r].cancel(sub.req_id)

    def _recover_dead(self):
        for rep in self.replicas:
            if rep.state != "dead":
                continue
            if rep.replica_id in self._retiring:
                # a replica that dies while draining is not restarted —
                # it was leaving anyway; its in-flight work fails over
                self._failover(rep)
                rep.state = "stopped"
                rep.engine = None        # release the KV cache: only
                #  restart() clears the engine, and this replica never
                #  restarts
                self._retiring.discard(rep.replica_id)
                self.metrics.transition(
                    "replica_retired", replica=rep.replica_id,
                    note="died while draining")
                continue
            if not rep.restart():
                # budget spent: fail over its in-flight work
                self._failover(rep)

    def _failover(self, rep: ReplicaSupervisor):
        subs = rep.drain_inflight()
        targets = self._alive()
        for sub in subs:
            # a hedge leg may already be running elsewhere —
            # re-routing would double-decode the same id on
            # one engine; dropping the failed leg suffices
            others = [r for r in self._route.get(sub.req_id, [])
                      if r != rep.replica_id
                      and self.replicas[r].state
                      in ("new", "alive")]
            if others:
                continue
            if not targets:
                self._finish_here(sub.req_id, RequestResult(
                    req_id=sub.req_id, status="evicted",
                    tokens=np.zeros((0,), np.int32),
                    reason="no surviving replicas"))
                continue
            tgt = min(targets,
                      key=lambda r: (r.load, r.replica_id))
            self._route.setdefault(sub.req_id, []).append(
                tgt.replica_id)
            tgt.submit_sub(sub)
            self.metrics.incr("retries")
        self.metrics.transition(
            "failover", source=rep.replica_id,
            rerouted=[s.req_id for s in subs])

    def _finish_here(self, rid: int, res: RequestResult):
        """Make a request terminal at the frontend and close its
        lifecycle record (latency/TTFT land in the rolling window)."""
        self._terminal[rid] = res
        self._live.discard(rid)
        self._ttft_marked.discard(rid)
        status = res.status if res.status in TERMINAL else "done"
        self.metrics.event(rid, status, reason=res.reason,
                           n_generated=int(res.tokens.size))

    def _collect(self):
        # sweep settled hedge/cancel races: a loser leg publishes its
        # cancelled result an iteration AFTER the winner was collected —
        # keep draining until every leg has either yielded its result
        # or provably never will (nothing pending in that supervisor),
        # THEN drop the route entry; deleting earlier would strand the
        # late result in the supervisor's dict forever
        for rid in [r for r in self._route if r in self._terminal]:
            if all(self.replicas[r].pop_result(rid) is not None
                   or not self.replicas[r].pending(rid)
                   for r in self._route[rid]):
                del self._route[rid]
        for rid in list(self._live):
            for r in self._route.get(rid, []):
                res = self.replicas[r].pop_result(rid)
                if res is None:
                    continue
                if rid in self._shed_rids and res.status == "cancelled":
                    res = dataclasses.replace(
                        res, status="evicted", reason="shed (overload)")
                self._finish_here(rid, res)
                # hedge race settled: cancel the other leg(s)
                for other in self._route.get(rid, []):
                    if other != r:
                        self.replicas[other].cancel(rid)
                        self.replicas[other].pop_result(rid)
                if rid in self._hedged and r != self._route[rid][0]:
                    self.metrics.incr("hedges_won")
                break

    def _observe_first_tokens(self):
        """Stamp each live request's first_token lifecycle event the
        first supervision round any routed replica reports it (the
        `first_token_seen` probe) — pump-granular, which is exactly the
        resolution the control loop samples at anyway."""
        for rid in list(self._live):
            if rid in self._ttft_marked:
                continue
            if any(self.replicas[r].first_token_seen(rid)
                   for r in self._route.get(rid, [])):
                self._ttft_marked.add(rid)
                self.metrics.event(rid, "first_token")

    def _complete_retirements(self):
        """Stop a retiring replica once it has drained (dead retiring
        replicas are handled by `_recover_dead`)."""
        for rep_id in sorted(self._retiring):
            rep = self.replicas[rep_id]
            if rep.state in ("new", "alive") and rep.n_inflight == 0:
                rep.stop()
                rep.engine = None        # a stopped replica never
                #  restarts — drop the engine (and its KV cache) or
                #  every scale-up/scale-down cycle leaks one
                self._retiring.discard(rep_id)
                self.metrics.transition("replica_retired",
                                        replica=rep_id)

    def _hedge_budget_for(self, tenant: Optional[str]
                          ) -> Optional[float]:
        """Per-tenant fitted budget > fitted default (None key) >
        the static config; None = hedging disabled for that tenant."""
        if tenant in self._hedge_budgets:
            return self._hedge_budgets[tenant]
        if None in self._hedge_budgets:
            return self._hedge_budgets[None]
        return self.cfg.hedge_after_s

    def _hedge_blown_budgets(self):
        if self.cfg.hedge_after_s is None and not self._hedge_budgets:
            return
        now = self.clock()
        for rid in list(self._live):
            sub = self._subs[rid]
            if sub.qos != "guaranteed" or rid in self._hedged:
                continue
            budget = self._hedge_budget_for(sub.tenant)
            if budget is None or now - sub.submitted_at <= budget:
                continue
            routed = set(self._route[rid])
            # the budget is a TTFT budget: a primary that has already
            # streamed the first token is slow-but-healthy, and a
            # duplicate full decode would burn the very capacity
            # hedging protects — hedge only while NO leg has produced
            # a first token
            if any(self.replicas[r].first_token_seen(rid)
                   for r in routed):
                continue
            # exclude EVERY replica already on the route (a failover
            # may have appended the survivor) — hedging onto a replica
            # that already serves the request would double-decode it
            #
            primary = self._route[rid][0]
            others = [r for r in self._alive()
                      if r.replica_id not in routed]
            if not others:
                continue
            tgt = min(others, key=lambda r: (r.load, r.replica_id))
            self._hedged.add(rid)
            self._route[rid].append(tgt.replica_id)
            tgt.submit_sub(sub)
            self.metrics.incr("hedges_fired")
            self._rep_counters[tgt.replica_id]["hedges"] += 1
            self.metrics.transition("hedge", req=rid, primary=primary,
                                    secondary=tgt.replica_id)

    def _update_mode(self):
        """The BUILT-IN overload ladder (``mode_control="load"``).
        Escalation requires the load fraction to hold above the
        threshold for ``sustain_rounds`` consecutive pump rounds (a
        burst is not an overload); de-escalation is symmetric. Every
        flip is banked. With ``mode_control="external"`` this is a
        no-op — `set_mode` (the autopilot's actuator) owns the
        ladder."""
        if self.mode_control != "load":
            return
        frac = self.load_fraction
        cfg = self.cfg
        enter = (cfg.enter_shed if self.mode == "normal"
                 else cfg.enter_degraded)
        if self.mode != "degraded" and frac >= enter:
            self._above += 1
        else:
            self._above = 0
        if self.mode != "normal" and frac <= cfg.exit_overload:
            self._below += 1
        else:
            self._below = 0
        if self._above >= cfg.sustain_rounds:
            nxt = MODES[MODES.index(self.mode) + 1]
            self._flip_mode(nxt, frac)
            self._above = 0
            if nxt == "shedding":
                self._shed_all_sheddable()
        elif self._below >= cfg.sustain_rounds:
            self._flip_mode("normal", frac)
            self._below = 0

    def _shed_all_sheddable(self):
        """First relief valve on entering shedding: sheddable-class
        load goes first."""
        for rid in list(self._live):
            sub = self._subs[rid]
            if sub.qos == "sheddable" and rid not in self._shed_rids:
                self._shed(sub, "shed (overload)")

    def _flip_mode(self, new_mode: str, frac: float, **extra):
        old, self.mode = self.mode, new_mode
        fields = dict(frm=old, to=new_mode, load_fraction=round(frac, 4),
                      inflight=self.total_inflight,
                      capacity=self.capacity, **extra)
        if new_mode == "degraded":
            fields["max_new_tokens_cap"] = \
                self.cfg.degrade.max_new_tokens_cap
            fields["cache_dtype"] = str(self.cfg.degrade.cache_dtype)
        self.metrics.transition("mode", **fields)

    # ---- the actuation surface ------------------------------------------

    def set_mode(self, mode: str, *, by: str = "operator", **evidence):
        """Flip the overload mode directly (the external-control
        actuator; also works alongside the load ladder — the ladder
        just keeps walking from the new rung). Entering
        shedding-or-worse from normal sheds sheddable load, same as
        the ladder. Banked with the caller and its evidence."""
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
        if mode == self.mode:
            return
        was = self.mode
        self._flip_mode(mode, self.load_fraction, by=by, **evidence)
        self._above = self._below = 0
        if MODES.index(mode) >= 1 and MODES.index(was) < 1:
            self._shed_all_sheddable()

    def add_replica(self, *, by: str = "operator", **evidence) -> int:
        """Grow the fleet by one supervised replica (started when the
        frontend is threaded). Returns the new replica id. A replica
        built while degraded rides the degrade profile's cache dtype,
        same as a degraded restart."""
        rep = self._new_replica()
        if self._threaded:
            rep.start()
        self.metrics.transition("replica_added", replica=rep.replica_id,
                                n_replicas=len(self.replicas),
                                n_alive=self.n_alive, by=by, **evidence)
        return rep.replica_id

    def retire_replica(self, replica_id: Optional[int] = None, *,
                       by: str = "operator",
                       **evidence) -> Optional[int]:
        """Begin draining one replica toward retirement (the
        least-loaded alive one when unspecified): it takes no new
        routes, finishes its in-flight work, then stops. Returns the
        retiring id, or None when nothing is retirable (never drains
        the last routable replica). The supervisor object stays in
        ``replicas`` — ids are route indices."""
        if replica_id is None:
            cands = self._alive()
            if len(cands) <= 1:
                return None
            # least-loaded; ties go to the newest (scale-down unwinds
            # scale-up)
            rep = min(cands, key=lambda r: (r.load, -r.replica_id))
        else:
            # an unknown id (stale replay of a banked transition) is
            # "nothing retirable", not a crash; ids are route indices,
            # so a negative index must not alias from the end
            if not 0 <= int(replica_id) < len(self.replicas):
                return None
            rep = self.replicas[replica_id]
            if (rep.state not in ("new", "alive")
                    or rep.replica_id in self._retiring
                    or len(self._alive()) <= 1):
                return None
        self._retiring.add(rep.replica_id)
        self.metrics.transition("replica_retiring",
                                replica=rep.replica_id,
                                inflight=rep.n_inflight,
                                n_alive=self.n_alive, by=by, **evidence)
        return rep.replica_id

    def set_admission_limit(self, limit: Optional[int], *,
                            by: str = "operator", **evidence):
        """Admission setpoint: cap `capacity` below the structural
        ``n_alive * capacity_per_replica``. None clears it."""
        self._admission_limit = (None if limit is None
                                 else max(1, int(limit)))
        self.metrics.transition("admission_limit",
                                limit=self._admission_limit,
                                by=by, **evidence)

    def set_hedge_budget(self, budget_s: Optional[float],
                         tenant: Optional[str] = None, *,
                         by: str = "operator", **evidence):
        """Install a fitted TTFT/hedge budget (None disables hedging)
        for one tenant, or the fitted default when ``tenant`` is None.
        Unfitted tenants keep ``cfg.hedge_after_s``."""
        self._hedge_budgets[tenant] = (None if budget_s is None
                                       else float(budget_s))
        self.metrics.transition("hedge_budget", tenant=tenant,
                                budget_s=self._hedge_budgets[tenant],
                                by=by, **evidence)

    # ---- introspection --------------------------------------------------

    def replica_states(self) -> List[str]:
        return [r.state for r in self.replicas]

    def summary(self) -> dict:
        """ONE structured snapshot: the whole-run + rolling-window
        metrics, the mode-transition history, and per-replica
        supervision/restart/hedge/shed counters — a controller's
        input and the drills' assertion surface."""
        s = self.metrics.summary()
        s["mode"] = self.mode
        s["mode_history"] = [t for t in self.metrics.transitions
                             if t["event"] == "mode"]
        s["n_replicas"] = len(self.replicas)
        s["n_alive"] = self.n_alive
        s["capacity"] = self.capacity
        s["inflight"] = self.total_inflight
        s["load_fraction"] = round(self.load_fraction, 4)
        s["admission_limit"] = self._admission_limit
        s["hedge_budgets"] = {("default" if t is None else t): b
                              for t, b in self._hedge_budgets.items()}
        s["replicas"] = {
            r.replica_id: {"state": r.state, "restarts": r.restarts,
                           "generation": r.generation,
                           "engines_built": r.engines_built,
                           "steps": r.steps, "load": r.load,
                           "retiring": r.replica_id in self._retiring,
                           **self._rep_counters[r.replica_id]}
            for r in self.replicas}
        # goodput-multiplier rates, aggregated across the CURRENT
        # replica engines (engine metrics die with their engine — these
        # are live-fleet rates, not all-time; fields-only-when-data,
        # same contract as the percentiles)
        agg = {k: 0 for k in ("prefix_lookups", "prefix_hits",
                              "prefix_saved_tokens", "spec_drafted",
                              "spec_accepted")}
        for r in self.replicas:
            eng = r.engine
            if eng is None:
                continue
            for k in agg:
                agg[k] += eng.metrics.get_counter(k)
        if agg["prefix_lookups"]:
            s["prefix_hit_rate"] = (agg["prefix_hits"]
                                    / agg["prefix_lookups"])
            s["prefix_saved_tokens"] = agg["prefix_saved_tokens"]
        if agg["spec_drafted"]:
            s["accept_rate"] = agg["spec_accepted"] / agg["spec_drafted"]
        return s
