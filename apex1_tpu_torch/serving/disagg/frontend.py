"""Disaggregated prefill/decode serving — two `ServingFrontend` pools
behind one submit/poll surface (the port of
``apex1_tpu/serving/disagg/frontend.py``).

Why split: long-prompt prefills head-of-line-block decode steady state
when every replica serves both phases — one 8-chunk prefill stalls
every resident decode stream on that replica for 8 rounds. The split
gives each phase its own pool:

- **Phase-aware routing**: an admission goes to the PREFILL pool
  unless (a) the decode pool's pool-local radix index already holds
  the prompt's full chunk-aligned share point (a full-prompt hit — the
  prefill pool is skipped entirely), or (b) the prompt is too short to
  ever produce a transferable page (share point < one chunk), in which
  case its prefill is a single chunk and rides the decode admission
  round harmlessly.
- **KV handoff**: the prefill leg runs the prompt as a
  ``max_new_tokens=1`` request — it samples token 0 and retires at
  prefill, leaving the chunk-aligned prefix page in its engine's
  store. The page moves to the decode pool through
  `kv_transfer` (departure digest → transfer → ARRIVAL re-digest →
  install), then the request is resubmitted to the decode pool with
  its ORIGINAL budget, same id, same pinned seed: the decode engine
  radix-hits the installed page, prefills only the remainder, and
  regenerates token 0 bit-identically (counter-keyed sampling) —
  so the handed-off stream equals solo generate at any temperature,
  and the router asserts token 0 agreement per handoff as a tripwire.
- **Failure = re-route, never strand**: a corrupt/torn page
  (`HandoffError`) or a source replica dying in the handoff window
  (`ReplicaKilled` from a chaos `on_handoff` hook) re-routes the
  request — radix-hit skip if the page already landed, re-prefill on a
  survivor otherwise, decode-pool full re-prefill as the last resort —
  bounded by ``max_handoff_attempts`` (then a LOUD eviction, not a
  hang). `handoff_failures` / `handoff_reroutes` ride the always-
  present 0-counters contract.

QoS/hedging/failover carry over verbatim because each pool IS a full
`ServingFrontend`: displacement, hedged dispatch, watchdog restarts
and failover all run per pool, per leg. The disagg layer adds its own
end-to-end lifecycle record per request (queued at admission,
first_token when the prefill leg lands = TTFT is prefill-pool
pressure; terminal at the decode result = TPOT is decode-pool
pressure) — the windowed TTFT/TPOT split per QoS class that a
controller's pool-ratio actuator (`shift_pool`) reads.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from apex1_tpu_torch.serving.disagg.kv_transfer import (HandoffError,
                                                        KVPage,
                                                        extract_page,
                                                        install_page,
                                                        verify_page)
from apex1_tpu_torch.serving.engine import (Engine, RequestResult,
                                            derive_request_seed)
from apex1_tpu_torch.serving.frontend import (MODES, FrontendConfig,
                                              ServingFrontend)
from apex1_tpu_torch.serving.metrics import TERMINAL, ServingMetrics
from apex1_tpu_torch.serving.replica import ReplicaKilled, Submission
from apex1_tpu_torch.serving.scheduler import (Backpressure,
                                               new_request_id, qos_rank)


@dataclasses.dataclass
class DisaggConfig:
    """Two pool configs + the handoff knobs. Both pools MUST be built
    from the same ``make_engine`` (same geometry, same params) — the
    page lane's shapes/dtypes are part of the handoff's manifest
    contract and a geometry mismatch is a typed arrival failure, not a
    supported mode."""

    prefill: FrontendConfig = dataclasses.field(
        default_factory=lambda: FrontendConfig(n_replicas=1))
    decode: FrontendConfig = dataclasses.field(
        default_factory=lambda: FrontendConfig(n_replicas=1))
    prefill_chunk: int = 16        # the ENGINE's chunk size — the
    #  router computes the chunk-aligned share point with it, so it
    #  must match EngineConfig.prefill_chunk
    handoff_latency_s: float = 0.0  # simulated/expected transfer time:
    #  a completed prefill's page is held this long (virtual clock in
    #  fleetsim) before arrival verification + decode admission
    max_handoff_attempts: int = 5  # re-routes per request before a
    #  loud eviction (the anti-crash-loop bound, same idea as the
    #  supervisor's poison threshold)
    seed: int = 0                  # base for derived per-request seeds
    metrics_window: int = 128      # disagg-level rolling ring (the
    #                                pool-ratio actuator's signal)


class DisaggFrontend:
    """Prefill pool + decode pool behind the `ServingFrontend` call
    surface (submit / poll / pop_result / pump / run_until_drained /
    cancel / summary / actuation knobs). ``fault`` sees both pools'
    replica hooks AND the handoff window (`ServingFault.on_handoff`).
    """

    def __init__(self, make_engine: Callable[..., Engine],
                 config: Optional[DisaggConfig] = None, *,
                 fault=None,
                 clock: Optional[Callable[[], float]] = None):
        self.cfg = cfg = config or DisaggConfig()
        if cfg.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.clock = clock or time.monotonic
        self.metrics = ServingMetrics(window=cfg.metrics_window,
                                      clock=self.clock)
        self._fault = fault
        self.prefill = ServingFrontend(make_engine, cfg.prefill,
                                       fault=fault, clock=clock)
        self.decode = ServingFrontend(make_engine, cfg.decode,
                                      fault=fault, clock=clock)
        self._subs: Dict[int, Submission] = {}     # original contracts
        self._live: set = set()
        self._phase: Dict[int, str] = {}   # prefill | handoff | decode
        self._direct: set = set()          # routed straight to decode
        self._tok0: Dict[int, int] = {}    # prefill leg's token 0
        self._attempts: Dict[int, int] = {}
        self._pending: List[Tuple[float, int, KVPage]] = []  # in transit
        self._deferred: List[Tuple[str, int]] = []  # backpressured legs
        self._ttft_marked: set = set()
        self._terminal: Dict[int, RequestResult] = {}
        self._admission_limit: Optional[int] = None
        self.mode_control = "load"         # property: fans to pools

    # ---- lifecycle ------------------------------------------------------

    def start(self) -> "DisaggFrontend":
        self.prefill.start()
        self.decode.start()
        return self

    def stop(self) -> None:
        self.prefill.stop()
        self.decode.stop()

    # ---- submission -----------------------------------------------------

    def submit(self, tokens, max_new_tokens: int, *,
               qos: str = "best_effort", tenant: Optional[str] = None,
               deadline: Optional[float] = None, prefix=None,
               seed: Optional[int] = None,
               req_id: Optional[int] = None) -> int:
        """Admit + phase-route one request. The seed is pinned HERE
        (disagg level) so the prefill leg, the decode leg, and every
        re-route regenerate the identical stream. Raises `Backpressure`
        on the disagg admission limit or from the target pool."""
        qos_rank(qos)
        now = self.clock()
        rid = new_request_id() if req_id is None else int(req_id)
        if seed is None:
            seed = derive_request_seed(self.cfg.seed, rid)
        seed = int(seed) & 0x7FFFFFFF
        if (self._admission_limit is not None
                and self.total_inflight >= self._admission_limit):
            raise self._reject(
                rid, now, qos, tenant,
                f"admission limit ({self._admission_limit})",
                retry_after_s=0.05 * max(1.0, self.load_fraction))
        sub = Submission(
            tokens=np.asarray(tokens, np.int32).reshape(-1),
            max_new_tokens=int(max_new_tokens), req_id=rid,
            seed=int(seed), prefix=prefix, deadline=deadline, qos=qos,
            tenant=tenant, submitted_at=now)
        route = self._route_for(sub)
        # the disagg-level lifecycle record: END-TO-END TTFT/TPOT per
        # class, surviving every pool-internal restart/failover/reroute
        self.metrics.event(rid, "queued", now=now,
                           n_prompt=int(sub.tokens.size), qos=qos,
                           tenant=tenant)
        try:
            if route == "decode":
                self.decode.submit(
                    sub.tokens, max_new_tokens=sub.max_new_tokens,
                    qos=qos, tenant=tenant, deadline=deadline,
                    prefix=prefix, seed=seed, req_id=rid)
            else:
                # the prefill LEG: sample token 0, retire at prefill,
                # leave the page behind for the handoff
                self.prefill.submit(
                    sub.tokens, max_new_tokens=1, qos=qos,
                    tenant=tenant, deadline=deadline, prefix=prefix,
                    seed=seed, req_id=rid)
        except Backpressure:
            self.metrics.event(rid, "rejected", now=now,
                               reason=f"{route} pool backpressure")
            raise
        self._subs[rid] = sub
        self._live.add(rid)
        self._phase[rid] = route if route == "prefill" else "decode"
        if route == "decode":
            self._direct.add(rid)
        self.metrics.event(rid, "prefill", now=now, route=route)
        return rid

    def cancel(self, req_id: int) -> bool:
        if req_id in self._terminal or req_id not in self._live:
            return False
        ph = self._phase.get(req_id)
        if ph == "prefill":
            return self.prefill.cancel(req_id)
        if ph == "decode":
            return self.decode.cancel(req_id)
        # parked in the handoff window: no pool owns it — settle here
        self._pending = [p for p in self._pending if p[1] != req_id]
        self._deferred = [d for d in self._deferred if d[1] != req_id]
        self._finish(req_id, RequestResult(
            req_id=req_id, status="cancelled",
            tokens=np.zeros((0,), np.int32),
            reason="cancelled in handoff window"))
        return True

    # ---- results --------------------------------------------------------

    def poll(self, req_id: int) -> Optional[RequestResult]:
        return self._terminal.get(req_id)

    def pop_result(self, req_id: int) -> Optional[RequestResult]:
        res = self._terminal.pop(req_id, None)
        if res is not None:
            self._subs.pop(req_id, None)
            self._tok0.pop(req_id, None)
            self._attempts.pop(req_id, None)
            self._direct.discard(req_id)
        return res

    @property
    def results(self) -> Dict[int, RequestResult]:
        return dict(self._terminal)

    # ---- the supervision tick -------------------------------------------

    def pump(self, rounds: int = 1) -> None:
        """One supervision round x ``rounds``: pump both pools (their
        own watchdogs/restarts/hedges/ladders), then run the handoff
        state machine — collect finished prefill legs, deliver pages
        whose transfer latency elapsed, retry backpressured legs, stamp
        TTFTs, collect decode results."""
        for _ in range(rounds):
            self.prefill.pump(1)
            self.decode.pump(1)
            now = self.clock()
            self._collect_prefill(now)
            self._process_pending(now)
            self._retry_deferred(now)
            self._observe_first_tokens()
            self._collect_decode()

    def run_until_drained(self, *, timeout_s: float = 60.0,
                          max_rounds: int = 100_000
                          ) -> Dict[int, RequestResult]:
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
                f"(phases: { {r: self._phase.get(r) for r in sorted(self._live)} }, "
                f"states: {self.replica_states()})")
        return self.results

    # ---- routing --------------------------------------------------------

    def _full(self, sub: Submission) -> np.ndarray:
        if sub.prefix:
            return np.concatenate([
                np.asarray(sub.prefix, np.int32).reshape(-1),
                sub.tokens])
        return sub.tokens

    def _handoff_key(self, sub: Submission
                     ) -> Tuple[Optional[tuple], int]:
        """The page key the prefill leg leaves behind: the explicit
        ``prefix`` when one was given (the engine's exact-tuple
        contract), else the chunk-aligned share point of the full
        prompt. ``(None, 0)`` when the prompt is too short to produce
        a page."""
        if sub.prefix:
            return (tuple(int(t) for t in sub.prefix),
                    len(tuple(sub.prefix)))
        full = sub.tokens
        C = self.cfg.prefill_chunk
        lstar = ((int(full.size) - 1) // C) * C
        if lstar < C:
            return None, 0
        return tuple(int(t) for t in full[:lstar]), lstar

    def _decode_has(self, key: tuple) -> bool:
        """Pool-local radix probe: does ANY routable decode engine
        already hold ``key``?"""
        for rep in self.decode.replicas:
            if rep.state not in ("new", "alive") or rep.engine is None:
                continue
            if rep.engine.kv.has_prefix(key):
                return True
        return False

    def _route_for(self, sub: Submission) -> str:
        """'decode' on a full-prompt radix hit (prefill pool skipped
        entirely) or a prompt too short to produce a page; 'prefill'
        otherwise."""
        key, _length = self._handoff_key(sub)
        if key is None:
            return "decode"
        if self._decode_has(key):
            return "decode"
        return "prefill"

    # ---- the handoff state machine --------------------------------------

    def _collect_prefill(self, now: float):
        for rid in [r for r in list(self._live)
                    if self._phase.get(r) == "prefill"]:
            res = self.prefill.pop_result(rid)
            if res is None:
                continue
            if res.status != "done" or res.tokens.size < 1:
                # shed / evicted / rejected at the prefill pool: the
                # pool's verdict is the request's verdict
                self._finish(rid, res)
                continue
            self._tok0[rid] = int(res.tokens[0])
            if rid not in self._ttft_marked:
                # TTFT == prefill-pool pressure: token 0 exists the
                # moment the prefill leg lands
                self._ttft_marked.add(rid)
                self.metrics.event(rid, "first_token", now=now)
            self._start_handoff(rid, now)

    def _start_handoff(self, rid: int, now: float):
        sub = self._subs[rid]
        key, _length = self._handoff_key(sub)
        if key is None:                    # defensive: routed direct
            self._submit_decode(rid, now)
            return
        src = None
        for rep in self.prefill.replicas:
            if (rep.state in ("new", "alive") and rep.engine is not None
                    and rep.engine.kv.has_prefix(key)):
                src = rep
                break
        try:
            if src is None:
                raise HandoffError(
                    f"request {rid}: page ({len(key)} tokens) on no "
                    f"alive prefill replica")
            page = extract_page(src.engine, key)
            if self._fault is not None:
                # the handoff WINDOW: prefill completed, decode has not
                # acknowledged — chaos kills/corruption land here
                self._fault.on_handoff(src.replica_id, rid, page)
        except ReplicaKilled as e:
            # source died mid-transfer: its pool supervisor restarts
            # it next pump; THIS request re-routes, never strands
            src._mark_dead(e)
            self._handoff_failed(rid, now, "window_kill", repr(e),
                                 replica=src.replica_id)
            return
        except HandoffError as e:
            self._handoff_failed(rid, now, "integrity", str(e))
            return
        if self.cfg.handoff_latency_s > 0:
            self._phase[rid] = "handoff"
            self._pending.append(
                (now + self.cfg.handoff_latency_s, rid, page))
        else:
            self._deliver(rid, page, now)

    def _process_pending(self, now: float):
        ready = [p for p in self._pending if p[0] <= now]
        if not ready:
            return
        self._pending = [p for p in self._pending if p[0] > now]
        for _t, rid, page in ready:
            if rid in self._live:
                self._deliver(rid, page, now)

    def _deliver(self, rid: int, page: KVPage, now: float):
        """Arrival: re-digest, install into the decode replica the
        router predicts will take the request (same least-loaded pick
        `submit` makes), resubmit with the original budget."""
        sub = self._subs[rid]
        tgt = self.decode._pick_replica(sub.max_new_tokens,
                                        sub.deadline, now)
        try:
            if tgt is not None and tgt.engine is not None:
                installed = install_page(tgt.engine, page)
            else:
                # nothing to install into yet (replica engine not
                # built / no feasible target): the arrival gate still
                # runs — a corrupt page must fail HERE, typed
                verify_page(page)
                installed = False
        except HandoffError as e:
            self._handoff_failed(rid, now, "integrity", str(e))
            return
        self.metrics.incr("handoffs")
        self.metrics.transition(
            "handoff", req=rid, page_tokens=page.length,
            to_replica=(None if tgt is None else tgt.replica_id),
            installed=bool(installed),
            attempt=self._attempts.get(rid, 0))
        self._submit_decode(rid, now)

    def _handoff_failed(self, rid: int, now: float, kind: str,
                        why: str, **fields):
        self.metrics.incr("handoff_failures")
        # field named `failure`, not `kind` — the obs spine reserves
        # `kind` for the record type
        self.metrics.transition("handoff_failure", req=rid,
                                failure=kind, reason=why, **fields)
        self._reroute(rid, now, why)

    def _reroute(self, rid: int, now: float, why: str):
        """The never-strand contract: radix-hit skip if the page
        already lives in the decode pool, re-prefill on a survivor
        otherwise, decode-pool full re-prefill when the prefill pool
        has no routable replica — bounded by ``max_handoff_attempts``,
        then a loud eviction."""
        n = self._attempts.get(rid, 0) + 1
        self._attempts[rid] = n
        if n > self.cfg.max_handoff_attempts:
            self._finish(rid, RequestResult(
                req_id=rid, status="evicted",
                tokens=np.zeros((0,), np.int32),
                reason=f"handoff failed after {n - 1} attempts: {why}"))
            return
        self.metrics.incr("handoff_reroutes")
        self.metrics.transition("handoff_reroute", req=rid, attempt=n,
                                reason=why)
        sub = self._subs[rid]
        key, _length = self._handoff_key(sub)
        if key is not None and self._decode_has(key):
            # an earlier attempt's page landed: radix-hit skip
            self._submit_decode(rid, now)
        elif self.prefill._alive():
            self._resubmit_prefill(rid, now)
        else:
            # no prefill survivor THIS round: the decode pool
            # re-prefills the whole prompt — slower, never stranded
            self._submit_decode(rid, now)

    def _resubmit_prefill(self, rid: int, now: float):
        sub = self._subs[rid]
        if sub.deadline is not None and now > sub.deadline:
            self._finish(rid, RequestResult(
                req_id=rid, status="evicted",
                tokens=np.zeros((0,), np.int32),
                reason="deadline passed during handoff re-route"))
            return
        try:
            self.prefill.submit(
                sub.tokens, max_new_tokens=1, qos=sub.qos,
                tenant=sub.tenant, deadline=sub.deadline,
                prefix=sub.prefix, seed=sub.seed, req_id=rid)
            self._phase[rid] = "prefill"
        except Backpressure:
            self._phase[rid] = "handoff"
            self._deferred.append(("prefill", rid))

    def _submit_decode(self, rid: int, now: float):
        sub = self._subs[rid]
        if sub.deadline is not None and now > sub.deadline:
            self._finish(rid, RequestResult(
                req_id=rid, status="evicted",
                tokens=np.zeros((0,), np.int32),
                reason="deadline passed awaiting decode admission"))
            return
        try:
            self.decode.submit(
                sub.tokens, max_new_tokens=sub.max_new_tokens,
                qos=sub.qos, tenant=sub.tenant, deadline=sub.deadline,
                prefix=sub.prefix, seed=sub.seed, req_id=rid)
            self._phase[rid] = "decode"
        except Backpressure:
            self._phase[rid] = "handoff"
            self._deferred.append(("decode", rid))

    def _retry_deferred(self, now: float):
        pending, self._deferred = self._deferred, []
        for stage, rid in pending:
            if rid not in self._live:
                continue
            if stage == "decode":
                self._submit_decode(rid, now)
            else:
                self._resubmit_prefill(rid, now)

    def _observe_first_tokens(self):
        """Direct-decode routes never pass through the prefill-leg
        collection: stamp their TTFT from the decode pool's own
        lifecycle record (exact pool timestamp)."""
        for rid in list(self._direct):
            if rid in self._ttft_marked or rid not in self._live:
                continue
            rec = self.decode.metrics.records.get(rid)
            if rec is not None and rec.t_first_token is not None:
                self._ttft_marked.add(rid)
                self.metrics.event(rid, "first_token",
                                   now=rec.t_first_token)

    def _collect_decode(self):
        for rid in [r for r in list(self._live)
                    if self._phase.get(r) == "decode"]:
            res = self.decode.pop_result(rid)
            if res is None:
                continue
            tok0 = self._tok0.get(rid)
            if (tok0 is not None and res.status == "done"
                    and res.tokens.size
                    and int(res.tokens[0]) != tok0):
                # the per-handoff parity tripwire: counter-keyed
                # sampling makes the decode pool regenerate the
                # prefill leg's token 0 — a mismatch means the stream
                # diverged and must be LOUD, not a quiet wrong answer
                self.metrics.incr("handoff_parity_mismatches")
                self.metrics.transition(
                    "handoff_parity_mismatch", req=rid,
                    prefill_tok0=tok0,
                    decode_tok0=int(res.tokens[0]))
            self._finish(rid, res)

    def _finish(self, rid: int, res: RequestResult):
        self._terminal[rid] = res
        self._live.discard(rid)
        self._phase.pop(rid, None)
        self._ttft_marked.discard(rid)
        status = res.status if res.status in TERMINAL else "done"
        self.metrics.event(rid, status, reason=res.reason,
                           n_generated=int(res.tokens.size))

    def _reject(self, rid: int, now: float, qos: str,
                tenant: Optional[str], reason: str, *,
                retry_after_s: float) -> Backpressure:
        self.metrics.event(rid, "queued", now=now, n_prompt=0,
                           qos=qos, tenant=tenant)
        self.metrics.event(rid, "rejected", now=now, reason=reason)
        return Backpressure(reason, queue_depth=self.total_inflight,
                            retry_after_s=retry_after_s)

    # ---- aggregates / introspection -------------------------------------

    @property
    def total_inflight(self) -> int:
        return len(self._live)

    @property
    def capacity(self) -> int:
        cap = self.prefill.capacity + self.decode.capacity
        if self._admission_limit is not None:
            cap = min(cap, self._admission_limit)
        return cap

    @property
    def load_fraction(self) -> float:
        return self.total_inflight / self.capacity

    @property
    def admission_limit(self) -> Optional[int]:
        return self._admission_limit

    @property
    def n_alive(self) -> int:
        return self.prefill.n_alive + self.decode.n_alive

    @property
    def replicas(self) -> list:
        """Both pools' supervisors (read-only aggregate view — ids are
        only unique per pool; pool-level actuation goes through
        `shift_pool` / the per-pool frontends)."""
        return list(self.prefill.replicas) + list(self.decode.replicas)

    @property
    def mode(self) -> str:
        """The worse of the two pools' overload modes."""
        return MODES[max(MODES.index(self.prefill.mode),
                         MODES.index(self.decode.mode))]

    @property
    def mode_control(self) -> str:
        return self._mode_control

    @mode_control.setter
    def mode_control(self, value: str):
        # a controller flips the DISAGG frontend to external control;
        # both pools' built-in load ladders go quiet with it
        self._mode_control = value
        if hasattr(self, "prefill"):
            self.prefill.mode_control = value
            self.decode.mode_control = value

    def replica_states(self) -> dict:
        return {"prefill": self.prefill.replica_states(),
                "decode": self.decode.replica_states()}

    def pool_view(self) -> dict:
        """Per-pool guardrail snapshot for the pool-ratio actuator
        (the PRESSURE signal — windowed TTFT vs TPOT — rides the
        disagg metrics window; this carries liveness and occupancy)."""
        return {
            "prefill": {
                "n_replicas": len(self.prefill.replicas),
                "n_alive": self.prefill.n_alive,
                "inflight": self.prefill.total_inflight,
                "load_fraction": round(self.prefill.load_fraction, 4)},
            "decode": {
                "n_replicas": len(self.decode.replicas),
                "n_alive": self.decode.n_alive,
                "inflight": self.decode.total_inflight,
                "load_fraction": round(self.decode.load_fraction, 4)},
        }

    def summary(self) -> dict:
        """The disagg snapshot: end-to-end metrics (window carries the
        per-class TTFT/TPOT split), handoff counters (0-present), both
        pool summaries under ``pools``, and goodput rates aggregated
        across BOTH pools' current engines — one surface for a
        controller and the drills."""
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
        s["pool_view"] = self.pool_view()
        s["pools"] = {"prefill": self.prefill.summary(),
                      "decode": self.decode.summary()}
        agg = {k: 0 for k in ("prefix_lookups", "prefix_hits",
                              "prefix_saved_tokens", "spec_drafted",
                              "spec_accepted")}
        for rep in self.replicas:
            eng = rep.engine
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

    # ---- the actuation surface ------------------------------------------

    def set_mode(self, mode: str, *, by: str = "operator", **evidence):
        """Flip BOTH pools' overload mode (each pool banks its own
        transition; the disagg level banks the aggregate flip)."""
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
        if mode == self.mode and (self.prefill.mode == mode
                                  and self.decode.mode == mode):
            return
        self.metrics.transition(
            "mode", frm=self.mode, to=mode, by=by,
            load_fraction=round(self.load_fraction, 4), **evidence)
        self.prefill.set_mode(mode, by=by, **evidence)
        self.decode.set_mode(mode, by=by, **evidence)

    def add_replica(self, pool: str = "decode", *,
                    by: str = "operator", **evidence) -> int:
        """Grow one pool by a replica (decode by default — the
        capacity-relief rung; the RATIO actuator is `shift_pool`)."""
        f = self.decode if pool == "decode" else self.prefill
        rid = f.add_replica(by=by, **evidence)
        self.metrics.transition("replica_added", pool=pool,
                                replica=rid, by=by, **evidence)
        return rid

    def retire_replica(self, replica_id: Optional[int] = None,
                       pool: str = "decode", *, by: str = "operator",
                       **evidence) -> Optional[int]:
        f = self.decode if pool == "decode" else self.prefill
        out = f.retire_replica(replica_id, by=by, **evidence)
        if out is not None:
            self.metrics.transition("replica_retiring", pool=pool,
                                    replica=out, by=by, **evidence)
        return out

    def shift_pool(self, to: str, *, by: str = "operator",
                   **evidence) -> Optional[dict]:
        """The pool-RATIO actuator: retire one replica from the donor
        pool, add one to ``to`` — total capacity conserved, the
        TTFT/TPOT balance moves. No-op (None, banked) when the donor
        would drop below one routable replica — each phase always
        keeps a pool."""
        if to not in ("prefill", "decode"):
            raise ValueError(f"to must be 'prefill' or 'decode', "
                             f"got {to!r}")
        frm = "decode" if to == "prefill" else "prefill"
        donor = self.decode if to == "prefill" else self.prefill
        grow = self.prefill if to == "prefill" else self.decode
        retired = donor.retire_replica(by=by, **evidence)
        if retired is None:
            self.metrics.transition("pool_shift", to=to, frm=frm,
                                    result="noop",
                                    reason="donor pool at minimum",
                                    by=by, **evidence)
            return None
        added = grow.add_replica(by=by, **evidence)
        self.metrics.transition("pool_shift", to=to, frm=frm,
                                retired=retired, added=added, by=by,
                                **evidence)
        return {"to": to, "frm": frm, "retired": retired,
                "added": added}

    def set_admission_limit(self, limit: Optional[int], *,
                            by: str = "operator", **evidence):
        """End-to-end admission setpoint (checked at the disagg door —
        each pool keeps its own structural capacity)."""
        self._admission_limit = (None if limit is None
                                 else max(1, int(limit)))
        self.metrics.transition("admission_limit",
                                limit=self._admission_limit,
                                by=by, **evidence)

    def set_hedge_budget(self, budget_s: Optional[float],
                         tenant: Optional[str] = None, *,
                         by: str = "operator", **evidence):
        """Install a fitted TTFT/hedge budget on BOTH pools (each leg
        hedges its own phase against its own pool's budget clock)."""
        self.prefill.set_hedge_budget(budget_s, tenant, by=by,
                                      **evidence)
        self.decode.set_hedge_budget(budget_s, tenant, by=by,
                                     **evidence)
        self.metrics.transition(
            "hedge_budget", tenant=tenant,
            budget_s=None if budget_s is None else float(budget_s),
            by=by, **evidence)
