"""Per-request lifecycle metrics for the serving engine (a copy of
``apex1_tpu/serving/metrics.py``, which imports no JAX; the port keeps
its own).

Every request walks the state machine
``queued → prefill → decode → {done | evicted | cancelled}`` (or is
``rejected`` at the door); each transition is an EVENT with a
monotonic timestamp (`obs.spine.monotonic` — the one clock every
subsystem stamps with). Events stream through
`utils.observability.MetricsLogger` as JSON lines when a logger is
supplied (the same sink the training loop uses, so one log carries
both), mirror into the telemetry spine's run file when
``APEX1_OBS_DIR`` is set (``serving.request`` / ``serving.transition``
events — docs/observability.md), and always accumulate in memory for
`summary()` — the
offered-load sweep in ``tools/bench_serving.py`` reads tokens/sec,
p50/p99 time-to-first-token, and mean slot occupancy from it.

Schema (`docs/serving.md` § Engine): every event line is
``{"event", "req", "t", **fields}``; per-step samples are
``{"event": "step", "t", "active", "queue_depth", "occupancy"}``;
SYSTEM transitions (degraded-mode flips, replica restarts — no single
request owns them) are ``{"event", "t", **fields}`` with no ``req``
key, banked through `transition` and kept in ``transitions`` for the
drills to assert on.

Failure-path counters (`incr`) ride `summary()["counters"]`: retries,
hedges fired/won, sheds, evictions, replica restarts — the numbers an
operator pages on, always present (0 when the path never fired).

Two control-loop extensions (docs/autopilot.md):

- **Rolling window**: whole-run aggregates freeze late-run signal under
  early history (an hour of healthy traffic pins p99 no matter what the
  last minute did), so the last ``window`` TERMINAL requests also land
  in a ring buffer and `summary()["window"]` reports per-class /
  per-tenant latency+TTFT percentiles over just that ring — the
  autopilot's control signal. Whole-run fields keep their meaning.
- **Injectable clock**: ``clock`` replaces `obs.spine.monotonic` as the
  timestamp source, so `testing.fleetsim` can stamp every event with
  VIRTUAL time and two replays of one trace produce bit-identical
  event histories.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Callable, Dict, Optional

import numpy as np

from apex1_tpu_torch.obs import spine
from apex1_tpu_torch.utils.observability import MetricsLogger

#: terminal request states
TERMINAL = ("done", "evicted", "cancelled", "rejected")

#: failure-path counters always present in summary()["counters"]
FAILURE_COUNTERS = ("retries", "hedges_fired", "hedges_won", "sheds",
                    "evictions", "replica_restarts",
                    # disaggregated serving (docs/serving.md
                    # § Disaggregated serving): a corrupt/torn KV
                    # handoff caught by the manifest re-digest, and the
                    # re-route that answered it — 0 on a healthy fleet
                    # is an ASSERTED property, not missing data
                    "handoff_failures", "handoff_reroutes")


@dataclasses.dataclass
class RequestRecord:
    """Lifecycle timestamps + counters for one request."""

    req_id: int
    n_prompt: int = 0
    n_generated: int = 0
    t_queued: Optional[float] = None
    t_prefill: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None
    status: str = "queued"
    reason: str = ""
    qos: Optional[str] = None     # set when the queued event carries it
    tenant: Optional[str] = None  #  (frontend lifecycle records do)
    # goodput-multiplier observables: radix-cache outcome at
    # admission (None = the engine never looked — prefix cache off or a
    # frontend-level record) and the speculative accept-rate numerators
    # the terminal event banks
    prefix_hit: Optional[bool] = None
    prefix_saved: int = 0         # cached positions the hit skipped
    n_drafted: int = 0
    n_accepted: int = 0

    @property
    def ttft(self) -> Optional[float]:
        """Time-to-first-token: submit → first sampled token. With the
        engine's deferred mode (``eos_id=None``) the first-token event
        marks the prefill chain's DISPATCH under async dispatch — a
        lower bound on availability (the value lands with the step
        chain); with an ``eos_id`` every step blocks on its tokens, so
        the instant is exact."""
        if self.t_queued is None or self.t_first_token is None:
            return None
        return self.t_first_token - self.t_queued

    @property
    def accept_rate(self) -> Optional[float]:
        """Speculative draft accept rate (None when the request never
        ran under speculation — fields-only-when-data, like the
        percentile keys)."""
        if self.n_drafted <= 0:
            return None
        return self.n_accepted / self.n_drafted

    @property
    def tpot(self) -> Optional[float]:
        """Time-per-output-token over the DECODE phase: first token →
        terminal, per generated token past the first (None until both
        stamps exist, or when at most one token was generated). TTFT
        is the prefill phase's pressure signal; this is the decode
        phase's — the pair is the disaggregated pool-ratio actuator's
        input (docs/serving.md § Disaggregated serving)."""
        if (self.t_first_token is None or self.t_done is None
                or self.n_generated < 2):
            return None
        return (self.t_done - self.t_first_token) / (self.n_generated - 1)

    @property
    def latency(self) -> Optional[float]:
        if self.t_queued is None or self.t_done is None:
            return None
        if self.status == "rejected":
            # a refusal is terminal at its queued instant — calling
            # that "0.0s latency" would deflate every percentile the
            # control loop reads (a flood of rejections must read as
            # missing done-rate, not as excellent latency)
            return None
        return self.t_done - self.t_queued


class ServingMetrics:
    """Event sink + aggregator. ``logger`` (a `MetricsLogger`) makes
    every event a JSON line; omit it for in-memory-only collection
    (tests, benches that only want `summary()`)."""

    def __init__(self, logger: Optional[MetricsLogger] = None, *,
                 window: int = 128,
                 clock: Optional[Callable[[], float]] = None):
        self.logger = logger
        self._clock = clock or spine.monotonic
        self.records: Dict[int, RequestRecord] = {}
        self.counters: Dict[str, int] = {}
        self.transitions: list = []
        # the last `window` TERMINAL requests (qos/tenant/status/ttft/
        # latency/prefix_hit/accept_rate) — the rolling control signal
        # summary()["window"] reports; deque drops the oldest, O(window)
        # space forever
        self._window: deque = deque(maxlen=max(1, int(window)))
        # step samples fold into RUNNING aggregates (count / occupancy
        # sum / peak queue) — a long-lived engine steps indefinitely,
        # so per-step dicts would leak host memory;
        # per-request records are bounded by `drain()` below
        self._step_n = 0
        self._occ_sum = 0.0
        self._peak_queue = 0
        self._event_seq = 0
        self._t0 = self._clock()
        # submit (and its queued/rejected events) may run on an ingest
        # thread (`runtime.RequestFeeder`) while the engine loop logs
        # token/terminal events — same cross-thread pattern the
        # Scheduler locks for; unlocked counters would lose updates
        self._lock = threading.Lock()

    # ---- events ---------------------------------------------------------

    def event(self, req_id: int, name: str, now: Optional[float] = None,
              **fields) -> RequestRecord:
        now = self._clock() if now is None else now
        with self._lock:
            return self._event_locked(req_id, name, now, fields)

    def _event_locked(self, req_id: int, name: str, now: float,
                      fields: dict) -> RequestRecord:
        rec = self.records.setdefault(req_id, RequestRecord(req_id))
        if name == "queued":
            # also on RE-queue: a retried submission (stable req_id
            # after a transient rejection) returns to the queued state
            rec.status = "queued"
            rec.t_queued = now
            rec.n_prompt = int(fields.get("n_prompt", 0))
            if fields.get("qos") is not None:
                rec.qos = str(fields["qos"])
            if fields.get("tenant") is not None:
                rec.tenant = str(fields["tenant"])
        elif name == "prefill":
            rec.status = "prefill"
            rec.t_prefill = now
            if fields.get("prefix_hit") is not None:
                rec.prefix_hit = bool(fields["prefix_hit"])
                rec.prefix_saved = int(fields.get("prefix_saved", 0))
        elif name == "first_token":
            rec.status = "decode"
            rec.t_first_token = now
            rec.n_generated = 1
        elif name == "token":
            rec.n_generated += int(fields.get("n", 1))
        elif name in TERMINAL:
            rec.status = name
            rec.t_done = now
            rec.reason = str(fields.get("reason", ""))
            rec.n_generated = int(fields.get("n_generated",
                                             rec.n_generated))
            rec.n_drafted = int(fields.get("n_drafted", rec.n_drafted))
            rec.n_accepted = int(fields.get("n_accepted",
                                            rec.n_accepted))
            self._window.append(
                (rec.qos or "best_effort", rec.tenant, name,
                 rec.ttft, rec.latency, rec.prefix_hit,
                 rec.accept_rate, rec.tpot))
        else:
            raise ValueError(f"unknown lifecycle event {name!r}")
        if name != "token":
            # per-token lines would dominate the log; counts ride the
            # terminal event instead. Lifecycle events also mirror into
            # the telemetry spine (APEX1_OBS_DIR) so serving joins the
            # same run stream as bench/training/tuning. The spine
            # stamps its own run-relative `t` (ONE time axis across
            # emitters); this object's engine-relative clock rides
            # along as `t_serving` — passing it as `t` would put two
            # unrecorded origins on the shared axis.
            spine.emit("event", "serving.request", event=name,
                       req=int(req_id), t_serving=now - self._t0,
                       **fields)
            if self.logger is not None:
                self._event_seq += 1
                self.logger.log(self._event_seq,
                                {"event": name, "req": int(req_id),
                                 "t": now - self._t0, **{
                                     k: v for k, v in fields.items()}},
                                _obs_name=None)
        return rec

    def incr(self, name: str, n: int = 1) -> None:
        """Bump a failure-path counter (see `FAILURE_COUNTERS`; other
        names are allowed — they appear in the counters dict too)."""
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + int(n)

    def get_counter(self, name: str) -> int:
        """One counter, under the lock — the cheap cross-object read
        (`ServingFrontend.summary` aggregates each replica engine's
        prefix/spec counters through this instead of paying a whole-run
        `summary()` per replica)."""
        with self._lock:
            return int(self.counters.get(name, 0))

    def transition(self, name: str, now: Optional[float] = None,
                   **fields) -> dict:
        """Bank a SYSTEM event (no owning request): degraded-mode
        flips, replica deaths/restarts, hedge dispatches. Every
        transition is a JSON line when a logger is wired AND kept in
        ``transitions`` — the overload drill asserts each degradation
        step left a banked record."""
        now = self._clock() if now is None else now
        rec = {"event": str(name), "t": now - self._t0, **fields}
        # rec's engine-relative "t" must NOT land on spine.emit's `t`
        # parameter (run-relative axis) — same origin rule as above
        spine.emit("event", "serving.transition", event=rec["event"],
                   t_serving=rec["t"],
                   **{k: v for k, v in fields.items() if k != "t"})
        with self._lock:
            self.transitions.append(rec)
            if self.logger is not None:
                self._event_seq += 1
                self.logger.log(self._event_seq, rec, _obs_name=None)
        return rec

    def step_sample(self, active: int, max_slots: int,
                    queue_depth: int) -> None:
        """One engine-step occupancy sample (drives mean occupancy and
        peak queue depth — folded into running aggregates, O(1) space
        for the life of the engine)."""
        with self._lock:
            self._step_n += 1
            self._occ_sum += active / max_slots
            if queue_depth > self._peak_queue:
                self._peak_queue = queue_depth

    def drain(self) -> Dict[int, RequestRecord]:
        """Remove and return all TERMINAL request records — the
        long-running server's pressure valve (ship them to a sink, let
        the dict stay bounded by in-flight work); pair with popping
        `Engine.results`. The occupancy/step aggregates and the
        wall clock in `summary()` are LIFETIME values and do not reset
        — for a fresh measurement window, swap in a new
        `ServingMetrics` (what `tools/bench_serving.py` does between
        reps)."""
        with self._lock:
            gone = {k: r for k, r in self.records.items()
                    if r.status in TERMINAL}
            for k in gone:
                del self.records[k]
            return gone

    # ---- aggregates -----------------------------------------------------

    def summary(self) -> dict:
        """Aggregate view: counts per terminal status, throughput over
        the engine's wall clock, TTFT percentiles, occupancy — plus
        ``window``: the same percentiles per QoS class / tenant over
        only the last ``window`` terminal requests (the rolling control
        signal; whole-run fields keep their life-of-the-engine
        meaning)."""
        with self._lock:
            recs = list(self.records.values())
            counters = dict(self.counters)
            win = list(self._window)
        done = [r for r in recs if r.status == "done"]
        ttfts = sorted(r.ttft for r in recs if r.ttft is not None)
        lats = sorted(r.latency for r in recs if r.latency is not None)
        gen = sum(r.n_generated for r in recs)
        wall = max(self._clock() - self._t0, 1e-9)
        out = {
            "requests": len(recs),
            "done": len(done),
            "evicted": sum(r.status == "evicted" for r in recs),
            "cancelled": sum(r.status == "cancelled" for r in recs),
            "rejected": sum(r.status == "rejected" for r in recs),
            "generated_tokens": int(gen),
            "tokens_per_sec": gen / wall,
            "steps": self._step_n,
            # the failure-path record: named counters are ALWAYS
            # present (0 = the path never fired — an asserted property,
            # not missing data); ad-hoc incr() names ride along
            "counters": {**{k: 0 for k in FAILURE_COUNTERS}, **counters},
        }
        if ttfts:
            out["ttft_p50_ms"] = 1e3 * float(np.percentile(ttfts, 50))
            out["ttft_p99_ms"] = 1e3 * float(np.percentile(ttfts, 99))
        if lats:
            out["latency_p50_ms"] = 1e3 * float(np.percentile(lats, 50))
            out["latency_p99_ms"] = 1e3 * float(np.percentile(lats, 99))
        tpots = sorted(r.tpot for r in recs if r.tpot is not None)
        if tpots:
            out["tpot_p50_ms"] = 1e3 * float(np.percentile(tpots, 50))
            out["tpot_p99_ms"] = 1e3 * float(np.percentile(tpots, 99))
        if self._step_n:
            out["mean_occupancy"] = self._occ_sum / self._step_n
            out["peak_queue_depth"] = self._peak_queue
        # goodput-multiplier rates (fields-only-when-data, same contract
        # as the percentiles): cumulative over every admission/draft the
        # engine ever made; the rolling view rides window.per_class
        lookups = counters.get("prefix_lookups", 0)
        if lookups:
            out["prefix_hit_rate"] = counters.get("prefix_hits",
                                                  0) / lookups
            out["prefix_saved_tokens"] = counters.get(
                "prefix_saved_tokens", 0)
        drafted = counters.get("spec_drafted", 0)
        if drafted:
            out["accept_rate"] = counters.get("spec_accepted",
                                              0) / drafted
        out["window"] = self._window_summary(win)
        return out

    def window_summary(self) -> dict:
        """Just ``summary()["window"]`` — O(window), no whole-run
        percentile sorts under the lock. The control loop's per-tick
        read (whole-run sorts grow with every request ever served;
        a 10 Hz controller must not pay that, nor stall the ingest
        thread's `event()` calls while it does)."""
        with self._lock:
            win = list(self._window)
        return self._window_summary(win)

    @staticmethod
    def _window_summary(win: list) -> dict:
        """Per-class / per-tenant percentiles over the ring entries
        ``(qos, tenant, status, ttft, latency, prefix_hit,
        accept_rate, tpot)``. Percentile/rate keys only appear when the
        class has data — same contract as the whole-run fields. TTFT
        and TPOT land side by side per QoS class: the per-phase split
        (prefill pressure vs decode pressure) the disaggregated
        pool-ratio actuator consumes."""
        def rates(entries, d):
            hits = [e[5] for e in entries if e[5] is not None]
            if hits:
                d["prefix_hit_rate"] = sum(hits) / len(hits)
            accs = [e[6] for e in entries if e[6] is not None]
            if accs:
                d["accept_rate"] = float(np.mean(accs))
            return d

        def stats(entries, *, with_latency=True):
            d = {"n": len(entries),
                 "done": sum(e[2] == "done" for e in entries)}
            ttfts = sorted(e[3] for e in entries if e[3] is not None)
            lats = sorted(e[4] for e in entries if e[4] is not None)
            if ttfts:
                d["ttft_p50_ms"] = 1e3 * float(np.percentile(ttfts, 50))
                d["ttft_p99_ms"] = 1e3 * float(np.percentile(ttfts, 99))
            if with_latency and lats:
                d["latency_p50_ms"] = 1e3 * float(np.percentile(lats, 50))
                d["latency_p99_ms"] = 1e3 * float(np.percentile(lats, 99))
            tpots = sorted(e[7] for e in entries if e[7] is not None)
            if tpots:
                d["tpot_p50_ms"] = 1e3 * float(np.percentile(tpots, 50))
                d["tpot_p99_ms"] = 1e3 * float(np.percentile(tpots, 99))
            return rates(entries, d)

        by_class: Dict[str, list] = {}
        by_tenant: Dict[str, list] = {}
        for e in win:
            by_class.setdefault(e[0], []).append(e)
            if e[1] is not None:
                by_tenant.setdefault(e[1], []).append(e)
        return rates(win, {
            "size": len(win),
            "per_class": {c: stats(es)
                          for c, es in sorted(by_class.items())},
            # tenants feed the per-tenant hedge/TTFT budget fit, which
            # only needs the TTFT distribution
            "per_tenant": {t: stats(es, with_latency=False)
                           for t, es in sorted(by_tenant.items())},
        })
