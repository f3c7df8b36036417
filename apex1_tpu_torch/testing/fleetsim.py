"""Replayable fleet simulator — drill the serving fleet on a VIRTUAL
clock, deterministically, at scales the CPU tests can afford (the port
of ``apex1_tpu/testing/fleetsim.py``; the JAX package's autopilot is not
ported, so ``autopilot=`` raises).

The real multi-replica frontend is driven exactly as production drives
it — real `ServingFrontend`, real `ReplicaSupervisor` pump loops, real
`Engine`s (the dense pool) over `testing.chaos.toy_decoder` — but every
clock the frontend and supervisors read is this module's
`VirtualClock`, advanced a fixed ``dt_s`` per supervision round (the
engines' deadline clock stays ``time.monotonic``: the traces carry no
deadlines). That closes every nondeterminism hole at once:

- **Time** is simulated: latency/TTFT percentiles, hedge budgets, and
  mode-transition timestamps are functions of queueing structure, not
  of how loaded the CI box is.
- **Arrivals** are a `Trace`: either synthetic (``bursty`` /
  ``diurnal`` / ``adversarial_overload`` generators, seed-keyed) or
  recorded (`Trace.load` of a banked JSONL). Request ids are the trace
  indices, so derived sampling seeds — and therefore every token — are
  functions of (trace, seed) alone.
- **Faults** are seed-keyed `testing.chaos` schedules firing at exact
  (replica, step) coordinates.

Same (trace, seed) ⇒ bit-identical episode: `SimReport.fingerprint`
hashes the full transition history and every request's outcome
INCLUDING its token stream — the determinism drills pin two runs'
fingerprints equal, and the same trace through the JAX package's
simulator gives the same outcomes.

What this does and does NOT prove: it proves control-loop LOGIC —
detection, hysteresis, recovery, SLO arithmetic — against real serving
code paths. It does not prove wall-clock numbers: virtual seconds cost
nothing, so a simulated "p99 = 0.4s" says nothing about device
latency.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Dict, List, Optional

import numpy as np

__all__ = [
    "VirtualClock", "SimRequest", "Trace", "synthetic_trace",
    "FleetSimConfig", "FleetSim", "SimReport", "run_fleet", "kill_k_of_n",
]

TRACE_SCHEMA = "apex1-fleettrace-v1"
# APPEND-only: `TRACE_KINDS.index(kind)` keys each generator's rng
# stream, so reordering would silently regenerate every banked trace
TRACE_KINDS = ("steady", "bursty", "diurnal", "adversarial_overload",
               "adversarial_long_prompt")


class VirtualClock:
    """The one clock of a simulated episode. Callable (drop-in for
    ``time.monotonic``), advanced only by the simulator."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += float(dt)
        return self.t


@dataclasses.dataclass(frozen=True)
class SimRequest:
    """One arrival: WHEN it lands and its admission contract. Prompt
    tokens are derived, not stored — request index x trace seed keys a
    deterministic draw, so a trace file stays a few bytes per
    request."""

    t: float
    qos: str
    tenant: str
    prompt_len: int
    max_new_tokens: int


@dataclasses.dataclass
class Trace:
    """An arrival trace: replayable input to `FleetSim`. ``seed`` keys
    BOTH the generator that built it and the per-request prompt-token
    draws at replay."""

    kind: str
    seed: int
    horizon_s: float
    requests: List[SimRequest]

    def fingerprint(self) -> str:
        doc = {"schema": TRACE_SCHEMA, "kind": self.kind,
               "seed": self.seed, "horizon_s": self.horizon_s,
               "requests": [dataclasses.astuple(r)
                            for r in self.requests]}
        return hashlib.sha256(
            json.dumps(doc, sort_keys=True).encode()).hexdigest()[:16]

    def save(self, path: str) -> str:
        """Bank as JSONL (header + one line per arrival) — the
        'recorded trace' format `load` replays."""
        with open(path, "w", encoding="utf-8") as f:
            f.write(json.dumps(
                {"schema": TRACE_SCHEMA, "kind": self.kind,
                 "seed": self.seed, "horizon_s": self.horizon_s,
                 "n": len(self.requests)}) + "\n")
            for r in self.requests:
                f.write(json.dumps(dataclasses.astuple(r)) + "\n")
        return path

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path, encoding="utf-8") as f:
            head = json.loads(f.readline())
            if head.get("schema") != TRACE_SCHEMA:
                raise ValueError(
                    f"{path}: not a {TRACE_SCHEMA} trace "
                    f"(schema={head.get('schema')!r})")
            reqs = [SimRequest(float(t), str(q), str(tn), int(pl),
                               int(mn))
                    for t, q, tn, pl, mn in map(json.loads, f)]
        return cls(kind=str(head["kind"]), seed=int(head["seed"]),
                   horizon_s=float(head["horizon_s"]), requests=reqs)


def synthetic_trace(kind: str, *, seed: int, horizon_s: float = 8.0,
                    base_rate: float = 25.0,
                    class_mix: Optional[Dict[str, float]] = None,
                    tenants: tuple = ("acme", "zeta"),
                    prompt_lens: tuple = (3, 9),
                    new_tokens: tuple = (4, 10),
                    burst_mult: float = 5.0,
                    burst_len_s: float = 0.6,
                    n_bursts: int = 3,
                    diurnal_period_s: float = 4.0,
                    overload_mult: float = 3.0,
                    overload_span: tuple = (0.3, 0.8),
                    long_prompt_lens: tuple = (18, 30)) -> Trace:
    """Seed-keyed arrival generator (inhomogeneous Poisson via
    thinning). Kinds:

    - ``steady``: flat ``base_rate`` req/s.
    - ``bursty``: flat base + ``n_bursts`` seed-placed windows at
      ``burst_mult`` x base — the anti-flap fixture (each burst is
      shorter than any honest sustain threshold).
    - ``diurnal``: sinusoidal rate between ~0.3x and 1x base.
    - ``adversarial_overload``: base rate outside
      ``overload_span`` (fractions of the horizon), ``overload_mult``
      x base inside — sustained past any burst filter, the headline
      drill's input.
    - ``adversarial_long_prompt``: FLAT base rate — the adversarial
      axis is the prompt-length mix, not the rate: non-guaranteed
      classes draw from ``long_prompt_lens`` while guaranteed keeps
      ``prompt_lens``, so long prefills head-of-line-block short
      interactive traffic at EQUAL offered load (the disaggregation
      drill's input; pair with ``prefill_round_cost``).
    """
    if kind not in TRACE_KINDS:
        raise ValueError(f"unknown trace kind {kind!r}; "
                         f"one of {TRACE_KINDS}")
    mix = dict(class_mix or {"guaranteed": 0.5, "best_effort": 0.25,
                             "sheddable": 0.25})
    classes = sorted(mix)
    probs = np.asarray([mix[c] for c in classes], float)
    probs = probs / probs.sum()
    rng = np.random.default_rng(
        [int(seed), TRACE_KINDS.index(kind), 0xF1EE7])
    if kind == "bursty":
        starts = np.sort(rng.uniform(
            0.0, max(horizon_s - burst_len_s, 0.0), int(n_bursts)))
    t_on, t_off = (overload_span[0] * horizon_s,
                   overload_span[1] * horizon_s)

    def rate(t: float) -> float:
        if kind == "steady":
            return base_rate
        if kind == "bursty":
            hot = any(s <= t < s + burst_len_s for s in starts)
            return base_rate * (burst_mult if hot else 1.0)
        if kind == "diurnal":
            phase = math.sin(2.0 * math.pi * t / diurnal_period_s)
            return base_rate * (0.65 + 0.35 * phase)
        if kind == "adversarial_long_prompt":
            return base_rate
        return base_rate * (overload_mult if t_on <= t < t_off else 1.0)

    rmax = base_rate * max(burst_mult, overload_mult, 1.0)
    reqs: List[SimRequest] = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / rmax))
        if t >= horizon_s:
            break
        if rng.uniform() >= rate(t) / rmax:
            continue                    # thinned
        qos = classes[int(rng.choice(len(classes), p=probs))]
        plens = (long_prompt_lens
                 if (kind == "adversarial_long_prompt"
                     and qos != "guaranteed") else prompt_lens)
        reqs.append(SimRequest(
            t=round(t, 6),
            qos=qos,
            tenant=str(tenants[int(rng.integers(len(tenants)))]),
            prompt_len=int(rng.integers(plens[0], plens[1] + 1)),
            max_new_tokens=int(rng.integers(new_tokens[0],
                                            new_tokens[1] + 1))))
    return Trace(kind=kind, seed=int(seed), horizon_s=float(horizon_s),
                 requests=reqs)


@dataclasses.dataclass
class FleetSimConfig:
    """Simulator knobs (the serving knobs ride the `FrontendConfig`
    the caller passes). ``dt_s`` is the virtual cost of ONE
    supervision round — i.e. one decode step per replica — so a
    replica's service rate is ``slots / (max_new_tokens * dt_s)``
    req/s; provisioning arithmetic in the drills builds on that."""

    dt_s: float = 0.02
    control_interval_s: float = 0.1   # autopilot tick cadence (virtual)
    slots_per_replica: int = 4
    max_len: int = 48
    prefill_chunk: int = 4
    temperature: float = 0.8          # nonzero: determinism claims
    #                                   cover real sampling, not greedy
    vocab: int = 61                   # toy_decoder's default
    num_draft: int = 0                # >0: replica engines run the
    #  speculative verify loop. Tokens are UNCHANGED by construction
    #  (exact-match counter-seed verify), so per-request token digests
    #  replay bit-identically; rounds/latency shift (multi-token steps)
    #  — same (trace, seed, config) stays bit-identical, and accept
    #  rates flow into `summary`/`to_json` for the autopilot to read.
    cache_dtype: Optional[object] = None  # e.g. torch.int8 — the KV
    #  capacity tier under sim (exact for toy_decoder: values < 128)
    drain_grace_s: float = 30.0       # virtual time allowed past the
    #                                   horizon before declaring wedged
    max_rounds: int = 500_000         # hard stop (wedged episode)
    # ---- two-tier (disaggregated) fleet model; all defaults keep the
    # unified path — and every banked fingerprint — byte-identical
    disagg: bool = False              # split frontend_config.n_replicas
    #  into a prefill pool + a decode pool behind a `DisaggFrontend`
    #  (EQUAL total replicas vs the unified fleet — the A/B is fair)
    prefill_replicas: int = 1         # pool split: prefill tier size;
    #                                   decode gets the remainder (>= 1)
    handoff_latency_s: float = 0.0    # virtual seconds a finished
    #  prefill's KV page spends in flight before arrival verification
    #  + decode admission (the ICI/DCN transfer knob)
    prefill_round_cost: bool = False  # charge prefill its CHUNK count
    #  in supervision rounds (a replica prefilling an 8-chunk prompt
    #  stalls its decode slots 8 rounds) — the head-of-line cost that
    #  makes unified vs disaggregated an honest A/B; off by default
    #  (pre-existing traces replay with free prefills, as banked)


@dataclasses.dataclass
class SimReport:
    """One episode's outcome — everything the drills assert on."""

    trace_kind: str
    trace_seed: int
    trace_fingerprint: str
    n_arrivals: int
    n_submitted: int
    rejected: Dict[str, int]          # per class, at the front door
    outcomes: List[dict]              # per request: idx/qos/tenant/
    #                                   status/latency/ttft/token digest
    transitions: List[dict]           # full banked transition history
    actions: List[dict]               # autopilot episode log ([] if off)
    summary: dict                     # frontend.summary() at the end
    virtual_s: float
    rounds: int

    def per_class(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for o in self.outcomes:
            d = out.setdefault(o["qos"], {"n": 0, "done": 0, "full": 0,
                                          "latencies": [], "ttfts": []})
            d["n"] += 1
            if o["status"] == "done":
                d["done"] += 1
                if o["full"]:
                    d["full"] += 1
                    if o["latency"] is not None:
                        d["latencies"].append(o["latency"])
                    if o["ttft"] is not None:
                        d["ttfts"].append(o["ttft"])
        for cls, n in self.rejected.items():
            out.setdefault(cls, {"n": 0, "done": 0, "full": 0,
                                 "latencies": [],
                                 "ttfts": []})["n"] += n
        return out

    def latency_p99_s(self, qos: str) -> Optional[float]:
        """Whole-episode p99 completion latency of the class's
        full-service DONE requests (virtual seconds)."""
        lats = self.per_class().get(qos, {}).get("latencies", [])
        return float(np.percentile(lats, 99)) if lats else None

    def slo_attainment(self, qos: str, latency_s: float) -> float:
        """Fraction of the class's OFFERED load (accepted + rejected)
        that finished 'done', AT FULL SERVICE, within ``latency_s``.
        A rejected or shed request is a miss — admission control must
        not launder SLO misses into non-measurements — and so is a
        degrade-capped truncation: answering 4 of the 10 requested
        tokens fast is not meeting the SLO, it is a cheap way to fake
        one (the static-panic sweep point exists to prove the
        distinction matters)."""
        d = self.per_class().get(qos)
        if not d or d["n"] == 0:
            return 1.0
        ok = sum(1 for x in d["latencies"] if x <= latency_s)
        return ok / d["n"]

    def ttft_attainment(self, qos: str, ttft_s: float) -> float:
        """Fraction of the class's OFFERED load whose first token
        landed within ``ttft_s`` AND whose request finished done at
        full service — the same no-laundering discipline as
        `slo_attainment` (a fast first token on a request that was
        then evicted is not an attained TTFT), and the disaggregation
        drill's headline metric."""
        d = self.per_class().get(qos)
        if not d or d["n"] == 0:
            return 1.0
        ok = sum(1 for x in d["ttfts"] if x <= ttft_s)
        return ok / d["n"]

    def goodput_tok_s(self) -> float:
        """Generated tokens of DONE requests per virtual second."""
        tok = sum(o["n_tokens"] for o in self.outcomes
                  if o["status"] == "done")
        return tok / max(self.virtual_s, 1e-9)

    def fingerprint(self) -> str:
        """The bit-determinism surface: sha256 over the transition
        history, the autopilot episode, and every request outcome
        (status + token digest). Same (trace, seed) ⇒ same value."""
        doc = {"trace": self.trace_fingerprint,
               "transitions": self.transitions,
               "actions": self.actions,
               "outcomes": self.outcomes,
               "rejected": self.rejected,
               "rounds": self.rounds}
        return hashlib.sha256(
            json.dumps(doc, sort_keys=True).encode()).hexdigest()

    def to_json(self) -> dict:
        per = {cls: {"offered": d["n"], "done": d["done"],
                     "full": d["full"]}
               for cls, d in sorted(self.per_class().items())}
        out = {"trace": self.trace_kind, "seed": self.trace_seed,
               "trace_fingerprint": self.trace_fingerprint,
               "n_arrivals": self.n_arrivals,
               "n_submitted": self.n_submitted,
               "rejected": self.rejected, "per_class": per,
               "goodput_tok_per_virtual_s":
                   round(self.goodput_tok_s(), 2),
               "n_actions": len(self.actions),
               "n_transitions": len(self.transitions),
               "virtual_s": round(self.virtual_s, 3),
               "rounds": self.rounds,
               "fingerprint": self.fingerprint()}
        # goodput-multiplier rates, when the episode banked them —
        # ride the report, NOT the fingerprint (pre-existing traces
        # must fingerprint bit-stably)
        for k in ("prefix_hit_rate", "accept_rate"):
            if k in self.summary:
                out[k] = round(self.summary[k], 4)
        # disaggregated-episode visibility — same rule: rides the
        # report, never the fingerprint
        cnt = self.summary.get("counters", {})
        if "handoff_failures" in cnt:
            out["handoffs"] = sum(1 for t in self.transitions
                                  if t.get("event") == "handoff")
            out["handoff_failures"] = cnt["handoff_failures"]
            out["handoff_reroutes"] = cnt.get("handoff_reroutes", 0)
            out["pool_shifts"] = sum(1 for t in self.transitions
                                     if t.get("event") == "pool_shift")
        return out


_METERED_CLS = None


def _metered_engine_cls():
    """Engine subclass charging prefill its chunk count in supervision
    rounds (``FleetSimConfig.prefill_round_cost``): a step that admits
    ``k`` total prefill chunks stalls the replica for ``k - 1`` further
    rounds (every resident decode stream waits — the head-of-line cost
    disaggregation removes from the decode tier, whose radix-hit
    admissions prefill at most one remainder chunk). It overrides the
    engine's ``_run_chunks`` hook. Built lazily so the module imports
    without the serving stack."""
    global _METERED_CLS
    if _METERED_CLS is not None:
        return _METERED_CLS
    from apex1_tpu_torch.serving import Engine

    class _MeteredEngine(Engine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self._stall_rounds = 0
            self._chunks_this_step = 0

        def _run_chunks(self, slot, tokens, idx0, install_lane, seed):
            C = self.cfg.prefill_chunk
            self._chunks_this_step += math.ceil(int(tokens.size) / C)
            return super()._run_chunks(slot, tokens, idx0,
                                       install_lane, seed)

        def step(self):
            if self._stall_rounds > 0:
                # still paying an earlier admission's prefill: no
                # admissions, no decode — the round is burned
                self._stall_rounds -= 1
                self.metrics.step_sample(0, self.cfg.max_slots,
                                         self.scheduler.depth)
                return 0
            self._chunks_this_step = 0
            out = super().step()
            if self._chunks_this_step > 1:
                self._stall_rounds = self._chunks_this_step - 1
            return out

    _METERED_CLS = _MeteredEngine
    return _MeteredEngine


class FleetSim:
    """One simulated episode over a `Trace`.

    ``frontend_config`` is the real `serving.FrontendConfig` under
    test; ``chaos`` a `testing.chaos.ServingFault`; ``device`` the
    toy-decoder engines' device (CUDA unless named). ``autopilot`` (the
    JAX package's controller) is not ported: ROADMAP.md queue A item
    11. The engines, the virtual clock, and the shared metrics window
    are owned here.
    """

    def __init__(self, trace: Trace, frontend_config, *,
                 sim: Optional[FleetSimConfig] = None,
                 autopilot=None, chaos=None, device=None):
        from apex1_tpu_torch.serving import (Engine, EngineConfig,
                                             ServingFrontend)
        from apex1_tpu_torch.testing.chaos import toy_decoder

        if autopilot is not None:
            raise NotImplementedError(
                "the autopilot is not ported yet (ROADMAP.md queue A "
                "item 11)")
        self.trace = trace
        self.cfg = sim or FleetSimConfig()
        self.clock = VirtualClock()
        apply_fn, make_cache = toy_decoder(self.cfg.vocab, device=device)
        ecfg = EngineConfig(
            max_slots=self.cfg.slots_per_replica,
            max_len=self.cfg.max_len,
            prefill_chunk=self.cfg.prefill_chunk,
            vocab_size=self.cfg.vocab,
            temperature=self.cfg.temperature,
            num_draft=self.cfg.num_draft,
            cache_dtype=self.cfg.cache_dtype,
            seed=frontend_config.seed, paged=False)

        EngineCls = (_metered_engine_cls()
                     if self.cfg.prefill_round_cost else Engine)

        def make_engine(cache_dtype=None):
            # a degraded-mode restart's explicit dtype overrides the
            # sim's steady-state tier (the Engine kwarg-beats-config
            # rule)
            return EngineCls(apply_fn, make_cache, ecfg,
                             cache_dtype=cache_dtype, device=device)

        # no explicit metrics=: the frontend's own default wiring
        # (window from the config, our virtual clock) IS the
        # production wiring the simulator claims to drive
        if self.cfg.disagg:
            from apex1_tpu_torch.serving.disagg import (DisaggConfig,
                                                        DisaggFrontend)
            n_pre = max(1, int(self.cfg.prefill_replicas))
            n_dec = max(1, int(frontend_config.n_replicas) - n_pre)
            # split, never add: prefill + decode == the unified fleet's
            # replica count, so a unified-vs-disagg A/B compares
            # ROUTING, not provisioning
            dcfg = DisaggConfig(
                prefill=dataclasses.replace(frontend_config,
                                            n_replicas=n_pre),
                decode=dataclasses.replace(frontend_config,
                                           n_replicas=n_dec),
                prefill_chunk=self.cfg.prefill_chunk,
                handoff_latency_s=self.cfg.handoff_latency_s,
                seed=frontend_config.seed,
                metrics_window=frontend_config.metrics_window)
            self.front = DisaggFrontend(make_engine, dcfg,
                                        fault=chaos, clock=self.clock)
        else:
            self.front = ServingFrontend(make_engine, frontend_config,
                                         fault=chaos, clock=self.clock)
        self.pilot = None

    def _prompt(self, idx: int, n: int) -> np.ndarray:
        # prompt tokens are a pure function of (trace seed, request
        # index): replaying the same trace re-derives identical prompts
        rng = np.random.default_rng(
            [int(self.trace.seed), 0x70C5, int(idx)])
        return rng.integers(0, self.cfg.vocab, (n,)).astype(np.int32)

    def run(self) -> SimReport:
        from apex1_tpu_torch.serving import Backpressure

        trace, cfg, front = self.trace, self.cfg, self.front
        reqs = trace.requests
        rejected: Dict[str, int] = {}
        submitted: Dict[int, int] = {}   # rid (== trace idx) -> idx
        i = 0
        rounds = 0
        next_ctl = 0.0
        deadline = trace.horizon_s + cfg.drain_grace_s
        while i < len(reqs) or front.total_inflight > 0:
            now = self.clock()
            if now > deadline or rounds >= cfg.max_rounds:
                raise TimeoutError(
                    f"fleetsim wedged: {front.total_inflight} in "
                    f"flight at virtual t={now:.2f}s "
                    f"(deadline {deadline:.2f}s, round {rounds}; "
                    f"replicas {front.replica_states()})")
            while i < len(reqs) and reqs[i].t <= now:
                r = reqs[i]
                try:
                    front.submit(self._prompt(i, r.prompt_len),
                                 max_new_tokens=r.max_new_tokens,
                                 qos=r.qos, tenant=r.tenant,
                                 req_id=i)  # trace idx = stable id ⇒
                    #  derived seeds (and tokens) replay bit-identical
                    submitted[i] = i
                except Backpressure:
                    rejected[r.qos] = rejected.get(r.qos, 0) + 1
                i += 1
            front.pump(1)
            if self.pilot is not None and now + 1e-12 >= next_ctl:
                self.pilot.tick()
                next_ctl += cfg.control_interval_s
            self.clock.advance(cfg.dt_s)
            rounds += 1
        return self._report(submitted, rejected, rounds)

    def _report(self, submitted: Dict[int, int],
                rejected: Dict[str, int], rounds: int) -> SimReport:
        front, trace = self.front, self.trace
        outcomes = []
        for rid in sorted(submitted):
            res = front.poll(rid)
            rec = front.metrics.records.get(rid)
            req = trace.requests[rid]
            toks = res.tokens if res is not None else np.zeros(0)
            n_tokens = int(np.asarray(toks).size)
            outcomes.append({
                "idx": rid, "qos": req.qos, "tenant": req.tenant,
                "status": res.status if res else "lost",
                # full service = every REQUESTED token delivered (a
                # degrade-capped truncation is not a fulfilled request)
                "full": bool(res is not None and res.status == "done"
                             and n_tokens >= req.max_new_tokens),
                "latency": (None if rec is None or rec.latency is None
                            else round(rec.latency, 6)),
                "ttft": (None if rec is None or rec.ttft is None
                         else round(rec.ttft, 6)),
                "n_tokens": n_tokens,
                "tokens_sha1": hashlib.sha1(
                    np.ascontiguousarray(
                        np.asarray(toks, np.int32)).tobytes()
                ).hexdigest()[:12]})
        return SimReport(
            trace_kind=trace.kind, trace_seed=trace.seed,
            trace_fingerprint=trace.fingerprint(),
            n_arrivals=len(trace.requests),
            n_submitted=len(submitted),
            rejected=dict(sorted(rejected.items())),
            outcomes=outcomes,
            transitions=list(front.metrics.transitions),
            actions=(list(self.pilot.actions) if self.pilot else []),
            summary=front.summary(),
            virtual_s=self.clock(), rounds=rounds)


def run_fleet(trace: Trace, frontend_config, *,
              sim: Optional[FleetSimConfig] = None, autopilot=None,
              chaos=None, device=None) -> SimReport:
    """Build + run one episode (the one-call form the drills and
    benches use)."""
    return FleetSim(trace, frontend_config, sim=sim,
                    autopilot=autopilot, chaos=chaos, device=device).run()


def kill_k_of_n(seed: int, *, n_replicas: int, k: int, lo: int,
                hi: int):
    """Seed-keyed PERMANENT shrink of a serving fleet: k distinct
    replicas each get a repeating `chaos.ReplicaKill` at a derived
    step, so every restart crashes again until the supervisor's budget
    is spent and the frontend fails the replica's work over — the
    fleet serves on the n−k survivors. The serving mirror of the
    training side's `chaos.shrink_schedule` (the kill-k-of-n
    drill): same seed ⇒ same victims and steps, so "k of n replicas
    die and every request still completes" is an assertable property.
    """
    from apex1_tpu_torch.resilience.retry import _mix32
    from apex1_tpu_torch.testing.chaos import ChaosSchedule, ReplicaKill

    if not 0 < k < n_replicas:
        raise ValueError(
            f"need 0 < k < n_replicas, got k={k} of {n_replicas}")
    if hi <= lo:
        raise ValueError(f"need hi > lo, got [{lo}, {hi})")
    start = _mix32(seed ^ 0x51A7E) % n_replicas
    kills = []
    for j in range(k):
        victim = (start + j) % n_replicas       # k DISTINCT victims
        step = lo + _mix32(seed ^ 0xB10C ^ (j * 0x9E3779B9)) % (hi - lo)
        kills.append(ReplicaKill(victim, step, repeat=True))
    return ChaosSchedule(kills)
