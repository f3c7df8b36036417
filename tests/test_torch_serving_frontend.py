"""The port's supervised replicas (`serving.replica`), multi-replica
frontend (`serving.frontend`) and `runtime.RequestFeeder` against the
JAX package on the CPU: the drills of tests/test_serving_frontend.py
and the feeder cases of tests/test_serving.py.

Every drill runs through both packages on `testing.chaos.toy_decoder`
(the port's has the JAX one's logits; the engines use the dense pool,
in pump mode, with explicit request ids) and returns what the two must
agree on: each request's status, reason and token stream, and the
banked transition events (their times and error texts aside). The
drills also hold the JAX tests' own assertions, and every completed
stream equals an undisturbed single-engine run of the same (prompt,
seed).
"""

import time
import types

import numpy as np
import pytest
import torch

import apex1_tpu.resilience.retry as jax_retry
import apex1_tpu.runtime as jax_runtime
import apex1_tpu.serving as jsv
import apex1_tpu.testing.chaos as jchaos
import apex1_tpu_torch.runtime as runtime
import apex1_tpu_torch.serving as tsv
import apex1_tpu_torch.testing.chaos as tchaos

VOCAB = 61
EKW = dict(max_slots=3, max_len=48, prefill_chunk=4, vocab_size=VOCAB,
           temperature=0.8, seed=7)


@pytest.fixture(scope="module")
def pkgs():
    jtoy = jchaos.toy_decoder(VOCAB)
    ttoy = tchaos.toy_decoder(VOCAB, device="cpu")

    def jfactory(**kw):
        apply_fn, make_cache, params = jtoy

        def make_engine(cache_dtype=None):
            return jsv.Engine(apply_fn, make_cache, params,
                              jsv.EngineConfig(**dict(EKW, **kw)),
                              cache_dtype=cache_dtype)
        return make_engine

    def tfactory(**kw):
        apply_fn, make_cache = ttoy

        def make_engine(cache_dtype=None):
            return tsv.Engine(apply_fn, make_cache,
                              tsv.EngineConfig(**dict(EKW, paged=False,
                                                      **kw)),
                              cache_dtype=cache_dtype, device="cpu")
        return make_engine

    import jax
    import jax.numpy as jnp

    def jleaf(eng):
        return str(jax.tree_util.tree_leaves(eng.kv.cache)[0].dtype)

    def tleaf(eng):
        return str(eng.kv.cache["toy"]["h"].dtype).replace("torch.", "")

    return {
        "jax": types.SimpleNamespace(sv=jsv, chaos=jchaos,
                                     factory=jfactory, int8=jnp.int8,
                                     leaf_dtype=jleaf),
        "torch": types.SimpleNamespace(sv=tsv, chaos=tchaos,
                                       factory=tfactory, int8=torch.int8,
                                       leaf_dtype=tleaf),
    }


def _reference(make_engine, front, rids):
    """Uninterrupted single-engine run of each request (same seed)."""
    ref = make_engine()
    out = {}
    for rid in rids:
        sub = front._subs[rid]
        rr = ref.submit(sub.tokens, max_new_tokens=sub.max_new_tokens,
                        seed=sub.seed)
        ref.run(max_steps=200)
        out[rid] = [int(t) for t in ref.results[rr].tokens]
    return out


def _events(front, drop=()):
    skip = {"t", "error"} | set(drop)
    return [{k: v for k, v in t.items() if k not in skip}
            for t in front.metrics.transitions]


def _results(front, rids):
    out = {}
    for r in rids:
        res = front.poll(r)
        out[r] = (None if res is None else
                  (res.status, res.reason, [int(t) for t in res.tokens]))
    return out


def _check_reference(make_engine, front, rids):
    want = _reference(make_engine, front, rids)
    for rid in rids:
        res = front.poll(rid)
        assert res is not None and res.status == "done", (rid, res)
        assert [int(t) for t in res.tokens] == want[rid]


def _submit_mix(front, n, *, new=8, qos="best_effort", base=0, seed=0):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, VOCAB, (3 + i % 5,)).astype(np.int32)
               for i in range(n)]
    return [front.submit(p, max_new_tokens=new + i % 3, qos=qos,
                         req_id=base + i) for i, p in enumerate(prompts)]


def _front(p, fault=None, make_engine=None, **fkw):
    replica = fkw.pop("replica", {})
    cfg = p.sv.FrontendConfig(**dict(
        dict(n_replicas=2, capacity_per_replica=8, hedge_after_s=None),
        replica=p.sv.ReplicaConfig(**dict(dict(watchdog_s=60.0),
                                          **replica)), **fkw))
    make_engine = make_engine or p.factory()
    return make_engine, p.sv.ServingFrontend(make_engine, cfg, fault=fault)


# ---- the drills ---------------------------------------------------------


def drill_watchdog_hang(p):
    hang = p.chaos.ReplicaHang(replica=0, at_step=4, hang_s=0.25)
    make_engine, front = _front(p, hang, n_replicas=1,
                                replica=dict(watchdog_s=0.1))
    rids = _submit_mix(front, 4, base=100)
    front.run_until_drained(timeout_s=60.0)
    assert hang.fired == 1 and front.replicas[0].restarts == 1
    assert front.replicas[0].engines_built == 2
    _check_reference(make_engine, front, rids)
    deaths = [t for t in front.metrics.transitions
              if t["event"] == "replica_dead"]
    assert len(deaths) == 1 and "watchdog" in deaths[0]["error"]
    return _results(front, rids), _events(front)


def drill_slow_replica(p):
    slow = p.chaos.SlowReplica(0, delay_s=0.01, from_step=0, to_step=20)
    _, front = _front(p, slow, n_replicas=1,
                      replica=dict(watchdog_s=5.0))
    rids = _submit_mix(front, 3, base=200)
    front.run_until_drained(timeout_s=60.0)
    assert front.replicas[0].restarts == 0
    assert front.replicas[0].state == "alive"
    return _results(front, rids), _events(front)


def drill_failover(p):
    kill = p.chaos.ReplicaKill(replica=0, at_step=3)
    make_engine, front = _front(p, kill, replica=dict(max_restarts=0))
    rids = _submit_mix(front, 6, base=300)
    front.run_until_drained(timeout_s=60.0)
    assert front.replica_states() == ["failed", "alive"]
    assert front.replicas[0].engines_built == 1
    _check_reference(make_engine, front, rids)
    fo = [t for t in front.metrics.transitions if t["event"] == "failover"]
    assert len(fo) == 1 and fo[0]["source"] == 0 and fo[0]["rerouted"]
    return _results(front, rids), _events(front)


def drill_kill_restart(p):
    kill = p.chaos.kill_schedule(seed=20260804, n_replicas=2, lo=4, hi=9)
    make_engine, front = _front(p, kill)
    rids = _submit_mix(front, 6, base=350)
    front.run_until_drained(timeout_s=60.0)
    assert kill.fired == 1
    _check_reference(make_engine, front, rids)
    return (_results(front, rids), _events(front),
            [r.engines_built for r in front.replicas])


def drill_poison(p):
    pill = p.chaos.PoisonPill(poison_token=60)
    _, front = _front(p, pill, n_replicas=1,
                      replica=dict(max_restarts=5, poison_threshold=1))
    rng = np.random.default_rng(1)
    good = [front.submit(rng.integers(0, 59, (4 + i,)), max_new_tokens=6,
                         req_id=400 + i) for i in range(2)]
    bad = front.submit(np.asarray([60, 4], np.int32), max_new_tokens=5,
                       req_id=410)
    front.run_until_drained(timeout_s=60.0)
    res = front.poll(bad)
    assert res.status == "evicted" and "poisoned" in res.reason
    assert pill.fired == 2 and front.replicas[0].restarts == 2
    assert front.replicas[0].state == "alive"
    return _results(front, good + [bad]), _events(front)


def drill_hedge(p):
    kills = p.chaos.ChaosSchedule([p.chaos.ReplicaKill(replica=0,
                                                       at_step=0),
                                   p.chaos.ReplicaKill(replica=0,
                                                       at_step=2)])
    make_engine, front = _front(p, kills, hedge_after_s=0.0)
    prompt = np.random.default_rng(2).integers(0, VOCAB, (5,))
    rid = front.submit(prompt, max_new_tokens=10, qos="guaranteed",
                       req_id=500)
    front.run_until_drained(timeout_s=60.0)
    _check_reference(make_engine, front, [rid])
    c = front.summary()["counters"]
    assert c["hedges_fired"] == 1 and c["hedges_won"] == 1
    return _results(front, [rid]), _events(front)


def drill_never_hedged(p):
    _, front = _front(p, hedge_after_s=0.0)
    prompt = np.random.default_rng(3).integers(0, VOCAB, (4,))
    rids = [front.submit(prompt, max_new_tokens=12, qos="guaranteed",
                         req_id=600)]
    rids += _submit_mix(front, 3, base=610)
    front.run_until_drained(timeout_s=60.0)
    assert front.summary()["counters"]["hedges_fired"] == 0
    return _results(front, rids), _events(front)


def _overloaded(p, *, enter_shed=0.6, enter_degraded=0.9, cache_dtype=None,
                cap=3):
    return _front(p, n_replicas=1, capacity_per_replica=4, seed=3,
                  enter_shed=enter_shed, enter_degraded=enter_degraded,
                  exit_overload=0.25, sustain_rounds=2,
                  degrade=p.sv.DegradeProfile(max_new_tokens_cap=cap,
                                              cache_dtype=cache_dtype))


def drill_overload(p):
    _, front = _overloaded(p)
    shed = _submit_mix(front, 4, new=12, qos="sheddable", base=700)
    deadline = time.monotonic() + 30.0
    rng = np.random.default_rng(4)
    g = [front.submit(rng.integers(0, VOCAB, (4,)), max_new_tokens=6,
                      qos="guaranteed", deadline=deadline, req_id=710 + i)
         for i in range(2)]
    assert front.summary()["counters"]["sheds"] >= 2
    front.run_until_drained(timeout_s=60.0)
    assert time.monotonic() < deadline
    assert all(front.poll(r).status == "done" for r in g)
    front.pump(6)
    assert front.mode == "normal"
    return _results(front, shed + g), _events(front)


def drill_degraded(p):
    _, front = _overloaded(p, enter_shed=0.4, enter_degraded=0.5)
    rids = _submit_mix(front, 3, new=12, base=800)
    front.pump(4)
    assert front.mode == "degraded"
    rng = np.random.default_rng(5)
    capped = front.submit(rng.integers(0, VOCAB, (4,)), max_new_tokens=12,
                          req_id=810)
    with pytest.raises(p.sv.Backpressure, match="sheddable"):
        front.submit(rng.integers(0, VOCAB, (3,)), max_new_tokens=4,
                     qos="sheddable", req_id=811)
    front.run_until_drained(timeout_s=60.0)
    assert front.poll(capped).tokens.size == 3
    assert front.summary()["counters"]["degraded_admissions"] == 1
    return _results(front, rids + [capped]), _events(front)


def drill_degraded_int8_restart(p):
    make_engine, front = _overloaded(p, enter_shed=0.4, enter_degraded=0.5,
                                     cache_dtype=p.int8)
    kill = p.chaos.ReplicaKill(replica=0, at_step=6)
    front.replicas[0].fault = kill
    rids = _submit_mix(front, 4, new=10, base=900)
    front.pump(4)
    assert front.mode == "degraded"
    before = p.leaf_dtype(front.replicas[0].engine)
    front.run_until_drained(timeout_s=60.0)
    assert kill.fired == 1 and front.replicas[0].restarts == 1
    after = p.leaf_dtype(front.replicas[0].engine)
    assert (before, after) == ("float32", "int8")
    _check_reference(make_engine, front, rids)
    return _results(front, rids), _events(front, drop=("cache_dtype",))


def drill_cancel_regressions(p):
    make_engine = p.factory()
    out = []
    for failover in (False, True):
        sup = p.sv.ReplicaSupervisor(make_engine, 0,
                                     config=p.sv.ReplicaConfig(
                                         watchdog_s=60.0))
        rng = np.random.default_rng(6)
        keep = sup.submit(rng.integers(0, VOCAB, (4,)), max_new_tokens=6,
                          req_id=1000 + 2 * failover)
        dead = sup.submit(rng.integers(0, VOCAB, (4,)), max_new_tokens=20,
                          req_id=1001 + 2 * failover)
        sup.pump(2)
        sup.cancel(dead)
        sup._mark_dead(RuntimeError("chaos"))
        if failover:
            out.append([s.req_id for s in sup.drain_inflight()])
        else:
            assert sup.restart()
            while sup.poll(keep) is None and sup.pump(1):
                pass
            res = sup.poll(keep)
            out.append((res.status, [int(t) for t in res.tokens]))
        res = sup.poll(dead)
        out.append((res.status, res.reason))
    # end to end: the failover reroute excludes the cancelled id
    _, front = _front(p, capacity_per_replica=8,
                      replica=dict(max_restarts=0))
    rids = _submit_mix(front, 6, new=12, base=1100)
    front.pump(2)
    rep = front.replicas[0]
    victim = sorted(rep._inflight)[0]
    assert front.cancel(victim)
    rep._mark_dead(RuntimeError("chaos"))
    front.run_until_drained(timeout_s=60.0)
    assert front.poll(victim).status == "cancelled"
    _check_reference(make_engine, front, [r for r in rids if r != victim])
    return out, _results(front, rids), _events(front)


def drill_feasibility(p):
    _, front = _front(p, n_replicas=1, capacity_per_replica=2,
                      enter_shed=99.0, enter_degraded=99.0)
    rng = np.random.default_rng(7)
    warm = front.submit(rng.integers(0, VOCAB, (4,)), max_new_tokens=4,
                        req_id=1200)
    front.run_until_drained(timeout_s=60.0)
    assert front.replicas[0].step_ewma > 0.0
    s1 = front.submit(rng.integers(0, VOCAB, (4,)), max_new_tokens=6,
                      qos="sheddable", req_id=1201)
    s2 = front.submit(rng.integers(0, VOCAB, (4,)), max_new_tokens=6,
                      qos="sheddable", req_id=1202)
    with pytest.raises(p.sv.Backpressure, match="feasibly") as ei:
        front.submit(rng.integers(0, VOCAB, (3,)), max_new_tokens=5000,
                     qos="guaranteed", deadline=time.monotonic() + 1e-5,
                     req_id=1203)
    assert ei.value.retry_after_s == 0.0
    assert front.summary()["counters"]["sheds"] == 0
    front.run_until_drained(timeout_s=60.0)
    ok = front.submit(rng.integers(0, VOCAB, (4,)), max_new_tokens=4,
                      deadline=time.monotonic() + 60.0, req_id=1204)
    front.run_until_drained(timeout_s=60.0)
    return _results(front, [warm, s1, s2, ok]), _events(front)


def drill_composed(p):
    kill = p.chaos.ReplicaKill(replica=0, at_step=4)
    slow = p.chaos.SlowReplica(1, delay_s=0.002, from_step=0, to_step=6)
    make_engine, front = _front(p, p.chaos.ChaosSchedule([kill, slow]))
    rids = _submit_mix(front, 5, base=1300)
    front.run_until_drained(timeout_s=60.0)
    assert kill.fired == 1
    _check_reference(make_engine, front, rids)
    return _results(front, rids), _events(front)


def drill_int8_tier(p):
    make_engine, front = _front(p, capacity_per_replica=6, seed=7,
                                cache_dtype=p.int8)
    rids = _submit_mix(front, 4, new=8, base=1400)
    front.run_until_drained(timeout_s=60.0)
    _check_reference(make_engine, front, rids)
    for rep in front.replicas:
        assert p.leaf_dtype(rep.engine) == "int8"
        assert rep.engine.kv.pool_bytes() * 4 == \
            make_engine().kv.pool_bytes()
    return _results(front, rids), _events(front)


def drill_actuation(p):
    """The actuation surface: add / retire a replica, set the mode,
    the admission limit and a hedge budget; every call banked."""
    _, front = _front(p)
    rids = _submit_mix(front, 4, base=1500)
    new = front.add_replica(by="test")
    front.pump(2)
    retiring = front.retire_replica(new, by="test")
    front.set_admission_limit(5, by="test")
    front.set_hedge_budget(None, "acme", by="test")
    front.set_mode("shedding", by="test")
    with pytest.raises(p.sv.Backpressure, match="shedding"):
        front.submit([1, 2], max_new_tokens=3, qos="sheddable",
                     req_id=1590)
    front.set_mode("normal", by="test")
    front.run_until_drained(timeout_s=60.0)
    front.pump(2)
    s = front.summary()
    return (retiring, front.capacity, front.admission_limit,
            _results(front, rids), _events(front),
            {k: s["replicas"][k]["state"] for k in s["replicas"]},
            front.pop_result(rids[0]) is not None, front.poll(rids[0]))


DRILLS = {f.__name__[len("drill_"):]: f for f in (
    drill_watchdog_hang, drill_slow_replica, drill_failover,
    drill_kill_restart, drill_poison, drill_hedge, drill_never_hedged,
    drill_overload, drill_degraded, drill_degraded_int8_restart,
    drill_cancel_regressions, drill_feasibility, drill_composed,
    drill_int8_tier, drill_actuation)}


@pytest.mark.parametrize("name", list(DRILLS))
def test_drill_equals_jax(pkgs, name):
    want = DRILLS[name](pkgs["jax"])
    got = DRILLS[name](pkgs["torch"])
    assert got == want


def test_kill_schedule_picks_equal_jax():
    for seed in (42, 43, 20260804):
        a = tchaos.kill_schedule(seed, n_replicas=4, lo=3, hi=11)
        b = jchaos.kill_schedule(seed, n_replicas=4, lo=3, hi=11)
        assert (a.replica, a.at_step) == (b.replica, b.at_step)


def test_threaded_frontend_streams_equal_pump_and_jax(pkgs):
    """Threaded serve loops under the main-thread supervision tick: the
    streams equal the pump-mode run's and JAX's, and stopping leaves no
    serve thread behind."""
    p = pkgs["torch"]
    make_engine, front = _front(p)
    front.start()
    try:
        rids = _submit_mix(front, 6, base=1600)
        front.run_until_drained(timeout_s=60.0)
    finally:
        front.stop()
    assert all(s in ("stopped", "alive") for s in front.replica_states())
    assert not any(r._thread is not None and r._thread.is_alive()
                   for r in front.replicas)
    got = _results(front, rids)
    _, jfront = _front(pkgs["jax"])
    jrids = _submit_mix(jfront, 6, base=1600)
    jfront.run_until_drained(timeout_s=60.0)
    assert got == _results(jfront, jrids)
    assert front.replicas[0].build_counts()["engines_built"] == 1


# ---- RequestFeeder --------------------------------------------------------


def _feed(mod, work, submit, **kw):
    feeder = mod.RequestFeeder(work, lambda t: (t, {}), submit,
                               **kw).start()
    try:
        feeder.join(timeout=10.0)
    except ValueError:
        pass
    return feeder


def _flaky_submit(bp_cls, fails, floor=None):
    calls = {"n": 0}

    def submit(tokens, **kw):
        calls["n"] += 1
        if fails is None or calls["n"] <= fails:
            raise bp_cls("queue full", queue_depth=9,
                         retry_after_s=floor)
        return kw["req_id"]
    return submit


@pytest.mark.parametrize("case", ["success_after_retries", "exhausted",
                                  "deadline", "floor"])
def test_feeder_counters_equal_jax(case):
    kw = {"success_after_retries": dict(retries=10, retry_wait_s=1e-4),
          "exhausted": dict(retries=2, retry_wait_s=1e-4),
          "deadline": dict(retries=10_000, retry_wait_s=0.05, jitter=0.0,
                           deadline_s=0.12),
          "floor": dict(retries=10, retry_wait_s=1e-4,
                        retry_cap_s=1e-3)}[case]
    fails = {"success_after_retries": 3, "floor": 2}.get(case)
    floor = 0.06 if case == "floor" else None
    work = [[1, 2]] if case != "exhausted" else [[1], [2]]
    out = []
    for mod, bp in ((jax_runtime, jsv.Backpressure),
                    (runtime, tsv.Backpressure)):
        t0 = time.monotonic()
        f = _feed(mod, work, _flaky_submit(bp, fails, floor), **kw)
        out.append((len(f.submitted), [r for _, r in f.dropped],
                    f.counters, time.monotonic() - t0))
    (jn, jd, jc, _), (n, d, c, el) = out
    assert (n, c) == (jn, jc)
    assert [r.split(" (")[0] for r in d] == [r.split(" (")[0] for r in jd]
    if case == "floor":
        assert el >= 2 * floor
    if case == "deadline":
        assert "deadline" in d[0] and c["retries"] < 10
    if case == "exhausted":
        assert all("retries exhausted" in r for r in d)
    assert list(runtime.backoff_delays(5, seed=9)) == \
        list(jax_retry.backoff_delays(5, seed=9))


def test_feeder_drives_engine_through_backpressure(pkgs):
    """The ingest thread tokenizes and submits under a tiny queue while
    the engine loop drains it; nothing is lost, one record a request,
    and a malformed item (it can never fit) is dropped while the rest
    are served."""
    make_engine = pkgs["torch"].factory(max_slots=2, max_queue=2)
    eng = make_engine()
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, VOCAB, (3 + i % 4,)).tolist()
               for i in range(7)]
    work = prompts[:3] + [list(range(60))] + prompts[3:]
    feeder = runtime.RequestFeeder(work,
                                   lambda t: (t, {"max_new_tokens": 4}),
                                   eng.submit, retries=1000,
                                   retry_wait_s=0.001).start()
    deadline = time.monotonic() + 30.0
    while ((not feeder.idle or eng.scheduler.depth or eng.n_active)
           and time.monotonic() < deadline):
        eng.step()
    with pytest.raises(ValueError, match="cache positions"):
        feeder.join(timeout=10.0)
    assert len(feeder.submitted) == 7 and len(feeder.dropped) == 1
    assert len(eng.metrics.records) == 7
    assert eng.metrics.summary()["rejected"] == 0
    ref = make_engine()
    for p, rid in zip(prompts, feeder.submitted):
        rr = ref.submit(p, max_new_tokens=4,
                        seed=tsv.derive_request_seed(EKW["seed"], rid))
        ref.run(max_steps=50)
        assert (eng.results[rid].tokens == ref.results[rr].tokens).all()
