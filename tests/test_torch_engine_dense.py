"""The port's dense engine (``EngineConfig(paged=False)``, `KVPool`) and
the engine features of the serving-tier slice against the JAX package's
engine on the CPU (the scenarios of tests/test_serving.py), on the tiny
fp32 GPT-2 from JAX's params:

- token streams of the staggered join/leave workload equal JAX's dense
  engine's and the port's paged engine's, greedy and at T 0.7, also
  with an ``eos_id``;
- each scenario (explicit ``prefix=`` sharing, ``prefix_cache=False``
  with and without an explicit prefix, the radix cross-request match,
  cancel of a queued / running / mid-admission request, a prefill that
  dies mid-prefix, deadline eviction queued and running, LRU eviction
  and the registration that must not evict its own page, `pop_result`)
  gives the same streams, statuses, reasons and prefix statistics in
  the port's dense engine as in JAX's, and the same streams, statuses
  and reasons in the port's paged engine (whose prefixes floor to whole
  pages);
- slots, prefix refcounts and free pages come back to their start;
- `KVPool`'s operations script against JAX's `KVPool`.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from apex1_tpu.core.policy import get_policy as jax_get_policy
from apex1_tpu.models.generate import gpt2_decoder as jax_gpt2_decoder
from apex1_tpu.models.gpt2 import GPT2 as JaxGPT2
from apex1_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from apex1_tpu.serving import Engine as JaxEngine
from apex1_tpu.serving import EngineConfig as JaxEngineConfig
from apex1_tpu.serving import KVPool as JaxKVPool
from apex1_tpu_torch import (Engine, EngineConfig, GPT2Config, get_policy,
                             gpt2_decoder, gpt2_params_from_jax)
from apex1_tpu_torch.serving import Backpressure, KVPool


@pytest.fixture(scope="module")
def tiny():
    jcfg = JaxGPT2Config.tiny(policy=jax_get_policy("O0"), max_seq_len=64)
    rng = np.random.default_rng(11)
    jparams = JaxGPT2(jcfg).init(
        jax.random.key(0),
        jnp.asarray(rng.integers(0, jcfg.vocab_size, (1, 7))))["params"]
    model = gpt2_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                 GPT2Config.tiny(policy=get_policy("O0"),
                                                 max_seq_len=64), "cpu")
    return dict(jcfg=jcfg, jparams=jparams, model=model,
                vocab=jcfg.vocab_size)


EKW = dict(max_slots=3, max_len=48, prefill_chunk=4)


def _make(tiny, kind, **kw):
    ekw = dict(EKW, vocab_size=tiny["vocab"], **kw)
    if kind == "jax":
        apply_fn, make_cache = jax_gpt2_decoder(JaxGPT2(tiny["jcfg"]))
        return JaxEngine(apply_fn, make_cache, tiny["jparams"],
                         JaxEngineConfig(**dict(ekw, paged=False)))
    apply_fn, make_cache = gpt2_decoder(tiny["model"])
    return Engine(apply_fn, make_cache,
                  EngineConfig(**dict(ekw, paged=kind == "paged")),
                  device="cpu")


def _outcome(eng, rids):
    return [(r, eng.results[r].status, eng.results[r].reason,
             [int(t) for t in eng.results[r].tokens]) for r in rids]


def _stats(eng):
    """Prefix statistics without the paged pool's page ids."""
    return sorted((k, v["length"], v["refcount"], v["hits"])
                  for k, v in eng.kv.prefix_stats().items())


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).tolist() for n in lens]


# ---- scenarios: each returns what both packages must agree on ----------


def sc_staggered(tiny, kind, **kw):
    eng = _make(tiny, kind, **kw)
    ps = _prompts(tiny["vocab"], [3, 7, 5, 9, 4, 6], 1)
    news = [6, 5, 7, 4, 6, 5]
    rids = [eng.submit(p, max_new_tokens=n, seed=10 + i, req_id=100 + i)
            for i, (p, n) in enumerate(zip(ps[:3], news[:3]))]
    eng.step()
    eng.step()
    rids += [eng.submit(p, max_new_tokens=n, seed=20 + i, req_id=200 + i)
             for i, (p, n) in enumerate(zip(ps[3:], news[3:]))]
    eng.run(max_steps=200)
    return _outcome(eng, rids), eng.kv.n_free


def sc_prefix_sharing(tiny, kind, prefix_cache=True):
    eng = _make(tiny, kind, max_slots=2, prefix_cache=prefix_cache,
                temperature=0.7)
    sysp = tuple(_prompts(tiny["vocab"], [9], 2)[0])
    owns = _prompts(tiny["vocab"], [4, 6, 3], 3)
    rids = [eng.submit(o, max_new_tokens=5, prefix=sysp, req_id=300 + i,
                       seed=i) for i, o in enumerate(owns)]
    eng.run(max_steps=100)
    return _outcome(eng, rids), _stats(eng), eng.kv.n_free


def sc_radix(tiny, kind, prefix_cache=True):
    eng = _make(tiny, kind, max_slots=2, prefix_cache=prefix_cache)
    shared = _prompts(tiny["vocab"], [9], 4)[0]
    r1 = eng.submit(shared + [1, 2], max_new_tokens=5, req_id=400)
    eng.run(max_steps=40)
    r2 = eng.submit(shared + [3], max_new_tokens=5, req_id=401)
    eng.run(max_steps=40)
    s = eng.metrics.summary()
    recs = [(eng.metrics.records[r].prefix_hit,
             eng.metrics.records[r].prefix_saved) for r in (r1, r2)]
    return (_outcome(eng, [r1, r2]), _stats(eng), recs,
            s.get("prefix_hit_rate"), s.get("prefix_saved_tokens"))


def sc_cancel(tiny, kind):
    eng = _make(tiny, kind, max_slots=2)
    sysp = tuple(_prompts(tiny["vocab"], [6], 5)[0])
    own, other = _prompts(tiny["vocab"], [3, 4], 6)
    r1 = eng.submit(own, max_new_tokens=20, prefix=sysp, req_id=500)
    r2 = eng.submit(other, max_new_tokens=20, req_id=501)
    r3 = eng.submit(other, max_new_tokens=4, req_id=502)
    eng.step()                              # r1, r2 running, r3 queued
    seen = [eng.cancel(r3), (eng.kv.n_free, eng.n_active, _stats(eng))]
    seen.append(eng.cancel(r1))             # running: released now
    seen.append((eng.kv.n_free, eng.n_active, _stats(eng)))
    seen.append(eng.cancel(r1))             # already terminal
    eng.run(max_steps=60)
    evicted = eng.kv.evict_prefix(sysp)
    return _outcome(eng, [r1, r2, r3]), seen, evicted, eng.kv.n_free


def sc_cancel_mid_admission(tiny, kind):
    eng = _make(tiny, kind, max_slots=2)
    sysp = tuple(_prompts(tiny["vocab"], [6], 7)[0])
    own = _prompts(tiny["vocab"], [3], 8)[0]
    rid = eng.submit(own, max_new_tokens=10, prefix=sysp, req_id=600)
    orig = eng._prefill
    seen = []

    def sneaky(*a, **kw):
        out = orig(*a, **kw)
        seen.append(eng.cancel(rid))        # lands mid-admission
        return out

    eng._prefill = sneaky
    eng.step()
    eng._prefill = orig
    return (_outcome(eng, [rid]), seen[:1], eng.kv.n_free, eng.n_active,
            _stats(eng))


def sc_midprefill_failure(tiny, kind):
    eng = _make(tiny, kind, max_slots=2)
    sysp = tuple(_prompts(tiny["vocab"], [9], 9)[0])
    own = _prompts(tiny["vocab"], [3], 10)[0]
    orig = eng._prefill
    calls = {"n": 0}

    def boom(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("killed mid-prefill")
        return orig(*a, **kw)

    eng._prefill = boom
    eng.submit(own, max_new_tokens=5, prefix=sysp, req_id=700)
    with pytest.raises(RuntimeError, match="mid-prefill"):
        eng.step()
    after = (eng.kv.n_free, _stats(eng), eng.slot_view())
    eng._prefill = orig
    rid = eng.submit(own, max_new_tokens=5, prefix=sysp, req_id=701)
    eng.run(max_steps=40)
    return after, _outcome(eng, [rid]), _stats(eng)


def sc_deadline(tiny, kind):
    eng = _make(tiny, kind, max_slots=1)
    p1, p2, p3 = _prompts(tiny["vocab"], [5, 6, 4], 11)
    r1 = eng.submit(p1, max_new_tokens=30, req_id=800,
                    deadline=time.monotonic() + 0.2)
    r3 = eng.submit(p3, max_new_tokens=4, req_id=802,
                    deadline=time.monotonic() + 0.2)
    eng.step()                              # r1 decoding, r3 queued
    time.sleep(0.25)
    eng.step()                              # both deadlines lapse
    res1 = eng.results[r1]
    first = (res1.status, res1.reason, 0 < res1.tokens.size < 30,
             eng.results[r3].status, eng.results[r3].reason,
             eng.n_active, eng.kv.n_free)
    with pytest.raises(Exception, match="deadline") as err:
        eng.submit(p2, max_new_tokens=4, deadline=time.monotonic() - 1)
    assert type(err.value).__name__ == Backpressure.__name__
    r2 = eng.submit(p2, max_new_tokens=5, req_id=801)
    eng.run(max_steps=50)
    popped = eng.pop_result(r2)
    return (first, popped.status, [int(t) for t in popped.tokens],
            eng.pop_result(r2), sorted(eng.results))


def sc_lru(tiny, kind):
    eng = _make(tiny, kind, max_slots=2, max_prefix_pages=1)
    p1, p2, p3 = _prompts(tiny["vocab"], [9, 9, 9], 12)
    r1 = eng.submit(p1, max_new_tokens=20, req_id=900)
    eng.step()                              # r1 live, holds its page
    r2 = eng.submit(p2, max_new_tokens=3, req_id=901)
    eng.run(max_steps=60)                   # must not evict its own page
    live = _stats(eng)
    r3 = eng.submit(p3, max_new_tokens=3, req_id=902)
    eng.run(max_steps=30)
    return _outcome(eng, [r1, r2, r3]), live, _stats(eng)


SCENARIOS = {
    "prefix_sharing": sc_prefix_sharing,
    "prefix_cache_off_explicit": lambda t, k: sc_prefix_sharing(
        t, k, prefix_cache=False),
    "radix": sc_radix,
    "prefix_cache_off_radix": lambda t, k: sc_radix(t, k,
                                                    prefix_cache=False),
    "cancel": sc_cancel,
    "cancel_mid_admission": sc_cancel_mid_admission,
    "midprefill_failure": sc_midprefill_failure,
    "deadline": sc_deadline,
    "lru": sc_lru,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_equals_jax(tiny, name):
    """The dense pool agrees with JAX's dense engine on everything the
    scenario observes; the paged pool on the streams, statuses and
    reasons (its prefix pages floor to whole pages of 8 positions, so
    its prefix statistics differ by design)."""
    fn = SCENARIOS[name]
    want = fn(tiny, "jax")
    assert fn(tiny, "dense") == want
    assert fn(tiny, "paged")[0] == want[0]


@pytest.mark.parametrize("kw", [dict(), dict(temperature=0.7),
                                dict(temperature=0.7, eos_id=5)],
                         ids=["greedy", "sampled", "eos"])
def test_staggered_streams_equal_jax_and_paged(tiny, kw):
    want = sc_staggered(tiny, "jax", **kw)
    assert sc_staggered(tiny, "dense", **kw) == want
    assert sc_staggered(tiny, "paged", **kw) == want
    assert want[1] == EKW["max_slots"]


def test_dense_decode_writes_in_place_without_host_reads(tiny):
    """The dense pool's step writes the pool tensors themselves (no copy
    of the cache a layer) and every row at its own index."""
    eng = _make(tiny, "dense", temperature=0.7)
    k0 = eng.kv.cache["layer0"]["k"]
    ptr = k0.data_ptr()
    ps = _prompts(tiny["vocab"], [3, 6], 13)
    for i, p in enumerate(ps):
        eng.submit(p, max_new_tokens=4, req_id=1000 + i)
    eng.step()
    assert eng.kv.cache["layer0"]["k"].data_ptr() == ptr
    idx = eng._d_idxs.tolist()
    assert idx[:2] == [4, 7]                # each row one past its prompt
    assert bool(k0[1, :, 6].abs().sum() > 0)
    # the prefill's padded chunk wrote up to position 7, the decode 6
    assert bool(k0[1, :, 8:].abs().sum() == 0)


def test_paged_pool_pages_back_to_start(tiny):
    eng = _make(tiny, "paged", max_slots=2)
    start = eng.kv.n_free_pages
    sc_ids = []
    sysp = tuple(_prompts(tiny["vocab"], [8], 14)[0])
    for i, own in enumerate(_prompts(tiny["vocab"], [3, 4, 5], 15)):
        sc_ids.append(eng.submit(own, max_new_tokens=6, prefix=sysp,
                                 req_id=1100 + i))
    eng.step()
    assert eng.cancel(sc_ids[0])
    eng.run(max_steps=60)
    for key in list(eng.kv.prefix_stats()):
        assert eng.kv.evict_prefix(eval(key))
    assert eng.kv.n_free_pages == start
    assert eng.kv.n_free == 2


def _pool_script(pool, lane):
    out = []
    a, b = pool.alloc(), pool.alloc()
    out.append((a, b, pool.alloc(), pool.occupancy, pool.n_free))
    pool.free(a)
    out.append((pool.n_free, pool.alloc()))
    with pytest.raises(ValueError, match="double-freed"):
        pool.free(b) or pool.free(b)
    pool.put_prefix((1, 2), lane, 2)
    with pytest.raises(ValueError, match="already registered"):
        pool.put_prefix((1, 2), lane, 2)
    pool.put_prefix((1, 2, 3, 4), lane, 4)
    key, page = pool.match([1, 2, 3, 4, 5], 4)
    out.append((key, page.length, pool.match([1, 2, 3, 4], 3)[0],
                pool.match([9], 1)))
    pool.acquire_prefix((1, 2, 3, 4), 0)
    out.append((pool.evict_prefix((1, 2, 3, 4)), pool.store_version))
    with pytest.raises(RuntimeError, match="live page"):
        pool.evict_prefix((1, 2, 3, 4), force=True)
    pool.put_prefix((7,), lane, 1)           # past max_pages: LRU
    out.append(sorted(pool.prefix_stats().items()))
    pool.free(0)
    out.append((pool.evict_lru(), pool.evict_prefix((1, 2, 3, 4)),
                pool.has_prefix((7,)), pool.get_prefix((5,)),
                pool.store_version))
    with pytest.raises(ValueError, match="below zero"):
        pool.release_prefix((7,))
    out.append((pool.lane_bytes(), pool.pool_bytes()))
    return out


def test_kv_pool_matches_jax(tiny):
    _, jmake = jax_gpt2_decoder(JaxGPT2(tiny["jcfg"]))
    _, tmake = gpt2_decoder(tiny["model"])
    jpool = JaxKVPool(jmake, max_slots=2, max_len=8, max_pages=2)
    tpool = KVPool(tmake, max_slots=2, max_len=8, max_pages=2)
    assert _pool_script(tpool, tpool.zeros_lane) == \
        _pool_script(jpool, jpool.zeros_lane)
    leaf = tpool.cache["layer0"]["k"]
    assert leaf.shape == (2, 4, 8, 32) and leaf.device.type == "cpu"
    with pytest.raises(ValueError, match="max_slots"):
        KVPool(tmake, max_slots=0, max_len=8)
