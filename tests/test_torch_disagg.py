"""Disaggregated prefill/decode serving (`serving.disagg`) and the fleet
simulator (`testing.fleetsim`) of the port against the JAX package on
the CPU (the cases of tests/test_disagg.py that need no autopilot; the
pool-ratio policy cases wait for the autopilot's port, ROADMAP.md queue
A item 11).

- kv_transfer: extract / verify / install round trip, with departure
  manifest entries equal to JAX's (paths, shapes, dtypes, sha256); a
  missing page and a corrupt page are typed `HandoffError`s; install
  verifies before touching the pool; a paged pool's page moves too;
- the frontend: handoff parity with solo runs, a radix hit that skips
  the prefill pool, a corrupt handoff and a handoff-window kill
  re-routed, a handoff latency window — results and banked transition
  events equal JAX's;
- fleetsim: trace fingerprints (the JAX corpus's banked ones),
  unified, disaggregated and kill-k-of-n episodes whose outcomes and
  transitions equal JAX's, and the unified-vs-disaggregated TTFT drill.
"""

import numpy as np
import pytest
import torch

import apex1_tpu.serving as jsv
import apex1_tpu.serving.disagg as jdis
import apex1_tpu.testing.chaos as jchaos
import apex1_tpu.testing.fleetsim as jfs
import apex1_tpu_torch.serving as tsv
import apex1_tpu_torch.serving.disagg as tdis
import apex1_tpu_torch.testing.chaos as tchaos
import apex1_tpu_torch.testing.fleetsim as tfs

ECFG = dict(max_slots=3, max_len=48, prefill_chunk=4, vocab_size=61,
            temperature=0.8, seed=7)
JTOY = jchaos.toy_decoder()
TTOY = tchaos.toy_decoder(device="cpu")


def _engine(kind, **kw):
    if kind == "jax":
        apply_fn, make_cache, params = JTOY
        return jsv.Engine(apply_fn, make_cache, params,
                          jsv.EngineConfig(**{**ECFG, **kw}))
    apply_fn, make_cache = TTOY
    return tsv.Engine(apply_fn, make_cache,
                      tsv.EngineConfig(**{**ECFG, "paged": False, **kw}),
                      device="cpu")


def _front(kind, fault=None, **dkw):
    sv, dis = (jsv, jdis) if kind == "jax" else (tsv, tdis)
    pool = dict(n_replicas=1, capacity_per_replica=8, hedge_after_s=None)
    return dis.DisaggFrontend(
        lambda: _engine(kind),
        dis.DisaggConfig(prefill=sv.FrontendConfig(**pool),
                         decode=sv.FrontendConfig(**pool),
                         prefill_chunk=ECFG["prefill_chunk"], **dkw),
        fault=fault)


def _solo_parity(kind, front, prompts, rids):
    ref = _engine(kind)
    for p, rid in zip(prompts, rids):
        res = front.poll(rid)
        assert res is not None and res.status == "done", (rid, res)
        sub = front._subs[rid]
        rr = ref.submit(p, max_new_tokens=sub.max_new_tokens, seed=sub.seed)
        ref.run(max_steps=300)
        assert [int(t) for t in res.tokens] == \
            [int(t) for t in ref.results[rr].tokens]


def _observe(front, rids):
    res = {r: (front.poll(r).status, front.poll(r).reason,
               [int(t) for t in front.poll(r).tokens]) for r in rids}
    events = [{k: v for k, v in t.items() if k not in ("t", "error")}
              for t in front.metrics.transitions]
    return res, events, front.summary()["counters"]


# ---- kv_transfer -----------------------------------------------------------


def _served(kind, **kw):
    """An engine that served one 9-token prompt: its chunk-aligned
    8-token prefix page sits in the radix store."""
    eng = _engine(kind, **kw)
    prompt = np.random.default_rng(3).integers(0, 61, (9,)).astype(np.int32)
    eng.submit(prompt, max_new_tokens=4, seed=11)
    eng.run(max_steps=100)
    return eng, tuple(int(t) for t in prompt[:8])


def test_extract_verify_install_roundtrip_entries_equal_jax():
    jeng, key = _served("jax")
    eng, _ = _served("torch")
    want = jdis.extract_page(jeng, key)
    moved = tdis.extract_page(eng, key)
    assert (moved.key, moved.length) == (want.key, want.length) == (key, 8)
    assert moved.entries == want.entries
    assert moved.nbytes() == want.nbytes() > 0
    tdis.verify_page(moved)
    dst = _engine("torch")
    assert tdis.install_page(dst, moved) is True
    assert dst.kv.has_prefix(key)
    assert tdis.install_page(dst, moved) is False
    # the wire copy does not alias the source pool
    moved.lane["toy"]["h"].zero_()
    assert eng.kv.get_prefix(key).lane["toy"]["h"].abs().sum() > 0


def test_missing_and_corrupt_pages_are_typed():
    eng, key = _served("torch")
    with pytest.raises(tdis.HandoffError, match="not in the source"):
        tdis.extract_page(eng, key[:4])
    page = tdis.extract_page(eng, key)
    tchaos.HandoffCorruption(at_handoff=0).on_handoff(0, 1, page)
    with pytest.raises(tdis.HandoffError, match="sha256"):
        tdis.verify_page(page)
    page = tdis.extract_page(eng, key)
    page.entries[0]["sha256"] = "0" * 64
    dst = _engine("torch")
    with pytest.raises(tdis.HandoffError):
        tdis.install_page(dst, page)
    assert not dst.kv.has_prefix(key)


def test_paged_pool_page_moves_and_serves():
    """A paged pool's prefix (whole pages) moves into freshly taken pages
    of another paged pool, and a request that hits it there decodes the
    stream the source engine decodes (a tiny GPT-2: the toy decoder is
    dense-only)."""
    from apex1_tpu_torch import GPT2, GPT2Config, get_policy, gpt2_decoder
    model = GPT2(GPT2Config.tiny(policy=get_policy("O0"), max_seq_len=64),
                 device="cpu")
    apply_fn, make_cache = gpt2_decoder(model)
    cfg = tsv.EngineConfig(max_slots=2, max_len=48, prefill_chunk=8,
                           page_size=8, temperature=0.7, vocab_size=256)

    def make():
        return tsv.Engine(apply_fn, make_cache, cfg, device="cpu")

    src, dst = make(), make()
    prompt = np.random.default_rng(5).integers(1, 256, (21,))
    rid = src.submit(prompt, max_new_tokens=6, seed=3)
    src.run(max_steps=60)
    key = tuple(int(t) for t in prompt[:16])
    page = tdis.extract_page(src, key)
    assert page.length == 16 and page.lane["layer0"]["k"].shape[0] == 2
    free = dst.kv.n_free_pages
    assert tdis.install_page(dst, page) is True
    assert dst.kv.n_free_pages == free - 2
    rid2 = dst.submit(prompt, max_new_tokens=6, seed=3)
    dst.run(max_steps=60)
    assert dst.metrics.records[rid2].prefix_saved == 16
    assert (dst.results[rid2].tokens == src.results[rid].tokens).all()


# ---- the disaggregated frontend --------------------------------------------


def _parity_and_hit(kind):
    rng = np.random.default_rng(0)
    lens = (3, 5, 9, 7, 6)
    prompts = [rng.integers(0, 61, (n,)).astype(np.int32) for n in lens]
    front = _front(kind)
    rids = [front.submit(p, max_new_tokens=6 + i % 4, req_id=10 + i)
            for i, p in enumerate(prompts)]
    front.run_until_drained(timeout_s=60.0)
    _solo_parity(kind, front, prompts, rids)
    s = front.summary()
    handoffs = [t for t in front.metrics.transitions
                if t["event"] == "handoff"]
    assert len(handoffs) == len(lens) - 1
    assert s["counters"]["handoff_failures"] == 0
    assert rids[0] not in front.prefill.metrics.records
    w = s["window"]["per_class"]["best_effort"]
    assert "ttft_p99_ms" in w and "tpot_p99_ms" in w
    rid2 = front.submit(prompts[1], max_new_tokens=8, req_id=20)
    front.run_until_drained(timeout_s=60.0)
    assert rid2 not in front.prefill.metrics.records
    _solo_parity(kind, front, [prompts[1]], [rid2])
    eng = front.decode.replicas[0].engine
    assert eng.metrics.get_counter("prefix_hits") >= 1
    return _observe(front, rids + [rid2])


def _fault_case(kind, which):
    chaos = jchaos if kind == "jax" else tchaos
    fault, n, seed, kw = {
        "corrupt": (chaos.HandoffCorruption(at_handoff=0), 9, 1, {}),
        "window_kill": (chaos.HandoffWindowKill(at_handoff=0), 7, 2, {}),
        "latency": (None, 9, 4, dict(handoff_latency_s=0.05)),
    }[which]
    front = _front(kind, fault=fault, **kw)
    p = np.random.default_rng(seed).integers(0, 61, (n,)).astype(np.int32)
    rid = front.submit(p, max_new_tokens=7, req_id=30)
    front.run_until_drained(timeout_s=60.0)
    _solo_parity(kind, front, [p], [rid])
    c = front.summary()["counters"]
    if fault is not None:
        assert fault.fired == 1
        assert c["handoff_failures"] == 1 and c["handoff_reroutes"] == 1
        fails = [t for t in front.metrics.transitions
                 if t["event"] == "handoff_failure"]
        assert fails[0]["failure"] == {"corrupt": "integrity"}.get(
            which, which)
    if which == "window_kill":
        front.prefill.pump(1)
        assert front.prefill.replica_states() == ["alive"]
    out = _observe(front, [rid])
    # a failure's reason names the leaf digests or the kill: same text
    return out


def test_handoff_parity_and_hit_skips_prefill_equal_jax():
    assert _parity_and_hit("torch") == _parity_and_hit("jax")


@pytest.mark.parametrize("which", ["corrupt", "window_kill", "latency"])
def test_handoff_faults_equal_jax(which):
    got, want = _fault_case("torch", which), _fault_case("jax", which)
    # the digests in an integrity failure's reason are of each package's
    # bytes; the rest of every event is equal
    strip = [[{k: v for k, v in e.items() if k != "reason"} for e in o[1]]
             for o in (got, want)]
    assert got[0] == want[0] and got[2] == want[2]
    assert strip[0] == strip[1]


# ---- fleetsim --------------------------------------------------------------


def test_trace_fingerprints_equal_jax_and_banked():
    assert tfs.synthetic_trace("bursty", seed=20260804, horizon_s=6.0,
                               base_rate=25.0).fingerprint() \
        == "2981efa90ab97ccf"
    assert tfs.synthetic_trace("diurnal", seed=20260804, horizon_s=6.0,
                               base_rate=25.0).fingerprint() \
        == "d62120db0aafb066"
    for kind in tfs.TRACE_KINDS:
        a = tfs.synthetic_trace(kind, seed=11, horizon_s=2.0,
                                base_rate=12.0)
        b = jfs.synthetic_trace(kind, seed=11, horizon_s=2.0,
                                base_rate=12.0)
        assert a.fingerprint() == b.fingerprint()
    cfg = tfs.FleetSimConfig()
    assert (cfg.disagg, cfg.handoff_latency_s,
            cfg.prefill_round_cost) == (False, 0.0, False)


def test_trace_save_load_roundtrip(tmp_path):
    t = tfs.synthetic_trace("steady", seed=3, horizon_s=1.0, base_rate=8.0)
    back = tfs.Trace.load(t.save(str(tmp_path / "t.jsonl")))
    assert back.fingerprint() == t.fingerprint()


def _episode(fs, sv, chaos=None, **sim):
    trace = fs.synthetic_trace("adversarial_long_prompt", seed=13,
                               horizon_s=1.5, base_rate=10.0,
                               prompt_lens=(2, 4))
    fcfg = sv.FrontendConfig(n_replicas=2, capacity_per_replica=8,
                             hedge_after_s=None)
    kw = dict(device="cpu") if fs is tfs else {}
    rep = fs.run_fleet(trace, fcfg, sim=fs.FleetSimConfig(max_len=64, **sim),
                       chaos=chaos, **kw)
    return rep


@pytest.mark.parametrize("sim", [
    dict(), dict(disagg=True, prefill_replicas=1, prefill_round_cost=True),
    dict(num_draft=2), dict(cache_dtype="int8")],
    ids=["unified", "disagg", "spec", "int8"])
def test_episode_equals_jax(sim):
    import jax.numpy as jnp
    jsim, tsim = dict(sim), dict(sim)
    if sim.get("cache_dtype"):
        jsim["cache_dtype"], tsim["cache_dtype"] = jnp.int8, torch.int8
    got = _episode(tfs, tsv, **tsim)
    want = _episode(jfs, jsv, **jsim)
    assert got.outcomes == want.outcomes
    assert got.transitions == want.transitions
    assert got.rejected == want.rejected and got.rounds == want.rounds
    assert got.fingerprint() == want.fingerprint()
    assert all(o["status"] != "lost" for o in got.outcomes)
    if sim.get("disagg"):
        c = got.summary["counters"]
        assert c["handoffs"] > 0 and c["handoff_failures"] == 0
    if sim.get("num_draft"):
        assert got.to_json()["accept_rate"] == want.to_json()["accept_rate"]


def test_kill_k_of_n_episode_equals_jax():
    a = tfs.kill_k_of_n(7, n_replicas=3, k=1, lo=2, hi=6)
    b = jfs.kill_k_of_n(7, n_replicas=3, k=1, lo=2, hi=6)
    assert [(f.replica, f.at_step, f.repeat) for f in a.faults] == \
        [(f.replica, f.at_step, f.repeat) for f in b.faults]
    got = _episode(tfs, tsv, chaos=a)
    want = _episode(jfs, jsv, chaos=b)
    assert got.fingerprint() == want.fingerprint()
    assert any(t["event"] == "failover" for t in got.transitions)
    with pytest.raises(ValueError, match="0 < k"):
        tfs.kill_k_of_n(7, n_replicas=3, k=3, lo=2, hi=6)
    with pytest.raises(NotImplementedError, match="item 11"):
        tfs.FleetSim(tfs.synthetic_trace("steady", seed=1, horizon_s=0.1),
                     tsv.FrontendConfig(), autopilot=object(),
                     device="cpu")


def test_headline_disagg_holds_ttft_where_unified_fails():
    """Same total replicas, the adversarial long-prompt trace, the
    honest prefill round cost: unified blows the guaranteed-class TTFT
    bound, the split fleet holds it, and every request both fleets
    finished carries the same tokens."""
    trace = tfs.synthetic_trace(
        "adversarial_long_prompt", seed=20260807, horizon_s=4.0,
        base_rate=25.0, prompt_lens=(2, 4), long_prompt_lens=(18, 30),
        class_mix={"guaranteed": 0.4, "best_effort": 0.35,
                   "sheddable": 0.25})
    fcfg = tsv.FrontendConfig(n_replicas=3, capacity_per_replica=8,
                              hedge_after_s=None)
    uni = tfs.run_fleet(trace, fcfg, sim=tfs.FleetSimConfig(
        prefill_round_cost=True, max_len=64), device="cpu")
    dis = tfs.run_fleet(trace, fcfg, sim=tfs.FleetSimConfig(
        disagg=True, prefill_replicas=1, prefill_round_cost=True,
        max_len=64), device="cpu")
    assert uni.ttft_attainment("guaranteed", 0.12) <= 0.97
    assert dis.ttft_attainment("guaranteed", 0.12) >= 0.99
    assert dis.summary["counters"]["handoffs"] > 0
    sha = {o["idx"]: o["tokens_sha1"] for o in uni.outcomes
           if o["status"] == "done"}
    common = [o for o in dis.outcomes
              if o["status"] == "done" and o["idx"] in sha]
    assert len(common) >= 20
    assert all(o["tokens_sha1"] == sha[o["idx"]] for o in common)
