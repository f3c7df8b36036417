"""Disaggregated-serving drill — toy decoder, 1+1 pools, a few seconds
(the port of ``python -m apex1_tpu.serving.disagg --smoke``):

(1) **Handoff parity**: every prompt long enough to produce a page
    routes prefill → manifest-verified handoff → decode, and finishes
    TOKEN-IDENTICAL to an uninterrupted single-engine run at
    temperature > 0 (the counter-keyed per-request seed, not greedy
    luck); zero handoff failures, every handoff banked.
(2) **Hit skips prefill**: resubmitting a served prompt never touches
    the prefill pool — the decode pool's radix index already holds the
    page, and the stream still matches solo generate.
(3) **Handoff-window kill**: a chaos fault kills the only prefill
    replica between prefill completion and handoff acknowledgment —
    the request re-routes (decode-pool re-prefill) and completes with
    parity; the typed failure and the re-route are counted; the
    supervisor restarts the replica. Never stranded.

Run: ``python -m apex1_tpu_torch.serving.disagg --smoke`` (on the card;
``--device cpu`` runs it on the CPU). The engines use the dense pool,
as the JAX drill's do.
"""

from __future__ import annotations

import sys

import numpy as np


def _smoke(device=None) -> int:
    from apex1_tpu_torch.serving import Engine, EngineConfig, FrontendConfig
    from apex1_tpu_torch.serving.disagg import DisaggConfig, DisaggFrontend
    from apex1_tpu_torch.testing.chaos import HandoffWindowKill, toy_decoder

    apply_fn, make_cache = toy_decoder(device=device)
    ecfg = EngineConfig(max_slots=3, max_len=48, prefill_chunk=4,
                        vocab_size=61, temperature=0.8, seed=7,
                        paged=False)

    def make_engine():
        return Engine(apply_fn, make_cache, ecfg, device=device)

    def make_front(fault=None):
        return DisaggFrontend(
            make_engine,
            DisaggConfig(
                prefill=FrontendConfig(n_replicas=1,
                                       capacity_per_replica=8,
                                       hedge_after_s=None),
                decode=FrontendConfig(n_replicas=1,
                                      capacity_per_replica=8,
                                      hedge_after_s=None),
                prefill_chunk=ecfg.prefill_chunk),
            fault=fault)

    def assert_parity(front, prompts, rids):
        ref = make_engine()
        for p, rid in zip(prompts, rids):
            res = front.poll(rid)
            assert res is not None and res.status == "done", (rid, res)
            sub = front._subs[rid]
            rr = ref.submit(p, max_new_tokens=sub.max_new_tokens,
                            seed=sub.seed)
            ref.run(max_steps=200)
            got, want = res.tokens, ref.results[rr].tokens
            assert np.array_equal(got, want), \
                f"req {rid}: {got} != solo {want}"

    rng = np.random.default_rng(0)
    # len 3 -> share point < chunk -> direct decode; the rest route
    # through the prefill pool and hand their page off
    lens = (3, 5, 9, 7, 6)
    prompts = [rng.integers(0, 61, (n,)).astype(np.int32)
               for n in lens]

    # (1) handoff parity ------------------------------------------------
    front = make_front()
    rids = [front.submit(p, max_new_tokens=6 + i % 4)
            for i, p in enumerate(prompts)]
    front.run_until_drained(timeout_s=60.0)
    assert_parity(front, prompts, rids)
    s = front.summary()
    handoffs = [t for t in front.metrics.transitions
                if t["event"] == "handoff"]
    assert len(handoffs) == len(lens) - 1, handoffs
    assert s["counters"]["handoff_failures"] == 0, s["counters"]
    assert s["counters"]["handoff_reroutes"] == 0, s["counters"]
    assert "handoff_parity_mismatches" not in s["counters"]
    assert rids[0] not in front.prefill.metrics.records  # short: direct
    w = s["window"]["per_class"]["best_effort"]
    assert "ttft_p99_ms" in w and "tpot_p99_ms" in w, w
    print(f"disagg smoke [1/3] OK: {len(handoffs)} manifest-verified "
          f"handoffs, all {len(lens)} streams token-identical to solo "
          f"generate @ T={ecfg.temperature}, per-phase TTFT/TPOT in "
          f"window, 0 handoff failures")

    # (2) full-prompt hit skips the prefill pool ------------------------
    p = prompts[1]
    rid2 = front.submit(p, max_new_tokens=8)
    front.run_until_drained(timeout_s=60.0)
    assert rid2 not in front.prefill.metrics.records, \
        "resubmission touched the prefill pool despite a radix hit"
    assert_parity(front, [p], [rid2])
    eng = front.decode.replicas[0].engine
    assert eng.metrics.get_counter("prefix_hits") >= 1
    print("disagg smoke [2/3] OK: full-prompt radix hit routed "
          "straight to the decode pool (prefill pool untouched), "
          "stream still solo-identical")

    # (3) handoff-window kill -> re-route, never strand -----------------
    kill = HandoffWindowKill(at_handoff=0)
    front = make_front(fault=kill)
    p = prompts[2]
    rid3 = front.submit(p, max_new_tokens=7)
    front.run_until_drained(timeout_s=60.0)
    assert kill.fired == 1, kill.fired
    assert_parity(front, [p], [rid3])
    c = front.summary()["counters"]
    assert c["handoff_failures"] == 1, c
    assert c["handoff_reroutes"] == 1, c
    fails = [t for t in front.metrics.transitions
             if t["event"] == "handoff_failure"]
    assert fails and fails[0]["failure"] == "window_kill", fails
    front.prefill.pump(1)                 # let the supervisor recover
    assert front.prefill.replica_states() == ["alive"], \
        front.prefill.replica_states()
    print("disagg smoke [3/3] OK: prefill replica killed in the "
          "handoff window -> typed failure banked, request re-routed "
          "and completed with solo parity, replica restarted")
    return 0


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m apex1_tpu_torch.serving.disagg",
        description="disaggregated prefill/decode serving drills")
    ap.add_argument("--smoke", action="store_true",
                    help="1+1 pool toy-decoder drill: handoff parity, "
                         "hit-skips-prefill, handoff-window kill")
    ap.add_argument("--device", default=None,
                    help="the engines' device (default: CUDA)")
    args = ap.parse_args(argv)
    if args.smoke:
        return _smoke(args.device)
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
