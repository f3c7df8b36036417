"""The port's planner pricing and search against the JAX package, on the
CPU.

- `core.capability`: the h100 row's fields, detection from a patched
  device name and capability, h100 off the card, an unknown card
  refused, `require`'s features;
- `perf_model`: with rows built from the JAX package's ``v5e`` and
  ``v5p`` rows injected into the port's table (here only, carrying its
  per-neighbour ICI rate and its 256 MiB reserve), every function equals
  JAX's to 1e-12 relative on JAX's own cases (tests/test_planner.py:
  375-463), the binding side's name mapped (tensor/HBM/link against
  MXU/HBM/ICI); the flash backward's 4.5x counted from the port's two
  backward kernels;
- `obs.calibrate`: at the injected v5e row on the JAX package's
  ``perf_results/`` the fit equals JAX's; with the port's own results
  directory every price is ``uncalibrated`` although
  ``perf_results/calibration.json`` exists; the v5e table is refused at
  h100;
- `planner.make_plan` against JAX's for `BANKED_SHAPES`, the tiny shape
  and the bench's ``llama_3d`` shape at 1-16 devices, ZeRO allowed and
  not: the same pick, ranked_top, memory and provenance, floats within
  1e-12 relative, the same `PlanError` texts; JAX's memory and pricing
  tests (tests/test_planner.py:128-253) as cases of one parametrised
  test;
- `planner.emit`: `plan_param_specs` reproducing `models.llama_3d`'s
  spec tables (dense and MoE, global and local names), a plan the JAX
  package saved driving `llama3d_config_from_plan`, ``plan_json``
  byte-identical, a zero plan refused, the reshard module's schema keys;
- the CLI and ``examples/llama_3d.py --plan PATH`` of another model's
  plan (exit 2 naming each dim).
"""

import dataclasses
import json
import math
import os

import numpy as np
import pytest

from apex1_tpu import perf_model as jax_pm
from apex1_tpu import planner as jplanner
from apex1_tpu.core import capability as jax_cap
from apex1_tpu.obs import calibrate as jax_cal
from apex1_tpu.planner import memory as jax_memory
from apex1_tpu_torch import perf_model as pm
from apex1_tpu_torch import planner
from apex1_tpu_torch.core import capability as cap
from apex1_tpu_torch.examples import llama_3d
from apex1_tpu_torch.obs import calibrate as cal
from apex1_tpu_torch.planner import emit
from apex1_tpu_torch.planner.__main__ import TINY
from apex1_tpu_torch.planner.__main__ import main as planner_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_RESULTS = os.path.join(REPO, "perf_results")
NO_TABLE = os.path.join(REPO, "no-such-results")
BOUND = {"tensor": "MXU", "HBM": "HBM", "link": "ICI"}

#: the bench's llama_3d shape (`bench.py`'s ``llama_3d``: the 0.8B
#: Llama at S 2048, 8 layers, global batch 4)
L3D = planner.ModelShape(
    name="llama_3d", num_layers=8, hidden_size=2048, ffn_size=5632,
    num_heads=32, num_kv_heads=4, head_dim=64, vocab_size=32000,
    seq_len=2048, global_batch=4)
SHAPES = {**planner.BANKED_SHAPES, "tiny": TINY, "llama_3d": L3D}


def _row(gen):
    """The port's row carrying the JAX package's ``gen`` figures."""
    j = jax_cap.get_capability(gen)
    return cap.GpuCapability(
        generation=gen, device_name=f"TPU {gen}", compute_capability=(0, 0),
        sms=j.cores_per_chip, smem_sm_bytes=j.vmem_bytes,
        smem_block_bytes=j.vmem_bytes // 2, hbm_bytes=j.hbm_bytes,
        hbm_gbps=j.hbm_gbps, bf16_tflops=j.bf16_tflops, fp32_tflops=0.0,
        link_gbps=jax_cap.ici_link_gbps(gen),
        hbm_reserve_bytes=jax_memory.HBM_RESERVE_BYTES,
        features=("fp8",) if j.native_fp8 else (), platform="tpu")


@pytest.fixture
def tpu_rows(monkeypatch):
    for gen in ("v5e", "v5p"):
        monkeypatch.setitem(cap._TABLE, gen, _row(gen))


def _close(got, want, path="$"):
    """``got`` equals ``want`` with floats within 1e-12 relative and the
    port's binding-side names mapped to the JAX package's."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            (path, sorted(got), sorted(want))
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert math.isclose(got, want, rel_tol=1e-12, abs_tol=0.0) \
            or got == want, (path, got, want)
    elif isinstance(got, str) and got in BOUND:
        assert BOUND[got] == want, (path, got, want)
    else:
        assert got == want, (path, got, want)


def _both(fn_port, fn_jax):
    """Each side's result, or ``("raises", type name, message)``."""
    out = []
    for fn in (fn_port, fn_jax):
        try:
            out.append(fn())
        except (jplanner.PlanError, planner.PlanError, ValueError) as e:
            out.append(("raises", type(e).__name__, str(e)))
    return out


# ---------------------------------------------------------------------------
# capability


def test_h100_row_is_the_data_sheet():
    row = cap.get_capability("h100")
    assert (row.compute_capability, row.sms) == ((9, 0), 132)
    assert (row.smem_sm_bytes, row.smem_block_bytes) == (228 * 1024,
                                                         227 * 1024)
    assert row.hbm_bytes == 80 * 2 ** 30 and row.hbm_gbps == 3350.0
    assert (row.bf16_tflops, row.fp32_tflops) == (989.0, 67.0)
    assert row.link_gbps == 450.0 and row.features == ("fp8",)
    assert row.hbm_reserve_bytes == cap.H100_HBM_RESERVE > 0
    assert cap.smem_budget("h100") == 227 * 1024
    assert cap.link_gbps("h100") == 450.0
    # the card's peaks chip_smoke.py bounds every kernel with
    assert (row.hbm_gbps * 1e9, row.fp32_tflops * 1e12,
            row.bf16_tflops * 1e12) == (3.35e12, 67e12, 989e12)


def _card(monkeypatch, name, cc):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: name)
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda i=0: cc)


def test_detection_from_the_device_name(monkeypatch):
    assert cap.detect_generation() is None          # no card here
    assert cap.get_capability().generation == "h100"
    _card(monkeypatch, "NVIDIA H100 80GB HBM3", (9, 0))
    assert cap.detect_generation() == "h100"
    assert cap.get_capability() is cap.get_capability("h100")
    _card(monkeypatch, "NVIDIA A100-SXM4-80GB", (8, 0))
    with pytest.raises(ValueError, match=r"A100.*known: \['h100'\]"):
        cap.get_capability()
    with pytest.raises(ValueError, match=r"unknown GPU generation 'v5e'"):
        cap.get_capability("v5e")


def test_require_keeps_the_feature_names():
    cap.require("fp8")
    for feature in ("sparsecore", "ici_3d", "megacore"):
        with pytest.raises(cap.CapabilityError, match="NVIDIA H100"):
            cap.require(feature)
    with pytest.raises(ValueError, match="unknown feature"):
        cap.require("tensor_memory")


# ---------------------------------------------------------------------------
# perf_model


def test_flash_backward_counts_the_ports_two_kernels():
    """The 4.5x of `flash_flops_bytes`: the forward's 2 products plus
    the backward's, counted from the port's kernels: dq recomputes S and
    dP and takes dq (3 wgmma products), dk/dv recomputes S and dP and
    takes dv and dk (4)."""
    src = open(os.path.join(REPO, "apex1_tpu_torch", "csrc",
                            "flash_wg.cuh")).read()

    def products(kernel):
        body = src[src.index(kernel):]
        body = body[:body.index("\ntemplate <")]
        return body.count("wg::mma_ss<") + body.count("wg::mma_rs<")

    fwd, dq = products("flash_fwd_wg_kernel("), products(
        "flash_dq_wg_kernel(")
    dkv = products("flash_dkv_wg_kernel(")
    assert (fwd, dq, dkv) == (2, 3, 4)
    f, _ = pm.flash_flops_bytes(1, 2, 2, 64, 16, grad=True)
    f0, _ = pm.flash_flops_bytes(1, 2, 2, 64, 16)
    assert f == f0 * (fwd + dq + dkv) / fwd


def test_perf_model_equals_jax_at_the_tpu_rows(tpu_rows):
    for gen in ("v5e", "v5p"):
        row, jrow = cap.get_capability(gen), jax_cap.get_capability(gen)
        for flops, nbytes, exposed in (
                (row.bf16_tflops * 1e12, 1.0, 0.0),
                (1.0, row.hbm_gbps * 1e9, 0.0),
                (1.0, row.hbm_gbps * 1e9, 2 * row.link_gbps * 1e9),
                (3.1e12, 7.7e9, 1.3e8)):
            _close(list(pm.roofline(flops, nbytes, row, exposed)),
                   list(jax_pm.roofline(flops, nbytes, jrow, exposed)))
        for n in (2, 4, 8):
            _close(pm.ring_attention_comms(gen, n),
                   jax_pm.ring_attention_comms(gen, n))
            _close(pm.ring_attention_comms(gen, n, B=2, Hq=8, Hkv=2,
                                           S=4096, D=128),
                   jax_pm.ring_attention_comms(gen, n, B=2, Hq=8, Hkv=2,
                                               S=4096, D=128))
            _close(pm.sp_boundary_comms(gen, n, rows=8192, out_width=4096,
                                        ffn=14336),
                   jax_pm.sp_boundary_comms(gen, n, rows=8192,
                                            out_width=4096, ffn=14336))
            kw = dict(rows=1024, local_k=4096, out_width=1536 // n,
                      acc_bytes=2, hop_width=4096)
            _close(pm.sp_boundary_comms(gen, n, **kw),
                   jax_pm.sp_boundary_comms(gen, n, **kw))
    _close(pm.kernel_cases(), jax_pm.kernel_cases())
    for args in ((16, 12, 12, 1024, 64), (1, 32, 4, 16384, 64)):
        for kw in (dict(), dict(grad=True), dict(causal=False)):
            assert pm.flash_flops_bytes(*args, **kw) == \
                jax_pm.flash_flops_bytes(*args, **kw)
    assert pm.elemwise_flops_bytes(99, 4, 2, 8) == \
        jax_pm.elemwise_flops_bytes(99, 4, 2, 8)
    assert pm.linear_xent_flops(16368, 768, 50432) == \
        jax_pm.linear_xent_flops(16368, 768, 50432)
    for nb, n in ((100.0, 1), (100.0, 4), (3e9, 8)):
        assert pm.allreduce_bytes(nb, n) == jax_pm.allreduce_bytes(nb, n)
    kv = (32, 8, 128, 4096, 4, 2)
    assert pm.kv_cache_bytes(*kv) == jax_pm.kv_cache_bytes(*kv)
    assert pm.serving_capacity(40e9, 32, 8, 128, 4096, 1) == \
        jax_pm.serving_capacity(40e9, 32, 8, 128, 4096, 1)
    for r, k in ((0.0, 1), (0.7, 4), (1.0, 8)):
        assert pm.speculative_speedup(r, k, 1.2, 0.05) == \
            jax_pm.speculative_speedup(r, k, 1.2, 0.05)
    for bad in ((1.5, 2), (0.5, 0)):
        _a, _b = _both(lambda: pm.speculative_speedup(*bad),
                       lambda: jax_pm.speculative_speedup(*bad))
        assert _a == _b
    # the H100 prices link bytes at its own per-peer rate
    t, bound, _ = pm.roofline(1.0, 1.0, cap.get_capability("h100"),
                              450e9 * 2)
    assert bound == "link" and t == pytest.approx(2.0)


# ---------------------------------------------------------------------------
# calibrate


def test_calibration_fit_equals_jax_on_its_results(tpu_rows):
    got = cal.build_calibration(JAX_RESULTS, "v5e")
    want = jax_cal.build_calibration(JAX_RESULTS, "v5e")
    for k in ("factors", "proxy_factors", "excluded", "n_pairs",
              "prediction_table", "generation", "pairs", "schema"):
        assert got[k] == want[k], k
    assert got["n_pairs"] > 0 and got["factors"]
    for config in ("gpt2", "llama_block", "no-such"):
        assert cal.step_slowdown(config, JAX_RESULTS, "v5e") == \
            jax_cal.step_slowdown(config, JAX_RESULTS)
    assert cal.roofline_ms(3e12, 1e9, "v5e") == \
        jax_cal.roofline_ms(3e12, 1e9, "v5e")


def test_no_tpu_factor_reaches_an_h100_price(tpu_rows):
    assert os.path.exists(os.path.join(JAX_RESULTS, "calibration.json"))
    assert cal.default_results_dir() != JAX_RESULTS
    shape, lay = planner.BANKED_SHAPES["gpt2"], planner.Layout(
        num_microbatches=16)
    p = planner.price_layout(shape, lay)
    assert p["generation"] == "h100"
    assert p["calibration"] == dict(
        slowdown=1.0, source="uncalibrated (no banked calibration.json)")
    assert p["calibrated_step_ms"] == p["step_ms"]
    # the JAX package's v5e table, passed explicitly, is refused at h100
    p = planner.price_layout(shape, lay, results_dir=JAX_RESULTS)
    assert p["calibration"] == dict(
        slowdown=1.0, source="uncalibrated (table is for v5e)")
    assert cal.step_slowdown("gpt2", JAX_RESULTS, "h100") is None
    assert cal.kernel_slowdown("fused_collective_matmul", JAX_RESULTS,
                               "h100") is None
    # and at v5p, a TPU row it was not fitted for either
    q = planner.price_layout(shape, lay, results_dir=JAX_RESULTS,
                             generation="v5p")
    assert q["calibration"] == dict(
        slowdown=1.0, source="uncalibrated (table is for v5e)")
    plan = planner.make_plan(shape, 1, results_dir=JAX_RESULTS)
    assert plan["provenance"] == {
        "calibration_table": None,
        "calibration_refused": "calibration.json: table is for v5e"}
    assert plan["predicted"]["calibrated_step_ms"] == \
        plan["predicted"]["step_ms"]


def test_calibrate_cli_writes_the_ports_schema(tmp_path, tpu_rows):
    out = tmp_path / "calibration.json"
    assert cal.main(["--results", JAX_RESULTS, "--generation", "v5e",
                     "--out", str(out)]) == 0
    doc = cal.load_calibration(path=str(out))
    assert doc["schema"] == jax_cal.SCHEMA and doc["generation"] == "v5e"
    assert doc["factors"] == jax_cal.build_calibration(
        JAX_RESULTS, "v5e")["factors"]
    assert cal.main(["--results", str(tmp_path / "none"), "--dry-run"]) == 0


# ---------------------------------------------------------------------------
# make_plan against the JAX package


def _results(gen):
    """The results directory both packages price ``gen`` with: the JAX
    package's table is fitted for v5e, which the port refuses at any
    other generation (`test_no_tpu_factor_reaches_an_h100_price`), so
    v5p prices on both sides without a table."""
    return JAX_RESULTS if gen == "v5e" else NO_TABLE


def _port_plan_vs_jax(name, n, gen, allow_zero):
    shape, jshape = SHAPES[name], jplanner.ModelShape(
        **dataclasses.asdict(SHAPES[name]))
    return _both(
        lambda: planner.make_plan(shape, n, generation=gen,
                                  results_dir=_results(gen),
                                  allow_zero=allow_zero),
        lambda: jplanner.make_plan(jshape, n, generation=gen,
                                   results_dir=_results(gen),
                                   allow_zero=allow_zero))


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_make_plan_equals_jax(name, tpu_rows):
    picks = 0
    for gen in ("v5e", "v5p"):
        for n in (1, 2, 4, 8, 16):
            for allow_zero in (True, False):
                got, want = _port_plan_vs_jax(name, n, gen, allow_zero)
                if isinstance(want, tuple):
                    assert got == want, (name, n, gen)
                    continue
                picks += 1
                _close(got, want)
                # the serialisation is the JAX package's for equal plans
                bound = got["predicted"]["bound"]
                assert emit.plan_json(dict(got, predicted=dict(
                    got["predicted"], bound=BOUND[bound]))) == \
                    jplanner.plan_json(want)
    assert picks


def _jax_cases():
    s16 = planner.BANKED_SHAPES["llama_longctx"]
    s22 = dataclasses.replace(s16, num_layers=22)
    s8b = planner.BANKED_SHAPES["llama8b"]
    gpt2 = planner.BANKED_SHAPES["gpt2"]
    L = planner.Layout
    return {
        # tests/test_planner.py:128-165
        "prefilter_verdicts": lambda P: (
            P.fit_check(s16, L(num_microbatches=1), "v5e"),
            P.fit_check(s22, L(num_microbatches=1), "v5e")),
        "over_budget_raises": lambda P: P.make_plan(s22, 1,
                                                    generation="v5e"),
        "zero_shards_opt": lambda P: (
            P.hbm_breakdown(s8b, L(dp=4, tp=4, num_microbatches=2),
                            "v5p"),
            P.hbm_breakdown(s8b, L(dp=4, tp=4, num_microbatches=2,
                                   zero=True), "v5p")),
        "8b_fits_v5p_not_v5e": lambda P: [
            P.fit_check(s8b, L(dp=2, pp=2, tp=4, num_microbatches=4), g)
            for g in ("v5p", "v5e")],
        # tests/test_planner.py:171-253
        "committed_table_factor": lambda P: [
            P.price_layout(gpt2, L(num_microbatches=16), generation="v5e",
                           results_dir=JAX_RESULTS, use_calibration=u)
            for u in (True, False)],
        # (JAX's is at v5p, where the port refuses the v5e table: here
        # at v5e, where both apply it)
        "fleet_geomean": lambda P: P.price_layout(
            s8b, L(dp=2, pp=2, tp=4, num_microbatches=4),
            generation="v5e", results_dir=JAX_RESULTS),
        "no_table_uncalibrated": lambda P: P.price_layout(
            gpt2, L(num_microbatches=16), generation="v5e",
            results_dir=NO_TABLE),
        "sp_modes": lambda P: [P.price_layout(
            s8b, L(dp=2, pp=2, tp=4, num_microbatches=4, sp_mode=m),
            generation="v5p", results_dir=_results("v5p"))
            for m in ("serial", "overlap", "fused")],
        "bubble_factor": lambda P: P.price_layout(
            s8b, L(dp=2, pp=2, tp=4, num_microbatches=4),
            generation="v5p", results_dir=_results("v5p"))["bubble_factor"],
        "hand_tuned_10pct": lambda P: [
            (P.price_layout(P.BANKED_SHAPES[nm], hand, generation=g,
                            results_dir=_results(g))["calibrated_step_ms"],
             P.make_plan(P.BANKED_SHAPES[nm], n, generation=g,
                         results_dir=_results(g))["predicted"]
             ["calibrated_step_ms"])
            for nm, n, g, hand in (
                ("gpt2", 1, "v5e", L(num_microbatches=16)),
                ("llama_longctx", 1, "v5e", L(num_microbatches=1)),
                ("llama8b", 16, "v5p",
                 L(dp=2, pp=2, tp=4, num_microbatches=4)))],
    }


@pytest.mark.parametrize("case", sorted(_jax_cases()))
def test_jax_planner_cases(case, tpu_rows):
    """JAX's memory and pricing tests on both packages: equal results
    (the port's layouts as JAX's), and JAX's own assertions on the
    port's."""
    fn = _jax_cases()[case]

    def jax_side():
        return fn(_JaxPlanner())

    got, want = _both(lambda: fn(planner), jax_side)
    _close(got, want)
    if case == "prefilter_verdicts":
        assert got[0] is None and "15.75" in got[1] and "hbm-fit" in got[1]
    elif case == "over_budget_raises":
        assert got[0] == "raises" and "hbm-fit" in got[2]
    elif case == "zero_shards_opt":
        assert got[1]["opt"] == pytest.approx(got[0]["opt"] / 4)
    elif case == "8b_fits_v5p_not_v5e":
        assert got[0] is None and got[1] is not None
    elif case == "committed_table_factor":
        doc = json.load(open(os.path.join(JAX_RESULTS, "calibration.json")))
        c, raw = got
        assert c["calibrated_step_ms"] / c["step_ms"] == pytest.approx(
            doc["factors"]["step:gpt2"]["slowdown"])
        assert raw["calibrated_step_ms"] == raw["step_ms"]
    elif case == "fleet_geomean":
        assert "fleet-geomean" in got["calibration"]["source"]
    elif case == "no_table_uncalibrated":
        assert got["calibration"]["slowdown"] == 1.0
    elif case == "sp_modes":
        assert got[0]["step_ms"] >= got[1]["step_ms"] <= got[2]["step_ms"]
    elif case == "bubble_factor":
        assert got == pytest.approx(5 / 4)
    elif case == "hand_tuned_10pct":
        assert all(pick <= 1.10 * hand for hand, pick in got)


class _JaxPlanner:
    """The JAX planner behind the port's names: layouts converted."""

    BANKED_SHAPES = jplanner.BANKED_SHAPES

    def __getattr__(self, name):
        fn = getattr(jplanner, name)

        def call(*args, **kw):
            args = [jplanner.Layout(**dataclasses.asdict(a))
                    if isinstance(a, planner.Layout) else
                    jplanner.ModelShape(**dataclasses.asdict(a))
                    if isinstance(a, planner.ModelShape) else a
                    for a in args]
            return fn(*args, **kw)
        return call


# ---------------------------------------------------------------------------
# emit


def _llama_cfg(moe):
    from apex1_tpu_torch import LlamaConfig, get_policy
    from apex1_tpu_torch.models import llama_3d as L3
    kw = dict(moe_every=1, num_experts=4, moe_top_k=2) if moe else {}
    mcfg = LlamaConfig.tiny(num_layers=2, max_seq_len=64,
                            policy=get_policy("O2"), **kw)
    return mcfg, L3.Llama3DConfig(model=mcfg, dp=2, pp=2, moe=moe,
                                  ep=2 if moe else 1, num_microbatches=4)


@pytest.mark.parametrize("moe", [False, True])
def test_partition_rules_reproduce_llama3d_specs(moe):
    from apex1_tpu_torch.models import llama_3d as L3
    mcfg, cfg = _llama_cfg(moe)
    shape = planner.ModelShape.from_llama(mcfg, global_batch=8, name="t")
    lay = planner.Layout(dp=2, pp=2, ep=2 if moe else 1, num_microbatches=4)
    plan = planner.build_plan(shape, lay, planner.price_layout(shape, lay),
                              planner.hbm_breakdown(shape, lay),
                              generation="h100", search={})
    tree = L3.global_state_template(cfg, device="meta")["params"]
    cs = L3.chunk_param_specs(cfg)
    want = {"chunk": {k: cs[k] for k in tree["chunk"]},
            "shared": L3.shared_param_specs()}
    assert planner.plan_param_specs(plan, tree) == want
    # the port's own flat names (`shard_params`'s) match the same rules
    flat = {f"{kind}.{k}": v for kind in tree for k, v in tree[kind].items()}
    got = planner.plan_param_specs(plan, flat)
    assert got == {f"{kind}.{k}": s for kind in want
                   for k, s in want[kind].items()}
    # the rules and their JSON form are the JAX planner's
    assert plan["partition_rules"] == json.loads(json.dumps(
        {"rules": jplanner.partition_rules(moe), "default": []}))


def test_jax_plan_file_drives_the_port(tmp_path):
    from apex1_tpu.core.policy import get_policy as jax_policy
    from apex1_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from apex1_tpu_torch import LlamaConfig, get_policy
    jshape = jplanner.ModelShape(**dataclasses.asdict(TINY))
    jplan = jplanner.make_plan(jshape, 8, allow_zero=False)
    path = str(tmp_path / "plan.json")
    jplanner.save_plan(jplan, path)
    plan = planner.load_plan(path)
    assert emit.plan_json(plan) == open(path).read()
    dims = dict(num_layers=TINY.num_layers, max_seq_len=TINY.seq_len,
                vocab_size=TINY.vocab_size, num_heads=TINY.num_heads,
                num_kv_heads=TINY.num_kv_heads,
                hidden_size=TINY.hidden_size, ffn_size=TINY.ffn_size)
    got = planner.llama3d_config_from_plan(
        plan, LlamaConfig.tiny(policy=get_policy("O2"), **dims))
    want = jplanner.llama3d_config_from_plan(
        jplan, JaxLlamaConfig.tiny(policy=jax_policy("O2"), **dims))
    for f in ("dp", "pp", "tp", "cp", "ep", "moe", "num_chunks",
              "num_microbatches", "microbatch_size", "learning_rate",
              "schedule"):
        assert getattr(got, f) == getattr(want, f), f
    assert planner.layout_from_plan(plan) == planner.Layout(
        **dataclasses.asdict(jplanner.layout_from_plan(jplan)))
    assert planner.model_shape_from_plan(plan) == TINY
    assert planner.check_plan_model(plan, TINY) == []
    other = dataclasses.replace(TINY, num_layers=4, num_experts=4)
    assert planner.check_plan_model(plan, other) == \
        jplanner.check_plan_model(jplan, jplanner.ModelShape(
            **dataclasses.asdict(other)))


def test_zero_plan_refused_and_the_plan_file_contract(tmp_path):
    from apex1_tpu_torch import LlamaConfig, get_policy
    from apex1_tpu_torch.resilience import reshard
    lay = planner.Layout(dp=2, pp=2, tp=2, num_microbatches=4, zero=True)
    plan = planner.build_plan(TINY, lay, planner.price_layout(TINY, lay),
                              planner.hbm_breakdown(TINY, lay),
                              generation="h100", search={})
    mcfg = LlamaConfig.tiny(num_layers=2, max_seq_len=64,
                            policy=get_policy("O2"))
    with pytest.raises(ValueError, match="zero"):
        planner.llama3d_config_from_plan(plan, mcfg)
    assert planner.llama3d_config_from_plan(plan, mcfg,
                                            ignore_zero=True).dp == 2
    a = planner.plan_json(planner.make_plan(TINY, 8))
    assert a == planner.plan_json(planner.make_plan(TINY, 8))
    assert a.endswith("\n")
    path = str(tmp_path / "plan.json")
    assert planner.load_plan(planner.save_plan(json.loads(a), path)) == \
        json.loads(a)
    (tmp_path / "bad.json").write_text('{"schema": "something-else"}')
    (tmp_path / "x.json").write_text("not json at all")
    for name in ("bad.json", "x.json", "missing.json"):
        with pytest.raises(ValueError):
            planner.load_plan(str(tmp_path / name))
    # the reshard module reads plans without the planner: the same keys
    assert (reshard.PLAN_SCHEMA, reshard.PLAN_SPEC_KEYS) == \
        (planner.PLAN_SCHEMA, planner.PLAN_SPEC_KEYS) == \
        (jplanner.PLAN_SCHEMA, jplanner.PLAN_SPEC_KEYS)
    assert reshard.plan_spec(plan) == jplanner.plan_spec(plan)
    assert emit.spec_from_json([None, "pp", ["dp", "ep"]]) == \
        (None, "pp", ("dp", "ep"))
    assert emit.spec_to_json((None, "pp", ("dp", "ep"))) == \
        [None, "pp", ["dp", "ep"]]


def test_plan_for_layout_is_priced_and_stated():
    lay = planner.Layout(dp=2, pp=2, tp=2, num_microbatches=4, num_chunks=2)
    shape = dataclasses.replace(TINY, num_layers=4)
    plan = planner.plan_for_layout(shape, lay)
    assert plan["search"]["stated"] and plan["n_devices"] == 8
    assert plan["predicted"]["step_ms"] > 0 and plan["memory"]["fits"]
    with pytest.raises(planner.PlanError, match=r"\[?tp-heads"):
        planner.plan_for_layout(shape, planner.Layout(tp=3))


def test_cli_writes_a_plan(tmp_path, capsys):
    out = str(tmp_path / "p.json")
    assert planner_main(["--model", "gpt2", "--devices", "1", "--out",
                         out]) == 0
    plan = planner.load_plan(out)
    assert plan["generation"] == "h100" and plan["n_devices"] == 1
    assert "pick: mesh" in capsys.readouterr().out


def test_llama_3d_replays_a_plan_and_refuses_another_models(tmp_path,
                                                            capsys):
    path = str(tmp_path / "gpt2.json")
    planner.save_plan(planner.make_plan(planner.BANKED_SHAPES["gpt2"], 1),
                      path)
    with pytest.raises(SystemExit) as exit_:
        llama_3d.main(["--plan", path, "--device", "cpu"])
    assert exit_.value.code == 2
    err = capsys.readouterr().err
    assert "plan/model mismatch" in err
    for dim in ("num_layers: plan=12 model=4", "hidden_size: plan=768",
                "vocab_size: plan=50432 model=256", "seq_len: plan=1024"):
        assert dim in err, dim
    # the example's own plan, replayed: the same losses bit for bit
    argv = ["--plan", "auto", "--layers", "2", "--steps", "2",
            "--device", "cpu"]
    auto = llama_3d.main(argv)
    planner.save_plan(auto["plan"], str(tmp_path / "own.json"))
    replay = llama_3d.main(["--plan", str(tmp_path / "own.json")]
                           + argv[2:])
    assert replay["plan_verified"] and replay["losses"] == auto["losses"]
    assert np.isfinite(auto["losses"]).all()
    with pytest.raises(SystemExit) as exit_:
        llama_3d.main(["--plan", str(tmp_path / "own.json"), "--devices",
                       "2"] + argv[2:])
    assert exit_.value.code == 2
    assert "n_devices: plan=1 devices=2" in capsys.readouterr().err
