"""The port's tuning table and budget model against the JAX package's, on
the CPU.

- Table keys: `make_key`, `parse_key`, `canonical_dtype`, `padded_lanes`
  and `seq_bucket` equal JAX's for the same inputs, the generation
  passed explicitly; a table the port saves reads through JAX's file
  loader and key parser, and an entry JAX records for ``h100`` is served
  by the port's `lookup` (the same schema and grammar).
- The JAX package's committed ``perf_results/tuning/*.json`` (v5e,
  interpret-timed) miss on every entry through the port's `lookup`, and
  `validate_tables` names every entry foreign, none corrupt.
- With no table every launcher resolves today's heuristic, at every
  shape ``chip_smoke.py`` gives it: `quantized.int8_plan` = ``_tile`` +
  ``_split_k``, `paged_decode.sample_plan` = ``sample_splits``,
  ``paged_plan`` = ``paged_geometry``, `lora_epilogue.lora_plan` =
  ``lora_rows``, the GLU's and the chunk product's tile 0 (the
  library's own choice), the chunked losses' chunk the min(V, 8192)
  rule.
- A table is served (explicit > table > heuristic); entries that must
  miss do: misaligned, over the budget, a fixed-tile kernel, an unknown
  generation, a corrupt file; a CPU-timed entry is never served on the
  card (``detect_generation`` patched to the h100 row).
- The budget gate: every heuristic choice at every shape
  ``chip_smoke.py`` uses fits the h100 row under `vmem_model`, and the
  fixed-tile kernels' frames fit at their shapes; a frame past the
  budget fails.
- The registry keeps JAX's 15 names; the h100 row's register and thread
  limits; the changed C entry points' arity.
- The sweep's plumbing on the CPU (``--device cpu``): every spec's
  winner banked and served, ``--validate`` clean.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as cs
from apex1_tpu import tuning as jt
from apex1_tpu import vmem_model as jvm
from apex1_tpu.tuning import table as jtable
from apex1_tpu_torch import tuning, vmem_model
from apex1_tpu_torch.core import capability
from apex1_tpu_torch.ops import _build
from apex1_tpu_torch.ops import chunked_loss as cl
from apex1_tpu_torch.ops import fused_collective as fc
from apex1_tpu_torch.ops import fused_dense as fd
from apex1_tpu_torch.ops import lora_epilogue as le
from apex1_tpu_torch.ops import paged_decode as pd
from apex1_tpu_torch.ops import quantized as q
from apex1_tpu_torch.tuning import sweep
from apex1_tpu_torch.tuning import table as ptable
from apex1_tpu_torch.tuning.registry import SPECS

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "apex1_tpu_torch" / "csrc"
SMS = 132
BUDGET = capability.smem_budget("h100")


@pytest.fixture()
def tables_dir(tmp_path, monkeypatch):
    d = tmp_path / "tuning"
    monkeypatch.setenv("APEX1_TUNING_DIR", str(d))
    tuning.clear_cache()
    jt.clear_cache()
    yield d
    tuning.clear_cache()
    jt.clear_cache()


# ---- keys and the file format ---------------------------------------------

KEY_CASES = [({"Dp": 128, "Sb": 1024}, "bfloat16", "h100"),
             ({"Hp": 768}, "float32", "v5e"),
             ({"N": 5632, "K": 2048, "Tb": 8}, "int8", "h100"),
             ({"lanes": 50304}, np.float32, "h100")]


@pytest.mark.parametrize("dims,dtype,gen", KEY_CASES)
def test_keys_equal_jax(dims, dtype, gen):
    key = tuning.make_key(dims, dtype, gen)
    assert key == jt.make_key(dims, dtype, gen)
    assert tuning.parse_key(key) == jt.parse_key(key)


@pytest.mark.parametrize("dtype,torch_dtype", [
    ("bfloat16", torch.bfloat16), ("float32", torch.float32),
    ("float16", torch.float16), ("int8", torch.int8)])
def test_canonical_dtype_equals_jax(dtype, torch_dtype):
    assert tuning.canonical_dtype(dtype) == jt.canonical_dtype(dtype)
    assert tuning.canonical_dtype(torch_dtype) == jt.canonical_dtype(dtype)


@pytest.mark.parametrize("n", [1, 64, 127, 128, 129, 768, 769, 50257])
def test_padding_and_buckets_equal_jax(n):
    assert tuning.padded_lanes(n) == jt.padded_lanes(n)
    assert tuning.seq_bucket(n) == jt.seq_bucket(n)
    assert tuning.token_bucket(n) == max(8, 1 << (n - 1).bit_length())


def test_malformed_keys_raise_as_in_jax():
    for bad in ("h100|bfloat16", "h100|f32|Hp", "h100|f32|=3"):
        with pytest.raises(ValueError):
            tuning.parse_key(bad)
        with pytest.raises(ValueError):
            jt.parse_key(bad)


def test_port_table_reads_in_jax(tables_dir):
    dims = {"Hp": 768}
    key, _ = tuning.record("chunked_loss", dims, torch.bfloat16,
                           {"chunk_v": 4096}, time_ms=1.5)
    path = tuning.save("chunked_loss")
    entries = jtable._load_file(path, "chunked_loss")
    assert list(entries) == [key]
    assert jt.parse_key(key) == ("h100", "bfloat16", dims)
    doc = json.loads(Path(path).read_text())
    assert doc["schema"] == 1 and doc["kernel"] == "chunked_loss"
    assert entries[key]["timing"] == "cpu"


def test_jax_table_reads_in_the_port(tables_dir):
    jt.record("chunked_loss", {"Hp": 768}, "bfloat16", {"chunk_v": 4096},
              generation="h100", time_ms=2.0)
    jt.save("chunked_loss")
    tuning.clear_cache()
    assert tuning.lookup("chunked_loss", {"Hp": 768}, torch.bfloat16,
                         "h100") == {"chunk_v": 4096}
    assert tuning.validate_tables(str(tables_dir)) == []


def test_jax_committed_tables_miss_and_are_foreign(monkeypatch):
    d = REPO / "perf_results" / "tuning"
    monkeypatch.setenv("APEX1_TUNING_DIR", str(d))
    tuning.clear_cache()
    try:
        n = 0
        for f in sorted(d.glob("*.json")):
            for key in json.loads(f.read_text())["entries"]:
                gen, dt, dims = tuning.parse_key(key)
                assert tuning.lookup(f.stem, dims, dt, gen) is None
                assert tuning.lookup(f.stem, dims, dt) is None
                n += 1
        problems = tuning.validate_tables(str(d))
        assert n > 0 and len(problems) == n
        assert all("foreign" in p and "corrupt" not in p for p in problems)
        assert tuning.load_problems() == []
    finally:
        tuning.clear_cache()


# ---- no table: today's heuristics -----------------------------------------


def test_no_table_int8_plan_is_the_heuristic(tables_dir):
    for _case, T, N, K, _main in cs.INT8_CASES:
        assert q.int8_plan(T, N, K) == q._tile(T, N) + q._split_k(T, N, K)


def test_no_table_sampler_and_paged_plans_are_the_heuristics(tables_dir):
    for _case, R, V, _vs in cs.SAMPLE_CASES:
        assert pd.sample_plan(R, V, SMS) == pd.sample_splits(R, V, SMS)
    for _case, N, hq, hkv, S, pdt, D, P, T in cs.PAGED_CASES:
        assert pd.paged_plan(N, hq, hkv, S, D, P, T, pdt) == \
            pd.paged_geometry(N, hq, hkv, S, D, P, T)


def test_no_table_lora_glu_chunk_and_chunked_loss(tables_dir):
    for _case, slots, width, R, H, V, dts, _main in cs.LORA_CASES:
        n = slots * width
        assert le.lora_plan(n, H, V, R, dts, SMS) == le.lora_rows(n, V, R,
                                                                 SMS)
    for _case, T, H, F, dt, _act, _main in cs.GLU_CASES:
        assert fd.glu_tile_n(T, H, getattr(torch, dt)) == 0
    for _case, lead, K, N, dt, _main in cs.CHUNK_CASES:
        assert fc.chunk_plan(K, getattr(torch, dt)) == 0
    for V in (512, 50304, 32000):
        assert cl._auto_chunk(V, None, 768, torch.bfloat16) == min(
            -(-V // 128) * 128, 8192)


# ---- the table served, and entries that must miss -------------------------


def test_explicit_beats_table_beats_heuristic(tables_dir):
    T, N, K = 8, 5632, 2048
    tuning.record("int8_matmul", {"N": N, "K": K, "Tb": 8}, "int8",
                  dict(bm=64, bt=8, splits=1, kc=K))
    assert q.int8_plan(T, N, K) == (64, 8, 1, K)
    assert q.int8_plan(T, N, K, dict(bm=64, bt=16, splits=2, kc=1024)) == \
        (64, 16, 2, 1024)
    assert q.int8_plan(1024, N, K) == q._tile(1024, N) + q._split_k(
        1024, N, K)   # another token bucket: the heuristic
    tuning.record("fused_swiglu", {"Hp": 4096, "Tb": 8192}, "bfloat16",
                  {"tile_n": 128})
    assert fd.glu_tile_n(8192, 4096, torch.bfloat16) == 128
    assert fd.glu_tile_n(8192, 4096, torch.float16) == 0
    tuning.record("fused_collective_matmul", {"Kp": 2048}, "bfloat16",
                  {"block_m": 128, "block_n": 256})
    assert fc.chunk_plan(2048, torch.bfloat16) == 128256
    tuning.record("paged_decode", {"Dp": 64, "Rq": 1}, "bfloat16",
                  {"per": 4})
    assert pd.paged_plan(8, 12, 12, 1, 64, 64, 17, torch.bfloat16)[:2] == \
        (5, 4)
    tuning.record("fused_sample", {"Vp": 50304, "R": 8}, "float32",
                  {"splits": 16})
    assert pd.sample_plan(8, 50304, SMS) == pd._split(50304, 16)
    tuning.record("lora_epilogue", {"Hp": 2048, "Vp": 32000}, "bfloat16",
                  {"rows": 4})
    assert le.lora_plan(8, 2048, 32000, 16, torch.bfloat16, SMS) == 4
    tuning.record("chunked_loss", {"Hp": 768}, "bfloat16",
                  {"chunk_v": 4096})
    assert cl._auto_chunk(50304, None, 768, torch.bfloat16) == 4096
    assert cl._auto_chunk(50304, 2048, 768, torch.bfloat16) == 2048


@pytest.mark.parametrize("kernel,dims,dtype,blocks", [
    ("chunked_loss", {"Hp": 768}, "bfloat16", {"chunk_v": 200}),
    ("chunked_loss", {"Hp": 768}, "bfloat16", {"chunk_v": True}),
    ("lora_epilogue", {"Hp": 2048, "Vp": 32000}, "bfloat16",
     {"rows": 1 << 20}),
    ("fused_swiglu", {"Hp": 4096, "Tb": 8192}, "bfloat16",
     {"tile_n": 256}),
    ("fused_swiglu", {"Hp": 4096, "Tb": 8192}, "float32", {"tile_n": 128}),
    ("int8_matmul", {"N": 5632, "K": 2048, "Tb": 8}, "int8",
     dict(bm=64, bt=192, splits=1, kc=2048)),
    ("int8_matmul", {"N": 5632, "K": 2048, "Tb": 8}, "int8",
     dict(bm=64, bt=8, splits=3, kc=100)),
    ("fused_collective_matmul", {"Kp": 2048}, "bfloat16",
     {"block_m": 64, "block_n": 128}),
    ("fused_sample", {"Vp": 1024, "R": 8}, "float32", {"splits": 4096}),
])
def test_misaligned_or_over_budget_entries_miss(tables_dir, kernel, dims,
                                                dtype, blocks):
    doc = {"schema": 1, "kernel": kernel, "entries": {
        tuning.make_key(dims, dtype, "h100"): {"blocks": blocks,
                                               "timing": "measured"}}}
    tables_dir.mkdir(parents=True, exist_ok=True)
    (tables_dir / f"{kernel}.json").write_text(json.dumps(doc))
    tuning.clear_cache()
    assert tuning.lookup(kernel, dims, dtype) is None
    assert len(tuning.validate_tables(str(tables_dir))) == 1


def test_fixed_tiles_unknown_generation_and_corrupt_files_miss(tables_dir):
    tables_dir.mkdir(parents=True)
    for kernel, key, blocks in (
            ("flash_attention", "h100|bfloat16|Dp=64,Sb=1024",
             {"block_q": 128, "block_k": 128}),
            ("chunked_loss", "a100|bfloat16|Hp=768", {"chunk_v": 4096})):
        (tables_dir / f"{kernel}.json").write_text(json.dumps(
            {"schema": 1, "kernel": kernel,
             "entries": {key: {"blocks": blocks, "timing": "measured"}}}))
    (tables_dir / "int8_matmul.json").write_text('{"schema": 1, "kern')
    tuning.clear_cache()
    assert tuning.lookup("flash_attention", {"Dp": 64, "Sb": 1024},
                         "bfloat16") is None
    assert tuning.lookup("chunked_loss", {"Hp": 768}, "bfloat16",
                         "a100") is None
    assert tuning.lookup("int8_matmul", {"N": 1, "K": 1, "Tb": 8},
                         "int8") is None
    assert len(tuning.load_problems()) == 1
    with pytest.raises(ValueError):
        tuning.record("flash_attention", {"Dp": 64, "Sb": 1024},
                      "bfloat16", {"block_q": 128, "block_k": 128})
    problems = tuning.validate_tables(str(tables_dir))
    assert any("fixed" in p for p in problems)
    assert any("foreign" in p for p in problems)
    assert any("corrupt" in p for p in problems)


def test_cpu_timed_entry_never_served_on_the_card(tables_dir, monkeypatch):
    dims = {"Hp": 768}
    key, entry = tuning.record("chunked_loss", dims, "bfloat16",
                               {"chunk_v": 4096})
    assert entry["timing"] == "cpu"
    assert tuning.lookup("chunked_loss", dims, "bfloat16") == {
        "chunk_v": 4096}
    monkeypatch.setattr(ptable, "detect_generation", lambda: "h100")
    assert tuning.lookup("chunked_loss", dims, "bfloat16") is None
    entry["timing"] = "measured"
    assert tuning.lookup("chunked_loss", dims, "bfloat16") == {
        "chunk_v": 4096}


# ---- the budget gate ------------------------------------------------------


def _glu_tile(T, F, dt):
    """``csrc/glu.cu``'s ``tile_n``."""
    if dt == "float32":
        return 64
    return 128 if -(-T // 128) * -(-F // 128) >= 4 * 132 else 64


def _chunk_tile(M, N, dt):
    """``csrc/chunk_matmul.cu``'s ``tile_of``."""
    def tiles(bm, bn):
        return -(-M // bm) * -(-N // bn)
    if dt != "float32":
        return 128, (256 if tiles(128, 256) >= 132 else 128)
    if tiles(128, 128) >= 2 * 132:
        return 128, 128
    return (128, 64) if tiles(128, 64) >= 132 else (64, 64)


def _fits(kernel, blocks, dims, es):
    ok, est = SPECS[kernel].check(blocks, dims, es, BUDGET)
    return ok and est.smem <= BUDGET


def test_every_heuristic_choice_fits_the_budget():
    es = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}
    for _case, T, N, K, _main in cs.INT8_CASES:
        bm, bt, sp, kc = q.int8_plan(T, N, K)
        assert _fits("int8_matmul", dict(bm=bm, bt=bt, splits=sp, kc=kc),
                     {"N": N, "K": K, "Tb": tuning.token_bucket(T)}, 1)
    for _case, R, V, _vs in cs.SAMPLE_CASES:
        assert _fits("fused_sample",
                     {"splits": pd.sample_splits(R, V, SMS)[0]},
                     {"Vp": tuning.padded_lanes(V), "R": R}, 4)
    for _case, N, hq, hkv, S, pdt, D, P, T in cs.PAGED_CASES:
        per = pd.paged_geometry(N, hq, hkv, S, D, P, T)[1]
        assert _fits("paged_decode", {"per": per},
                     {"Dp": D, "Rq": hq // hkv * S}, es[pdt])
    for _case, slots, width, R, H, V, dts, _main in cs.LORA_CASES:
        rows = le.lora_rows(slots * width, V, R, SMS)
        assert _fits("lora_epilogue", {"rows": rows},
                     {"Hp": H, "Vp": V, "R": R}, 2)
    for _case, T, H, F, dt, _act, _main in cs.GLU_CASES:
        assert _fits("fused_swiglu", {"tile_n": _glu_tile(T, F, dt)},
                     {"Hp": H, "Tb": tuning.token_bucket(T)}, es[dt])
    for _case, lead, K, N, dt, _main in cs.CHUNK_CASES:
        bm, bn = _chunk_tile(int(np.prod(lead)), N, dt)
        assert _fits("fused_collective_matmul",
                     {"block_m": bm, "block_n": bn}, {"Kp": K}, es[dt])
    for H in (cs.TH, 1024, 769, 1025, cs.LH):
        assert _fits("chunked_loss", {"chunk_v": 8192},
                     {"Hp": tuning.padded_lanes(H)}, 2)


@pytest.mark.parametrize("kernel,dims", [
    ("flash_attention", {"Dp": 64, "Sb": 1024}),
    ("flash_attention", {"Dp": 128, "Sb": 4096}),
    ("fused_ag_flash", {"Dp": 64, "Sb": 16384}),
    ("linear_xent", {"Hp": 768}), ("linear_xent", {"Hp": 4096}),
    ("linear_xent", {"Hp": 896}), ("linear_xent", {"Hp": 1152}),
    ("layer_norm", {"lanes": 768}), ("layer_norm", {"lanes": 4096}),
    ("layer_norm", {"lanes": 8192}), ("layer_norm", {"lanes": 1024}),
    ("fused_softmax", {"lanes": 1024}), ("rope", {"lanes": 64}),
    ("xentropy", {"lanes": 50304}), ("bias_dropout_add", {"lanes": 1024}),
])
@pytest.mark.parametrize("es", [2, 4])
def test_fixed_tile_frames_fit(kernel, dims, es):
    assert _fits(kernel, {}, dims, es)


def test_check_paged_geometry_on_the_kernel_frame():
    for _case, N, hq, hkv, S, pdt, D, P, T in cs.PAGED_CASES:
        assert pd.check_paged_geometry(P, D, hq // hkv, S, pdt) == (
            D, hq // hkv * S)
    assert pd.check_paged_geometry(13, 100, 3, 5) == (104, 15)
    for bad in ((0, 64, 1, 1), (16, 1024, 1, 1), (16, 64, 0, 1)):
        with pytest.raises(ValueError, match="paged_decode"):
            pd.check_paged_geometry(*bad)


def test_a_frame_past_the_budget_fails():
    assert not _fits("lora_epilogue", {"rows": 8}, {"Hp": 64, "Vp": 64,
                                                    "R": 1 << 14}, 2)
    assert not _fits("flash_attention", {}, {"Dp": 256, "Sb": 128}, 2)
    ok, est = vmem_model.layer_norm_check({}, {"lanes": 8192}, 4, 1024)
    assert not ok and est.smem > 1024


def test_frames_read_the_kernels_constants():
    """The model's ring sizes are the sources' ``SMEM`` constants."""
    gemm = (CSRC / "gemm_wg.cuh").read_text()
    assert "SMEM = 1024 + STAGES * STAGE" in gemm
    assert vmem_model.wg_gemm_smem(256, 4) == 1024 + 4 * (
        128 * 64 * 2 + 256 * 64 * 2)
    i8 = (CSRC / "int8_matmul.cu").read_text()
    assert "SMEM = 1024 + STAGES * STAGE" in i8
    rec = {"threads": 256, "static_smem": 512, "dyn_smem": 197632,
           "regs": 168, "max_threads": 256}
    ok, est = vmem_model.linear_xent_check({}, {"Hp": 768}, 2, BUDGET)
    assert ok and any(f.bounds(rec) for f in est)
    assert not any(f.bounds(dict(rec, regs=256)) for f in est)


# ---- the registry, the card's row, the C entries --------------------------


def test_registry_and_checks_keep_jax_names():
    assert set(SPECS) == set(jt.SPECS)
    assert set(vmem_model.CHECKS) == set(jvm.CHECKS)
    tunable = {k for k, s in SPECS.items() if not s.fixed}
    assert tunable == {"int8_matmul", "fused_sample", "paged_decode",
                       "lora_epilogue", "fused_swiglu",
                       "fused_collective_matmul", "chunked_loss"}
    for name in SPECS:
        if name in jt.SPECS and SPECS[name].fixed:
            assert SPECS[name].params == jt.SPECS[name].params


def test_h100_row_limits_and_budgets():
    cap = capability.get_capability("h100")
    assert (cap.regs_sm, cap.regs_thread, cap.threads_block,
            cap.threads_sm, cap.blocks_sm) == (65536, 255, 1024, 2048, 32)
    assert capability.regs_budget() == 65536
    assert le._SMEM_LIMIT == capability.smem_budget() == 232448
    assert vmem_model.budget_bytes() == 232448
    assert vmem_model.reg_ceiling(256) == 255
    assert vmem_model.reg_ceiling(1024) == 64


def test_rdma_device_memory_rule():
    ok, est = vmem_model.rdma_check(512, 1024, 1024, 2, 80 * 2 ** 30)
    assert ok and est == 16 * 512 * 1024 + 2 * (512 * 1024 + 1024 * 1024)
    assert vmem_model.rdma_slot_bytes(256, 512) == jvm.rdma_slot_bytes(
        256, 512)


@pytest.mark.parametrize("entry,source", [
    ("apex1_glu_fwd", "glu.cu"), ("apex1_chunk_matmul", "chunk_matmul.cu"),
    ("apex1_launch_record", "launch_records.cu"),
    ("apex1_launch_records", "launch_records.cu")])
def test_entry_point_arity_matches_signature(entry, source):
    params = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)",
                       (CSRC / source).read_text()).group(1)
    assert len(params.split(",")) == len(_build.SIGNATURES[entry])


def test_every_launch_site_notes_its_launch():
    """Each ``<<<...>>>`` launch in the sources is preceded by its
    ``note_launch`` (the launch records `run_tune` reads)."""
    for p in sorted(CSRC.glob("*.cu*")):
        if p.name == "common.cuh":   # the records' definition
            continue
        text = p.read_text()
        assert text.count("<<<") == text.count("note_launch("), p.name


# ---- the sweep's plumbing -------------------------------------------------


def test_sweep_cpu_plumbing_banks_and_serves(tables_dir, capsys):
    assert sweep.main(["--device", "cpu", "--kernel", "all",
                       "--iters", "1"]) == 0
    out = capsys.readouterr().out
    assert out.count("lookup verified") == len(sweep.CASES)
    assert sweep.main(["--validate"]) == 0
    tuning.clear_cache()
    for name, make in sweep.CASES.items():
        case = make(torch, "cpu", True)
        served = tuning.lookup(case.kernel, case.dims, case.dtype)
        assert served is not None and case.plan() == served, name


def test_sweep_drops_candidates_past_the_budget(tables_dir):
    case = sweep.CASES["fused_swiglu"](torch, "cpu", True)
    case.candidates = [{"tile_n": 64}, {"tile_n": 512}]
    said = []
    best, problems = sweep.sweep_case(case, 1, said.append, device="cpu",
                                      write=False)
    assert best == {"tile_n": 64} and not problems
    assert any("drop {'tile_n': 512}" in s for s in said)


def test_sweep_needs_the_card_unless_told_cpu(tables_dir, capsys,
                                             monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sweep.main(["--kernel", "int8_matmul"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
