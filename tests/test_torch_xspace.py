"""The port's per-op trace report (`apex1_tpu_torch.obs.xspace`) against
the JAX package's, on the CPU.

- A ``utils.observability.trace`` of one tiny GPT-2 O0 training step
  (use_flash=False, the materialized head) reports with the JAX
  package's schema: the same top-level keys, bucket fields and op fields
  as JAX's `build_report` of a ``jax.profiler.trace`` of the same tiny
  step on its side; ``plane_class`` ``"host-proxy"`` (no card), the
  bucket shares summing to 1 and each op's share its ms over the total;
  the report persisted beside the trace reads back equal.
- Device rows from hand-built Chrome-trace events: CUDA ``kernel``,
  ``gpu_memcpy`` and ``gpu_memset`` events make ``plane_class``
  ``"device"``; the port's ``csrc/`` kernels (by their ``__global__``
  names) land in ``kernel``, NCCL kernels in ``collective``, ATen's and
  cuBLAS's in ``library``; host ops and annotations are not counted.
- Each malformed input raises `TraceError`: truncated JSON, a bad gzip,
  a valid gzip header over a corrupt body, an empty directory, a trace
  with no op events, a foreign JSON document.
- ``python -m apex1_tpu_torch.obs --smoke --device cpu`` exits 0 with the
  three stages and prices ``uncalibrated`` (the port's own empty corpus;
  the JAX package's TPU calibration is never read).
"""

import gzip
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex1_tpu.models.gpt2 import GPT2 as JaxGPT2
from apex1_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from apex1_tpu.models.gpt2 import gpt2_loss_fn as jax_gpt2_loss_fn
from apex1_tpu.obs import xspace as jxs
from apex1_tpu_torch import GPT2Config, get_policy, gpt2_loss_fn
from apex1_tpu_torch import gpt2_params_from_jax
from apex1_tpu_torch.obs import __main__ as obs_main
from apex1_tpu_torch.obs import xspace
from apex1_tpu_torch.utils.observability import trace

KW = dict(vocab_size=97, max_seq_len=32, num_layers=2, num_heads=2,
          hidden_size=32, use_flash=False)


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """The port's and JAX's reports of the same tiny GPT-2 step."""
    tokens = np.random.default_rng(0).integers(0, 97, (2, 16)).astype(
        np.int32)
    jcfg = JaxGPT2Config.tiny(**KW)
    jparams = jax.jit(JaxGPT2(jcfg).init)(jax.random.key(0),
                                          jnp.asarray(tokens))["params"]
    jstep = jax.jit(jax.value_and_grad(
        jax_gpt2_loss_fn(JaxGPT2(jcfg), fuse_head=False)))
    jax.block_until_ready(jstep(jparams, jnp.asarray(tokens)))
    jdir = str(tmp_path_factory.mktemp("jax_trace"))
    with jax.profiler.trace(jdir):
        jax.block_until_ready(jstep(jparams, jnp.asarray(tokens)))
    jrep = jxs.build_report(jdir, steps=1)

    cfg = GPT2Config.tiny(policy=get_policy("O0"), **KW)
    model = gpt2_params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                 "cpu")
    params = dict(model.named_parameters())
    loss_fn = gpt2_loss_fn(model, fuse_head=False)
    t = torch.from_numpy(tokens).long()

    def step():
        loss = loss_fn(params, t)
        return torch.autograd.grad(loss, list(params.values()))

    step()
    pdir = tmp_path_factory.mktemp("port_trace")
    with trace(str(pdir)):
        step()
    return jrep, xspace.build_report(str(pdir), steps=1), str(pdir)


def test_report_schema_equals_jax(reports):
    jrep, rep, _ = reports
    assert set(rep) == set(jrep)
    assert rep["schema"] == jrep["schema"] == xspace.REPORT_SCHEMA
    assert all(set(b) == {"ms", "share"} for b in rep["buckets"].values())
    assert set(rep["ops"][0]) == set(jrep["ops"][0])
    assert len(rep["buckets"]) == len(jrep["buckets"]) == 3
    assert rep["plane_class"] == "host-proxy" and rep["n_ops"] > 0
    assert rep["steps"] == 1 and rep["per_step_ms"] == rep["total_op_ms"]


def test_shares_sum_to_one(reports):
    _, rep, _ = reports
    assert sum(b["share"] for b in rep["buckets"].values()) == \
        pytest.approx(1.0, abs=1e-3)
    assert sum(b["ms"] for b in rep["buckets"].values()) == \
        pytest.approx(rep["total_op_ms"], rel=1e-6)
    for op in rep["ops"]:
        assert op["share"] == pytest.approx(op["ms"] / rep["total_op_ms"],
                                            abs=1e-4)
    assert rep["buckets"]["library"]["share"] == pytest.approx(1.0)


def test_report_persists_beside_the_trace(reports):
    _, rep, pdir = reports
    path = xspace.write_report(pdir, report=rep)
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(rep))
    again = xspace.build_report(pdir, steps=1)   # the report is not a trace
    assert again["n_ops"] == rep["n_ops"]
    assert "plane class: host-proxy" in xspace.format_report(rep)


def _ev(name, cat, ts, dur, tid=7):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": tid}


DEVICE_EVENTS = [
    _ev("aten::mm", "cpu_op", 0, 50, tid=1),
    _ev("ProfilerStep#1", "user_annotation", 0, 100, tid=1),
    _ev("void (anonymous namespace)::glu_wg_kernel<__nv_bfloat16, 0, 128>"
        "(GluArgs)", "kernel", 10, 40),
    _ev("void flash_fwd_wg_kernel<__nv_bfloat16, 64, false, false>"
        "(FlashArgs)", "kernel", 60, 20),
    _ev("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
        "kernel", 80, 30),
    _ev("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*)", "kernel",
        90, 5, tid=9),
    _ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 120, 3),
    _ev("Memset (Device)", "gpu_memset", 125, 2),
    _ev("step", "gpu_user_annotation", 0, 130),
]


def test_device_rows_and_buckets(tmp_path):
    (tmp_path / "trace_1_0.json").write_text(json.dumps(
        {"traceEvents": DEVICE_EVENTS}))
    rep = xspace.build_report(str(tmp_path), steps=2)
    assert rep["plane_class"] == "device" and rep["n_ops"] == 6
    assert rep["total_op_ms"] == pytest.approx(0.1)
    assert rep["per_step_ms"] == pytest.approx(0.05)
    b = rep["buckets"]
    assert b["kernel"]["ms"] == pytest.approx(0.06)
    assert b["collective"]["ms"] == pytest.approx(0.005)
    assert b["library"]["ms"] == pytest.approx(0.035)
    kinds = {op["name"][:20]: op["bucket"] for op in rep["ops"]}
    assert kinds["void (anonymous name"] == "kernel"
    assert kinds["ncclDevKernel_AllRed"] == "collective"
    assert kinds["sm90_xmma_gemm_bf16b"] == "library"


@pytest.mark.parametrize("name,bucket", [
    ("ncclKernel_AllGather_RING_LL_Sum_int8_t", "collective"),
    ("gloo:all_reduce", "collective"), ("c10d::allreduce_", "collective"),
    ("void (anonymous namespace)::int8_mm_wg_kernel<1, 8, true>(I8Args)",
     "kernel"),
    ("void lora_stream_kernel<4>(float const*, int const*)", "kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<float>>(int, T1, T2)", "library"),
    ("aten::broadcast_tensors", "library"), ("aten::addmm", "library")])
def test_bucket_rules(name, bucket):
    assert xspace.bucket_of(name) == bucket


def test_the_kernel_bucket_reads_the_library_sources():
    names = xspace.kernel_names()
    for k in ("glu_wg_kernel", "int8_mm_wg_kernel", "paged_merge_kernel",
              "flash_fwd_wg_kernel", "lxent_wg_fold_kernel",
              "ln_bwd_cols_kernel", "xent_fwd_kernel"):
        assert k in names


@pytest.mark.parametrize("kind", ["truncated", "gzip", "gzip-body",
                                  "empty-dir", "no-ops", "foreign"])
def test_malformed_traces_raise_trace_error(tmp_path, kind):
    if kind == "truncated":
        (tmp_path / "t.json").write_text('{"traceEvents": [{"ph": "X"')
    elif kind == "gzip":
        (tmp_path / "t.json.gz").write_bytes(b"not a gzip file at all")
    elif kind == "gzip-body":
        good = gzip.compress(json.dumps({"traceEvents": DEVICE_EVENTS})
                             .encode())
        (tmp_path / "t.json.gz").write_bytes(good[:12] + b"\x00" * 40
                                             + good[52:])
    elif kind == "no-ops":
        (tmp_path / "t.json").write_text(json.dumps({"traceEvents": [
            _ev("ProfilerStep#1", "user_annotation", 0, 100)]}))
    elif kind == "foreign":
        (tmp_path / "t.json").write_text(json.dumps({"schema": 1}))
    with pytest.raises(xspace.TraceError) as e:
        xspace.build_report(str(tmp_path))
    assert e.value.path and e.value.reason


def test_obs_smoke_on_the_cpu(capsys):
    assert obs_main.main(["--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for stage in ("spine OK", "trace OK", "calibrate OK", "OBS SMOKE OK"):
        assert stage in out
    assert "host-proxy" in out and "uncalibrated" in out
