"""The port's ring attention against the JAX package's, on the CPU.

The port's ranks run under gloo (`apex1_tpu_torch.parallel.launch`,
bodies in tests/torch_dist_ranks.py, one launch per world size) over
the context-parallel group; the JAX package runs ``ring_attention``
under ``shard_map`` on its 8-device CPU mesh (axis ``cp``), device r
holding rank r's sequence shard, through its composite
(``force_impl("xla")``) and its Pallas kernels in interpret mode
(``"pallas"``). At cp = 2 and 4, output and dq, dk, dv:

- fp32 within 1e-5: causal, full, causal GQA (4 query heads on 2 KV
  heads), segment ids riding the ring, attention dropout 0.1 keyed on
  global positions, and ``skip_masked=False``; interpret mode at the
  GQA and dropout cases;
- bf16 causal GQA within 2e-2 of the largest magnitude (the port rounds
  p and dS to bf16 before the backward's products, as its kernels do;
  JAX's composite keeps them fp32);
- `ring_attention_serial` equal to `ring_attention` bit for bit.

Single-process: ``flash_dkv(..., out_dtype=float32)``, the ring's fp32
dk/dv partials, rounded to bf16 equals the bf16 output bit for bit, and
another out_dtype raises.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from apex1_tpu.core.mesh import make_mesh
from apex1_tpu.ops._common import force_impl
from apex1_tpu.parallel.ring_attention import ring_attention as jax_ring
from apex1_tpu_torch.ops.attention import flash_dkv, flash_fwd
from apex1_tpu_torch.parallel import launch

import torch_dist_ranks

WORLDS = (2, 4)
B, HQ, HKV, SL, D = 1, 4, 2, 16, 32
SEED = 7
CASES = {"causal": dict(causal=True), "full": {},
         "gqa": dict(causal=True, gqa=True),
         "segments": dict(causal=True, segments=True),
         "dropout": dict(causal=True, dropout_p=0.1, dropout_seed=SEED),
         "no_skip": dict(causal=True, skip_masked=False),
         "bf16": dict(causal=True, gqa=True, dtype="bfloat16")}
#: the cases each JAX path runs (interpret mode's rings compile slowly)
BY_IMPL = {"xla": tuple(CASES), "pallas": ("gqa", "dropout")}


def _inputs(n: int) -> dict:
    rng = np.random.default_rng(20 + n)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    segs = (rng.integers(0, 3, (B, SL * n)).cumsum(axis=-1) // 2)
    return {"q": f(n, B, HQ, SL, D), "k": f(n, B, HQ, SL, D),
            "v": f(n, B, HQ, SL, D), "k_gqa": f(n, B, HKV, SL, D),
            "v_gqa": f(n, B, HKV, SL, D), "do": f(n, B, HQ, SL, D),
            "segs": np.stack(np.split(segs.astype(np.int32), n, axis=1))}


def _jax_cases(i, names):
    out = {}
    for name in names:
        kw = dict(CASES[name])
        dt = getattr(jnp, kw.pop("dtype", "float32"))
        kv = ("k_gqa", "v_gqa") if kw.pop("gqa", False) else ("k", "v")
        if kw.pop("segments", False):
            kw["segment_ids"] = i["segs"]
        prim = [i["q"].astype(dt), i[kv[0]].astype(dt), i[kv[1]].astype(dt)]
        y, back = jax.vjp(lambda q, k, v: jax_ring(q, k, v, "cp", **kw),
                          *prim)
        out[name] = [t.astype(jnp.float32)
                     for t in (y, *back(i["do"].astype(dt)))]
    return out


def _jax_run(n: int, impl: str, inputs: dict) -> dict:
    mesh = make_mesh(cp=n, dp=1, devices=jax.devices()[:n])

    def body(i):
        i = {k: v[0] for k, v in i.items()}
        return jax.tree_util.tree_map(lambda t: t[None],
                                      _jax_cases(i, BY_IMPL[impl]))

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("cp"),),
                               out_specs=P("cp"), check_vma=False))
    with force_impl(impl):
        out = fn({k: jnp.asarray(v) for k, v in inputs.items()})
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"cp{n}")
def world(request):
    n = request.param
    inputs = _inputs(n)
    # the ranks run while JAX compiles
    with ThreadPoolExecutor(1) as ex:
        port = ex.submit(launch, torch_dist_ranks.ring_cases, n, inputs, n,
                         CASES, backend="gloo")
        xla, pallas = (_jax_run(n, impl, inputs) for impl in BY_IMPL)
        return dict(n=n, port=port.result(), xla=xla, pallas=pallas)


@pytest.mark.parametrize("impl,case", [(impl, case)
                                       for impl, cases in BY_IMPL.items()
                                       for case in cases])
def test_ring_attention_matches_jax(world, impl, case):
    want = world[impl][case]
    for r, got in enumerate(world["port"]):
        for j, (g, w) in enumerate(zip(got[f"ring_{case}"], want)):
            msg = f"rank {r} output {j} (out, dq, dk, dv)"
            if case == "bf16":
                assert np.abs(g - w[r]).max() <= 2e-2 * np.abs(w[r]).max(), \
                    msg
            else:
                np.testing.assert_allclose(g, w[r], rtol=1e-5, atol=1e-5,
                                           err_msg=msg)


@pytest.mark.parametrize("case", list(CASES))
def test_serial_equals_overlapped_bitwise(world, case):
    for got in world["port"]:
        for a, b in zip(got[f"serial_{case}"], got[f"ring_{case}"]):
            np.testing.assert_array_equal(a, b)


def test_flash_dkv_fp32_output_is_the_unrounded_partial():
    rng = np.random.default_rng(1)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16)

    q, k, v, do = t(B, HQ, SL, D), t(B, HKV, SL, D), t(B, HKV, SL, D), \
        t(B, HQ, SL, D)
    scale = D ** -0.5
    out, lse = flash_fwd(q, k, v, None, None, scale, True, 16, 0)
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta, None, None, None, scale, True, 16, 0)
    dk32, dv32 = flash_dkv(*args, out_dtype=torch.float32)
    dk, dv = flash_dkv(*args)
    assert dk32.dtype == dv32.dtype == torch.float32
    assert torch.equal(dk32.to(torch.bfloat16), dk)
    assert torch.equal(dv32.to(torch.bfloat16), dv)
    with pytest.raises(ValueError, match="out_dtype"):
        flash_dkv(*args, out_dtype=torch.float16)
