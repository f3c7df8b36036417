"""The port's fused collective forms against the JAX package's and
against its own decomposed forms, on the CPU.

The ranks run under gloo (`apex1_tpu_torch.parallel.launch`, bodies in
tests/torch_dist_ranks.py, one launch per world size); the JAX package
runs the same cases under ``shard_map`` on its 8-device CPU mesh,
device r holding rank r's inputs, through its composite
(``force_impl("xla")``) and its Pallas kernels in interpret mode
(``"pallas"``). At worlds 2 and 4, fp32:

- `fused_matmul_reduce_scatter` and `fused_all_gather_matmul` (also with
  a rank-3 ``(S, mb, hid)`` operand): forward, dx and dW equal to the
  decomposed `mappings` rings bit for bit (the JAX suite's own pins), and
  to JAX's fused forms within 1e-5;
- `fused_all_gather_matmul_serial` equal to the overlapped form bit for
  bit;
- `matmul_reduce_scatter_rdma` (row 27's protocol: the chunk product's
  accumulator epilogue and a send/receive ring) equal to
  `fused_matmul_reduce_scatter` bit for bit, with n - 1 hops; it raises
  on a ring of one, a 3-D x and a length the ring does not divide;
- `all_gather_flash_attention` (causal, full, GQA, segments) equal to
  the port's `ring_attention` bit for bit (the merge kernel's plain
  version is the ring's own attend and merge), and to JAX's within
  1e-5, grads included (interpret mode at causal GQA and segments);
- `fused_vocab_parallel_merge` against JAX's, in 2 all-reduces.

Single-process: `chunk_matmul` (rows 24-25) against ``torch.matmul``
and JAX's ``_chunk_matmul`` in interpret mode, also with explicit blocks
at the Hopper kernel's tile edges and at K = 0, its accumulator and its
errors; `flash_fwd_merge` (row 26) against JAX's ``_agf_call`` in
interpret mode with a carried (out, lse), offsets, segments and GQA;
``dropout_p`` rejected.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from apex1_tpu.core.mesh import make_mesh
from apex1_tpu.ops import fused_collective as jfc
from apex1_tpu.ops._common import force_impl
from apex1_tpu_torch.ops import fused_collective as fc
from apex1_tpu_torch.ops.attention import flash_fwd_merge
from apex1_tpu_torch.parallel import launch

import torch_dist_ranks

WORLDS = (2, 4)
S, H, O = 4, 6, 5
B, HQ, HKV, SL, D = 1, 4, 2, 16, 32
TOL = dict(rtol=1e-5, atol=1e-5)
ATTN = ("causal", "full", "gqa", "segments")
#: the attention cases each JAX path runs: interpret mode's flash rings
#: compile slowly, so it takes the causal GQA and the segment cases
ATTN_BY_IMPL = {"xla": ATTN, "pallas": ("gqa", "segments")}


def _inputs(n: int) -> dict:
    rng = np.random.default_rng(10 + n)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    segs = (rng.integers(0, 3, (B, SL * n)).cumsum(axis=-1) // 2)
    stats = f(n, S * n, 4)
    stats[..., 1] = np.abs(stats[..., 1]) + 0.5   # l > 0
    return {"x": f(n, S, H), "x_seq": f(n, S * n, H),
            "x_seq3": f(n, S * n, 2, H), "w_col": f(n, H, O),
            "w_row": f(n, H, O), "ct_agm": f(n, S * n, O),
            "ct_mrs": f(n, S, O), "ct_mrs3": f(n, S, 2, O),
            "q": f(n, B, HQ, SL, D), "k": f(n, B, HQ, SL, D),
            "v": f(n, B, HQ, SL, D), "k_gqa": f(n, B, HKV, SL, D),
            "v_gqa": f(n, B, HKV, SL, D), "do": f(n, B, HQ, SL, D),
            "segs": np.stack(np.split(segs.astype(np.int32), n, axis=1)),
            "stats": stats}


def _jax_cases(i, attn):
    ax = "tp"
    out = {}

    def vjp(fn, primals, ct):
        y, back = jax.vjp(fn, *primals)
        return [y, *back(ct)]

    for name, fn, x, w, ct in (
            ("fmrs", jfc.fused_matmul_reduce_scatter, "x_seq", "w_row",
             "ct_mrs"),
            ("fmrs3", jfc.fused_matmul_reduce_scatter, "x_seq3", "w_row",
             "ct_mrs3"),
            ("fagm", jfc.fused_all_gather_matmul, "x", "w_col", "ct_agm")):
        out[name] = vjp(lambda a, b: fn(a, b, ax, 0), [i[x], i[w]], i[ct])
    for name, kw in (("causal", dict(causal=True)), ("full", {}),
                     ("gqa", dict(causal=True, gqa=True)),
                     ("segments", dict(segments=True))):
        if name not in attn:
            continue
        kv = ("k_gqa", "v_gqa") if kw.pop("gqa", False) else ("k", "v")
        if kw.pop("segments", False):
            kw["segment_ids"] = i["segs"]
        out[f"agf_{name}"] = vjp(
            lambda q, k, v: jfc.all_gather_flash_attention(q, k, v, ax,
                                                           **kw),
            [i["q"], i[kv[0]], i[kv[1]]], i["do"])
    out["vp_merge"] = list(jfc.fused_vocab_parallel_merge(i["stats"], ax))
    return out


def _jax_run(n: int, impl: str, inputs: dict) -> dict:
    mesh = make_mesh(tp=n, devices=jax.devices()[:n])

    def body(i):
        i = {k: v[0] for k, v in i.items()}
        return jax.tree_util.tree_map(lambda t: t[None],
                                      _jax_cases(i, ATTN_BY_IMPL[impl]))

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("tp"),),
                               out_specs=P("tp"), check_vma=False))
    with force_impl(impl):
        out = fn({k: jnp.asarray(v) for k, v in inputs.items()})
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"world{n}")
def world(request):
    n = request.param
    inputs = _inputs(n)
    # the ranks run while JAX compiles
    with ThreadPoolExecutor(1) as ex:
        port = ex.submit(launch, torch_dist_ranks.fc_cases, n, inputs, n,
                         backend="gloo")
        xla, pallas = (_jax_run(n, impl, inputs) for impl in ("xla",
                                                              "pallas"))
        return dict(n=n, port=port.result(), xla=xla, pallas=pallas)


def _bitwise(a_list, b_list):
    assert len(a_list) == len(b_list)
    for a, b in zip(a_list, b_list):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fused,dec", [("fmrs", "mrs"), ("fmrs3", "mrs3"),
                                       ("fagm", "agm")])
def test_fused_matmuls_equal_decomposed_bitwise(world, fused, dec):
    for got in world["port"]:
        _bitwise(got[fused], got[dec])


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("case", ["fmrs", "fmrs3", "fagm"])
def test_fused_matmuls_match_jax(world, case, impl):
    want = world[impl][case]
    for r, got in enumerate(world["port"]):
        for g, w in zip(got[case], want):
            np.testing.assert_allclose(g, w[r], **TOL)


def test_serial_equals_overlapped_bitwise(world):
    for got in world["port"]:
        _bitwise(got["fagm_serial"], got["fagm"][:1])


def test_rdma_ring_equals_fused_reduce_scatter_bitwise(world):
    for got in world["port"]:
        _bitwise(got["rdma"], got["fmrs"][:1])
        assert got["rdma_hops"] == world["n"] - 1


def test_rdma_checks(world):
    for got in world["port"]:
        ring1, three_d, ragged = got["rdma_errors"]
        assert ring1.startswith("ValueError: matmul_reduce_scatter_rdma "
                                "needs a ring of >= 2 devices")
        assert three_d.startswith("ValueError: x must be (S, K)")
        assert ragged.startswith("ValueError: S=") and "not divisible" \
            in ragged


@pytest.mark.parametrize("case", ATTN)
def test_all_gather_flash_equals_ring_bitwise(world, case):
    for got in world["port"]:
        _bitwise(got[f"agf_{case}"], got[f"ring_{case}"])


@pytest.mark.parametrize("impl,case", [(impl, case)
                                       for impl, cases in ATTN_BY_IMPL.items()
                                       for case in cases])
def test_all_gather_flash_matches_jax(world, case, impl):
    want = world[impl][f"agf_{case}"]
    for r, got in enumerate(world["port"]):
        for j, (g, w) in enumerate(zip(got[f"agf_{case}"], want)):
            np.testing.assert_allclose(g, w[r], err_msg=f"rank {r} out {j}",
                                       rtol=1e-5, atol=2e-5)


def test_vocab_parallel_merge_matches_jax_in_two_all_reduces(world):
    want = world["xla"]["vp_merge"]
    for r, got in enumerate(world["port"]):
        for g, w in zip(got["vp_merge"], want):
            np.testing.assert_allclose(g, w[r], **TOL)
        assert got["vp_merge_counts"]["all_reduce"] == 2


# ---- single process -----------------------------------------------------


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


@pytest.mark.parametrize("lead", [(24,), (6, 4)])
def test_chunk_matmul_plain_and_accumulator(lead):
    rng = np.random.default_rng(3)
    rows = _t(rng.standard_normal(lead + (20,)))
    w = _t(rng.standard_normal((20, 9)))
    acc = _t(rng.standard_normal(lead + (9,)))
    got = fc.chunk_matmul(rows, w)
    np.testing.assert_array_equal(got.numpy(), torch.matmul(rows, w).numpy())
    with_acc = fc.chunk_matmul(rows, w, acc)
    np.testing.assert_array_equal(with_acc.numpy(), (acc + got).numpy())
    with force_impl("pallas"):
        want = jfc._chunk_matmul(jnp.asarray(rows.numpy()),
                                 jnp.asarray(w.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert fc.chunk_matmul.launches == 0


#: the Hopper kernel's tile edges (rows 24-25): (leading dims of rows,
#: K, N, dtype). M 127/129 straddle its 128-row tiles, N 255/257 its
#: 256-column tiles, K 63/65 its 64-deep steps; a 3-D (S, mb, hid)
#: operand; bf16 operands; the empty sum K = 0
_CHUNK_EDGES = {"m127_n255_k63": ((127,), 63, 255, "float32"),
                "m129_n257_k65": ((129,), 65, 257, "float32"),
                "rank3_n129": ((8, 16), 64, 129, "float32"),
                "bf16_m129_n255": ((129,), 65, 255, "bfloat16"),
                "k0": ((70,), 0, 72, "float32")}


@pytest.mark.parametrize("name", list(_CHUNK_EDGES))
def test_chunk_matmul_tile_edges_match_jax(name):
    """The plain chunk product, the card tests' oracle, against JAX's
    ``_chunk_matmul`` in interpret mode with explicit 64 x 128 blocks;
    with an accumulator ``acc + chunk_matmul(rows, w)`` bit for bit.
    K = 0 against JAX's XLA chunk product (``_part_dot``, ``jnp.dot``:
    its Pallas kernel cannot take an empty depth): zeros, and acc + 0."""
    lead, K, N, dts = _CHUNK_EDGES[name]
    rng = np.random.default_rng(K * 31 + N)
    rows = rng.standard_normal(lead + (K,)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    acc = _t(rng.standard_normal(lead + (N,)))
    dt = getattr(torch, dts)
    got = fc.chunk_matmul(_t(rows, dt), _t(w, dt))
    with_acc = fc.chunk_matmul(_t(rows, dt), _t(w, dt), acc)
    jdt = jnp.bfloat16 if dts == "bfloat16" else jnp.float32
    jr, jw = jnp.asarray(rows, jdt), jnp.asarray(w, jdt)
    if K:
        with force_impl("pallas"):
            want = jfc._chunk_matmul(jr, jw, block_m=64, block_n=128)
    else:
        with force_impl("xla"):
            want = jfc._part_dot(jr, jw, None, None)
        assert not got.any()
    assert got.dtype == torch.float32 and got.shape == lead + (N,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(with_acc.numpy(), (acc + got).numpy())
    assert fc.chunk_matmul.launches == 0


def test_chunk_matmul_half_operands_widen_exactly():
    rng = np.random.default_rng(4)
    rows = _t(rng.standard_normal((8, 16)), torch.bfloat16)
    w = _t(rng.standard_normal((16, 4)), torch.float32)
    got = fc.chunk_matmul(rows, w)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  (rows.float() @ w).numpy())
    with pytest.raises(ValueError, match="do not fit"):
        fc.chunk_matmul(rows, w[:8])
    with pytest.raises(ValueError, match="acc must be fp32"):
        fc.chunk_matmul(rows, w, torch.zeros(8, 4, dtype=torch.bfloat16))


_MERGE = {"offdiag": dict(causal=True, q_off=32, k_off=0, hkv=4),
          "diag": dict(causal=True, q_off=16, k_off=16, hkv=2),
          "segments": dict(causal=False, q_off=0, k_off=0, hkv=4,
                           segs=True)}


@pytest.mark.parametrize("case", list(_MERGE))
def test_flash_fwd_merge_matches_jax_agf_call(case):
    """Row 26's step, single device: the port's merge kernel's plain
    version against JAX's ``_agf_call`` (Pallas interpret) with a
    non-trivial carried (out, lse)."""
    c = _MERGE[case]
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, HQ, SL, D)).astype(np.float32)
    k = rng.standard_normal((B, c["hkv"], SL, D)).astype(np.float32)
    v = rng.standard_normal((B, c["hkv"], SL, D)).astype(np.float32)
    po = rng.standard_normal((B, HQ, SL, D)).astype(np.float32)
    plse = rng.standard_normal((B, HQ, SL)).astype(np.float32)
    plse[..., :3] = -1e30       # rows with nothing carried yet
    qs = ks = None
    if c.get("segs"):
        qs = np.sort(rng.integers(0, 3, (B, SL)), axis=1).astype(np.int32)
        ks = np.sort(rng.integers(0, 3, (B, SL)), axis=1).astype(np.int32)
    scale = 1.0 / np.sqrt(D)
    out, lse = flash_fwd_merge(
        _t(q), _t(k), _t(v), None if qs is None else _t(qs, torch.int32),
        None if ks is None else _t(ks, torch.int32), scale, c["causal"],
        c["q_off"], c["k_off"], _t(po), _t(plse))
    bq, bk = jfc._agf_blocks(D, None, None, jnp.float32, SL)
    with force_impl("pallas"):
        wo, wl = jfc._agf_call(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            None if qs is None else jnp.asarray(qs),
            None if ks is None else jnp.asarray(ks), c["q_off"], c["k_off"],
            jnp.asarray(po), jnp.asarray(plse), scale, c["causal"],
            qs is not None, bq, bk)
    np.testing.assert_allclose(out.numpy(), np.asarray(wo), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(wl), **TOL)


def test_all_gather_flash_rejects_dropout():
    q = torch.zeros(B, HQ, SL, D)
    with pytest.raises(TypeError):
        fc.all_gather_flash_attention(q, q, q, None, dropout_p=0.1)
