"""The port's tensor parallelism against the JAX package's, on the CPU.

The port's ranks run under gloo (`apex1_tpu_torch.parallel.launch`,
bodies in tests/torch_dist_ranks.py, one launch per world size for the
whole file); the JAX package runs the same cases under ``shard_map`` on
its 8-device CPU mesh, device r holding rank r's inputs, with its
composite (``force_impl("xla")``) and its Pallas kernels in interpret
mode (``"pallas"``). At worlds 2 and 4, fp32, forward and vjp (1e-5):

- the seven region functions (copy, reduce, scatter and gather along
  the last dimension; scatter, gather with and without the
  tensor-parallel reduce-scatter backward, and reduce-scatter along
  the sequence) and the decomposed rings `all_gather_matmul` and
  `matmul_reduce_scatter` (with a rank-3 operand);
- `column_parallel_linear` (gather_output and a bias; sequence parallel
  monolithic, ``overlap=True`` and ``fused=True``),
  `row_parallel_linear` (the same, and ``input_is_parallel=False``) and
  `vocab_parallel_embedding` (the table's gradient); ``overlap`` with
  ``fused`` raises;
- `vocab_parallel_cross_entropy` with and without label smoothing, and
  `vocab_parallel_linear_cross_entropy` (plain; smoothing with a
  padding_idx; num_classes; a sequence-parallel input), decomposed and
  fused: their loss, dx and dW against JAX's, the fused form's forward
  making 2 all-reduces against the decomposed form's 4 (one more each
  in the backward: the input's copy region), and fused equal to
  decomposed bit for bit at world 2 (each lane sums two terms) and
  within 1e-6 relative at world 4 (gloo's ring may add a packed lane
  and a lone tensor in other rank orders);
- the mesh: rank r at device r's coordinate of JAX's ``make_mesh``, the
  `parallel_state` sizes and ranks, and an fsdp mesh of every rank (its
  coordinates JAX's, the world one dp x fsdp group).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from apex1_tpu.core.mesh import make_mesh
from apex1_tpu.ops._common import force_impl
from apex1_tpu.transformer import tensor_parallel as jtp
from apex1_tpu_torch.parallel import launch

import torch_dist_ranks

WORLDS = (2, 4)
S, H, O, V, T = 4, 6, 5, 7, 8
REGIONS = ("copy", "reduce", "scatter", "gather", "sp_scatter", "sp_gather",
           "sp_gather_split", "sp_rs")
LAYERS = ("col", "col_sp", "col_sp_overlap", "col_sp_fused", "row",
          "row_sp", "row_sp_overlap", "row_sp_fused", "row_scatter",
          "embedding")
LCE = ("plain", "smooth_pad", "classes", "sp_input")
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(n: int) -> dict:
    rng = np.random.default_rng(n)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def rep(a):
        return np.stack([a] * n)

    xh = f(T, H)
    i = {"x_rep": rep(f(S, H)), "x": f(n, S, H), "x_wide": rep(f(S, H * n)),
         "x_seq_rep": rep(f(S * n, H)), "x_seq": f(n, S * n, H),
         "x_seq3": f(n, S * n, 2, H), "w_col": f(n, H, O),
         "w_row": f(n, H, O), "b_col": f(n, O), "b_row": rep(f(O)),
         "ct_copy": f(n, S, H), "ct_reduce": f(n, S, H),
         "ct_scatter": f(n, S, H), "ct_gather": f(n, S, H * n),
         "ct_sp_scatter": f(n, S, H), "ct_sp_gather": f(n, S * n, H),
         "ct_sp_gather_split": f(n, S * n, H), "ct_sp_rs": f(n, S, H),
         "ct_agm": f(n, S * n, O), "ct_mrs": f(n, S, O),
         "ct_mrs3": f(n, S, 2, O), "ct_col": f(n, S, O * n),
         "ct_row": f(n, S, O),
         "tokens": rep(rng.integers(0, V * n, S).astype(np.int32)),
         "table": f(n, V, H), "ct_emb": f(n, S, H), "logits": f(n, S, V),
         "labels_s": rep(rng.integers(0, V * n, S).astype(np.int32)),
         "ct_s": f(n, S), "xh": rep(xh),
         "xh_seq": xh.reshape(n, T // n, H), "wv": f(n, V, H) * 0.5,
         "labels_t": rep(rng.integers(0, V * n - 2, T).astype(np.int32)),
         "ct_t": rep(f(T)),
         "num_classes": rep(np.int32(V * n - 2))}
    i["labels_t"][:, :2] = 0   # padding_idx 0 rows
    return i


def _jax_cases(i, n):
    """The JAX package's side of every case, inside shard_map."""
    ax = "tp"
    out = {}
    last = []

    def vjp(fn, primals, ct):
        # each case starts once the previous one's outputs exist. Every
        # collective of the module rendezvouses under one channel id, and
        # XLA:CPU may run two independent cases' collectives in different
        # orders on the two devices: they then wait on each other until
        # the rendezvous' 40 s timeout aborts the process
        if last:
            _, primals, ct = jax.lax.optimization_barrier(
                (last[-1], primals, ct))
        y, back = jax.vjp(fn, *primals)
        last.append([y, *back(ct)])
        return last[-1]

    regions = {
        "copy": (jtp.copy_to_tensor_model_parallel_region, "x_rep"),
        "reduce": (jtp.reduce_from_tensor_model_parallel_region, "x"),
        "scatter": (jtp.scatter_to_tensor_model_parallel_region, "x_wide"),
        "gather": (jtp.gather_from_tensor_model_parallel_region, "x"),
        "sp_scatter": (jtp.scatter_to_sequence_parallel_region,
                       "x_seq_rep"),
        "sp_gather": (jtp.gather_from_sequence_parallel_region, "x"),
        "sp_gather_split": (
            lambda x, a: jtp.gather_from_sequence_parallel_region(
                x, a, 0, False), "x"),
        "sp_rs": (jtp.reduce_scatter_to_sequence_parallel_region, "x_seq")}
    for name, (fn, x) in regions.items():
        out[name] = vjp(lambda a: fn(a, ax), [i[x]], i[f"ct_{name}"])
    out["agm"] = vjp(lambda x, w: jtp.all_gather_matmul(x, w, ax, 0),
                     [i["x"], i["w_col"]], i["ct_agm"])
    out["mrs"] = vjp(lambda x, w: jtp.matmul_reduce_scatter(x, w, ax, 0),
                     [i["x_seq"], i["w_row"]], i["ct_mrs"])
    out["mrs3"] = vjp(lambda x, w: jtp.matmul_reduce_scatter(x, w, ax, 0),
                      [i["x_seq3"], i["w_row"]], i["ct_mrs3"])
    col, row = jtp.column_parallel_linear, jtp.row_parallel_linear
    out["col"] = vjp(lambda x, w, b: col(x, w, b, gather_output=True,
                                         axis_name=ax),
                     [i["x_rep"], i["w_col"], i["b_col"]], i["ct_col"])
    for kind, kw in (("", {}), ("_overlap", {"overlap": True}),
                     ("_fused", {"fused": True})):
        out["col_sp" + kind] = vjp(
            lambda x, w: col(x, w, sequence_parallel_enabled=True,
                             axis_name=ax, **kw),
            [i["x"], i["w_col"]], i["ct_agm"])
        out["row_sp" + kind] = vjp(
            lambda x, w: row(x, w, sequence_parallel_enabled=True,
                             axis_name=ax, **kw),
            [i["x_seq"], i["w_row"]], i["ct_mrs"])
    out["row"] = vjp(lambda x, w, b: row(x, w, b, axis_name=ax),
                     [i["x"], i["w_row"], i["b_row"]], i["ct_row"])
    out["row_scatter"] = vjp(
        lambda x, w: row(x, w, input_is_parallel=False, axis_name=ax),
        [i["x_wide"], i["w_row"]], i["ct_row"])
    out["embedding"] = vjp(lambda t: jtp.vocab_parallel_embedding(
        i["tokens"], t, axis_name=ax), [i["table"]], i["ct_emb"])
    for ls in (0.0, 0.1):
        out[f"vpce_{ls}"] = vjp(
            lambda lg: jtp.vocab_parallel_cross_entropy(lg, i["labels_s"],
                                                        ls, ax),
            [i["logits"]], i["ct_s"])
    for name, x, kw in (
            ("plain", "xh", {}),
            ("smooth_pad", "xh", dict(label_smoothing=0.1, padding_idx=0)),
            ("classes", "xh", dict(num_classes=V * n - 2)),
            ("sp_input", "xh_seq", dict(sequence_parallel_input=True))):
        out[f"lce_{name}"] = vjp(
            lambda x, w: jtp.vocab_parallel_linear_cross_entropy(
                x, w, i["labels_t"], axis_name=ax, **kw),
            [i[x], i["wv"]], i["ct_t"])
    return out


def _jax_run(n: int, impl: str, inputs: dict) -> dict:
    mesh = make_mesh(tp=n, devices=jax.devices()[:n])
    jin = {k: jnp.asarray(v) for k, v in inputs.items()
           if k != "num_classes"}

    def body(i):
        i = {k: v[0] for k, v in i.items()}
        return jax.tree_util.tree_map(lambda t: t[None], _jax_cases(i, n))

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("tp"),),
                               out_specs=P("tp"), check_vma=False))
    with force_impl(impl):
        return jax.tree_util.tree_map(np.asarray, fn(jin))


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"world{n}")
def world(request):
    n = request.param
    inputs = _inputs(n)
    # the ranks run while JAX compiles
    with ThreadPoolExecutor(1) as ex:
        port = ex.submit(launch, torch_dist_ranks.tp_cases, n, inputs, n,
                         backend="gloo")
        xla, pallas = (_jax_run(n, impl, inputs) for impl in ("xla",
                                                              "pallas"))
        return dict(n=n, port=port.result(), xla=xla, pallas=pallas)


def _check(world, case, impl="xla", key=None, **tol):
    want = world[impl][case]
    for r, got in enumerate(world["port"]):
        got = got[key or case]
        assert len(got) == len(want)
        for j, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g, w[r], err_msg=f"{case} rank {r} "
                                       f"output {j}", **(tol or TOL))


@pytest.mark.parametrize("case", REGIONS + ("agm", "mrs", "mrs3"))
def test_regions_and_rings_match_jax(world, case):
    _check(world, case)


@pytest.mark.parametrize("case", LAYERS)
def test_layers_match_jax(world, case):
    _check(world, case)
    if case.endswith("_fused"):
        _check(world, case, impl="pallas")


def test_fused_layers_equal_overlap_bitwise(world):
    for r, got in enumerate(world["port"]):
        for side in ("col_sp", "row_sp"):
            for a, b in zip(got[side + "_fused"], got[side + "_overlap"]):
                np.testing.assert_array_equal(a, b)


def test_overlap_with_fused_raises(world):
    for got in world["port"]:
        assert got["errors"][0].startswith("ValueError: overlap= and fused=")


@pytest.mark.parametrize("ls", [0.0, 0.1])
def test_vocab_parallel_cross_entropy_matches_jax(world, ls):
    _check(world, f"vpce_{ls}")


@pytest.mark.parametrize("name", LCE)
@pytest.mark.parametrize("fused", ["dec", "fused"])
def test_vocab_parallel_linear_ce_matches_jax(world, name, fused):
    for impl in ("xla", "pallas"):
        _check(world, f"lce_{name}", impl=impl, key=f"lce_{name}_{fused}")


@pytest.mark.parametrize("name", LCE)
def test_fused_linear_ce_equals_decomposed(world, name):
    """Bit for bit at world 2; within 1e-6 relative at world 4."""
    for got in world["port"]:
        for a, b in zip(got[f"lce_{name}_fused"], got[f"lce_{name}_dec"]):
            if world["n"] == 2:
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", LCE)
def test_linear_ce_all_reduce_count_2_vs_4(world, name):
    """The torch counterpart of the JAX suite's HLO collective count:
    the fused merge's forward makes 2 all-reduces, the decomposed 4."""
    gather = 1 if name == "sp_input" else 0
    for got in world["port"]:
        (f_fwd, f_bwd), (d_fwd, d_bwd) = (got[f"lce_{name}_fused_counts"],
                                          got[f"lce_{name}_dec_counts"])
        assert (f_fwd["all_reduce"], d_fwd["all_reduce"]) == (2, 4)
        assert f_fwd["all_gather"] == d_fwd["all_gather"] == gather
        # the backward: the input's copy region all-reduces dx, or the
        # sequence-parallel gather reduce-scatters it
        assert f_bwd["all_reduce"] - f_fwd["all_reduce"] == 1 - gather
        assert d_bwd["all_reduce"] - d_fwd["all_reduce"] == 1 - gather
        assert f_bwd["reduce_scatter"] == d_bwd["reduce_scatter"] == gather


def test_mesh_and_parallel_state(world):
    n = world["n"]
    jmesh = make_mesh(tp=n, devices=jax.devices()[:n])
    devs = np.asarray(jmesh.devices)
    for r, got in enumerate(world["port"]):
        st = got["state"]
        want = [int(c[0]) for c in np.nonzero(devs == jax.devices()[r])]
        assert st["coords"] == want
        assert st["sizes"] == [n, 1, 1, n]
        assert st["ranks"] == [r, 0]
        assert st["tp_ranks"] == list(range(n))
        assert st["errors"][0].startswith("RuntimeError: model parallel "
                                          "already initialized")
        # an fsdp mesh of every rank: rank r at device r's coordinate,
        # the whole world one data-parallel (dp x fsdp) group
        fdevs = np.asarray(make_mesh(fsdp=n, dp=1,
                                     devices=jax.devices()[:n]).devices)
        assert st["fsdp"]["shape"] == [1, n, 1, 1, 1, 1]
        assert st["fsdp"]["coords"] == [
            int(c[0]) for c in np.nonzero(fdevs == jax.devices()[r])]
        assert st["fsdp"]["data_ranks"] == list(range(n))
        assert st["fsdp"]["data_size"] == n
