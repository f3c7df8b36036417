"""The port's ZeRO-style sharded optimizers and their specs against the
JAX package's, on the CPU.

Gloo worlds 2 and 4 (`apex1_tpu_torch.parallel.launch`, body in
tests/torch_dist_ranks.py) at fsdp = n, every rank with the same
gradients (the mean over the ranks is then the gradient), flat lengths
that are no multiple of the world (71 for Adam; 46 for LAMB at world
4):

- `distributed_fused_adam(1e-2, weight_decay=0.01)`, 3 steps, against
  JAX's unsharded ``FusedAdam`` (tests/test_parallel.py:207-242): the
  params and the moments (the ranks' slices gathered and unflattened in
  the port's order) within 1e-6;
- `distributed_fused_lamb` with weight decay, with ``use_nvlamb`` and
  with neither, 2 steps, against JAX's unsharded ``fused_lamb``
  (tests/test_parallel.py:253-296) within 1e-6;
- a step's collectives equal the JAX optimizer's under ``shard_map``
  (its jaxpr's ``psum``, ``reduce_scatter`` and ``all_gather``): 1
  reduce-scatter and 1 all-gather, LAMB 3 all-reduces with weight
  decay or ``use_nvlamb``, else 1;
- the placed training of tests/test_parallel.py:319-360 (at fsdp = 2
  as there, and at 4):
  params placed by `fsdp_param_specs` (w1 split on its dim 1),
  moments by `shard_opt_state_specs`, the params gathered in the loss,
  3 fused-Adam steps: loss and params within 1e-6 of JAX's unsharded
  run, each rank holding its block;
- 2 O0 steps of ``Amp(grad_psum_axes=("dp", "fsdp"))``, each rank on
  its rows, against JAX's Amp under ``shard_map`` within 1e-6;
- `shard_batch`, `replicate`, `MeshResource`, the size helpers,
  `local_mesh` and `make_hybrid_mesh` (rank r at device r's coordinate
  of JAX's hybrid mesh with the same slices).

On one process: `fsdp_param_specs` (``min_size``, ``divisor``, the
square-weight tie) and `shard_opt_state_specs` equal JAX's per
counterpart leaf of a tiny GPT-2 (the port's ``nn.Linear`` weights
transposed, so a flax kernel's spec reversed), and on JAX's own test
trees; `flat_param_len`, `shard_padded_len` and `repack_flat_shard`
bit for bit with JAX's, their ValueErrors too.
"""

from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from apex1_tpu.core.mesh import make_mesh
from apex1_tpu.models.gpt2 import GPT2 as JaxGPT2
from apex1_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from apex1_tpu.optim import FusedAdam
from apex1_tpu.optim.fused_adam import fused_adam as jax_fused_adam
from apex1_tpu.optim.fused_lamb import fused_lamb as jax_fused_lamb
from apex1_tpu.parallel import distributed_optimizer as jdo
from apex1_tpu_torch.interop import gpt2_params_from_jax
from apex1_tpu_torch.models.gpt2 import GPT2Config
from apex1_tpu_torch.optim import fused_adam
from apex1_tpu_torch.parallel import distributed_optimizer as tdo
from apex1_tpu_torch.parallel import launch

import torch_dist_ranks

LAMB_CASES = {"lamb_wd": dict(weight_decay=0.01),
              "lamb_nv": dict(weight_decay=0.0, use_nvlamb=True),
              "lamb_plain": dict(weight_decay=0.0)}
_PRIM = {"psum": "all_reduce", "reduce_scatter": "reduce_scatter",
         "all_gather": "all_gather"}


def _inputs() -> dict:
    rng = np.random.default_rng(60)

    def f(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {"w": f(13, 5), "b": f(6), "gw": f(3, 13, 5, scale=0.1),
            "gb": f(3, 6, scale=0.1), "lw": f(5, 7), "lb": f(11),
            "lgw": f(5, 7), "lgb": f(11), "w1": f(16, 64), "w2": f(64, 8),
            "x": f(16, 16), "y": f(16, 8), "aw": f(16, 8)}


def _jax_adam(i) -> dict:
    gold_opt = FusedAdam(lr=1e-2, weight_decay=0.01)
    gold = {"w": jnp.asarray(i["w"]), "b": jnp.asarray(i["b"])}
    st = gold_opt.init(gold)
    for k in range(3):
        gold, st = gold_opt.step({"w": jnp.asarray(i["gw"][k]),
                                  "b": jnp.asarray(i["gb"][k])}, st, gold)
    return dict(params=gold, exp_avg=st.exp_avg, exp_avg_sq=st.exp_avg_sq)


def _jax_lamb(i) -> dict:
    out = {}
    params = {"w": jnp.asarray(i["lw"]), "b": jnp.asarray(i["lb"])}
    grads = {"w": jnp.asarray(i["lgw"]), "b": jnp.asarray(i["lgb"])}
    for name, kw in LAMB_CASES.items():
        tx = jax_fused_lamb(1e-2, **kw)
        st, p = tx.init(params), params
        for _ in range(2):
            upd, st = tx.update(grads, st, p)
            p = optax.apply_updates(p, upd)
        out[name] = p
    return out


def _jax_counts(i, n) -> dict:
    """The collectives of one JAX step under ``shard_map`` at fsdp=n,
    read from its jaxpr."""
    mesh = make_mesh(fsdp=n, dp=1, devices=jax.devices()[:n])

    def count(opt, p, g):
        def run(p, g):
            return opt.step(g, opt.init(p), p)[0]

        jaxpr = jax.make_jaxpr(jax.shard_map(
            run, mesh=mesh, in_specs=(P(), P()), out_specs=P(),
            check_vma=False))(p, g)
        c = Counter()

        def walk(j):
            for e in j.eqns:
                if e.primitive.name in _PRIM:
                    c[_PRIM[e.primitive.name]] += 1
                for v in e.params.values():
                    sub = getattr(v, "jaxpr", v)
                    if hasattr(sub, "eqns"):
                        walk(sub)

        walk(jaxpr.jaxpr)
        return dict(c)

    adam_p = {"w": jnp.asarray(i["w"]), "b": jnp.asarray(i["b"])}
    lamb_p = {"w": jnp.asarray(i["lw"]), "b": jnp.asarray(i["lb"])}
    out = {"adam": count(jdo.distributed_fused_adam(1e-2, weight_decay=0.01),
                         adam_p, adam_p)}
    for name, kw in LAMB_CASES.items():
        out[name] = count(jdo.distributed_fused_lamb(1e-2, **kw), lamb_p,
                          lamb_p)
    return out


def _jax_placed(i) -> dict:
    """tests/test_parallel.py:319-360's unsharded reference."""
    tx = jax_fused_adam(1e-2)
    params = {"w1": jnp.asarray(i["w1"]), "w2": jnp.asarray(i["w2"])}
    x, y = jnp.asarray(i["x"]), jnp.asarray(i["y"])

    def loss_fn(p):
        return jnp.mean(jnp.square(jnp.tanh(x @ p["w1"]) @ p["w2"] - y))

    def train(p, st):
        for _ in range(3):
            g = jax.grad(loss_fn)(p)
            up, st = tx.update(g, st, p)
            p = jax.tree.map(jnp.add, p, up)
        return p, loss_fn(p)

    p, loss = jax.jit(train)(params, tx.init(params))
    pspecs = jdo.fsdp_param_specs(params, min_size=64)
    sspecs = jdo.shard_opt_state_specs(tx.init(params), axis="fsdp",
                                       param_specs=pspecs)
    return dict(params=jax.tree.map(np.asarray, p), loss=float(loss),
                pspecs=pspecs, sspecs=sspecs)


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request):
    n = request.param
    inputs = _inputs()
    with ThreadPoolExecutor(1) as ex:
        port = ex.submit(launch, torch_dist_ranks.zero_cases, n, inputs, n,
                         backend="gloo")
        want = dict(adam=_jax_adam(inputs), lamb=_jax_lamb(inputs),
                    counts=_jax_counts(inputs, n), placed=_jax_placed(inputs))
        return dict(n=n, port=port.result(), want=want)


def _close(got, want, err=""):
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6,
                               err_msg=err)


def test_distributed_adam_matches_unsharded(world):
    want = world["want"]["adam"]
    for r, got in enumerate(world["port"]):
        for k in ("w", "b"):
            _close(got["adam"]["params"][k], want["params"][k], f"{r} {k}")
            _close(got["adam"]["moments"]["exp_avg_shard"][k],
                   want["exp_avg"][k], f"{r} m {k}")
            _close(got["adam"]["moments"]["exp_avg_sq_shard"][k],
                   want["exp_avg_sq"][k], f"{r} v {k}")


@pytest.mark.parametrize("case", list(LAMB_CASES))
def test_distributed_lamb_matches_full_lamb(world, case):
    want = world["want"]["lamb"][case]
    for r, got in enumerate(world["port"]):
        for k in ("w", "b"):
            _close(got[case]["params"][k], want[k], f"{r} {k}")


def test_collectives_match_jax(world):
    want = world["want"]["counts"]
    for got in world["port"]:
        for c in got["adam"]["counts"]:
            assert {k: v for k, v in c.items() if v} == want["adam"]
        assert want["adam"] == {"reduce_scatter": 1, "all_gather": 1}
        for case in LAMB_CASES:
            assert {k: v for k, v in got[case]["counts"].items()
                    if v} == want[case]
        assert want["lamb_wd"]["all_reduce"] == 3
        assert want["lamb_plain"]["all_reduce"] == 1


def test_placed_training_matches_unsharded(world):
    want = world["want"]["placed"]
    for r, got in enumerate(world["port"]):
        got = got["placed"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
        for k in ("w1", "w2"):
            _close(got["params"][k], want["params"][k], k)
            assert tuple(got["pspecs"][k]) == tuple(want["pspecs"][k])
            assert tuple(got["sspecs"][k]) == tuple(
                want["sspecs"].exp_avg[k])
        assert [tuple(p) for p in got["placements"]["w1"]] == [("Shard", 1)]
        np.testing.assert_array_equal(got["local"]["w1"], np.split(
            got["params"]["w1"], world["n"], axis=1)[r])


def test_amp_reduces_over_dp_and_fsdp(world):
    """``Amp(grad_psum_axes=("dp", "fsdp"))`` averages the gradients and
    the loss over both axes, as JAX's under ``shard_map``: 2 O0 steps,
    each rank on its rows, params and losses within 1e-6."""
    from apex1_tpu.amp import Amp as JaxAmp
    n, i = world["n"], _inputs()
    mesh = make_mesh(fsdp=n, dp=1, devices=jax.devices()[:n])
    amp = JaxAmp(jax_fused_adam(1e-2), opt_level="O0",
                 grad_psum_axes=("dp", "fsdp"))
    step = jax.jit(jax.shard_map(
        amp.make_train_step(lambda p, x, y: jnp.mean(
            jnp.square(jnp.tanh(x @ p["w"]) - y))),
        mesh=mesh, in_specs=(P(), P("fsdp"), P("fsdp")), out_specs=P(),
        check_vma=False))
    state, losses = amp.init({"w": jnp.asarray(i["aw"])}), []
    for _ in range(2):
        state, m = step(state, jnp.asarray(i["x"]), jnp.asarray(i["y"]))
        losses.append(float(m["loss"]))
    for got in world["port"]:
        _close(got["amp"]["params"]["w"], state.params["w"])
        np.testing.assert_allclose(got["amp"]["losses"], losses, rtol=1e-6)


def test_mesh_helpers_match_jax(world):
    """`shard_batch` keeps this rank's rows of the batch axis (dp x
    fsdp), `replicate` the whole tensor; `MeshResource.spec`, the sizes
    and `local_mesh` as JAX's; `make_hybrid_mesh` (two slices of tp =
    n / 2) puts rank r at device r's coordinate of JAX's hybrid mesh
    with the same slices (``granule_ids``)."""
    from apex1_tpu.core import mesh as jmesh
    n = world["n"]
    inputs = _inputs()
    jm = jmesh.make_mesh(fsdp=n, dp=1, devices=jax.devices()[:n])
    hybrid = np.asarray(jmesh.make_hybrid_mesh(
        jmesh.MeshConfig(tp=n // 2), dcn_dp=2, devices=jax.devices()[:n],
        granule_ids=[r // (n // 2) for r in range(n)]).devices)
    for r, got in enumerate(world["port"]):
        m = got["mesh"]
        np.testing.assert_array_equal(m["batch"],
                                      np.split(inputs["x"], n)[r])
        np.testing.assert_array_equal(m["rep"], inputs["y"])
        assert tuple(tuple(a) if isinstance(a, list) else a
                     for a in m["spec"]) == tuple(
            jmesh.MeshResource().spec("batch", None, "heads"))
        assert m["sizes"] == [jmesh.axis_size(jm, ax)
                              for ax in jmesh.MESH_AXES]
        assert m["local"] == m["sizes"]
        assert m["data_size"] == jmesh.data_parallel_size(jm) == n
        assert m["hybrid_shape"] == list(hybrid.shape)
        assert m["hybrid_coords"] == [
            int(c[0]) for c in np.nonzero(hybrid == jax.devices()[r])]


# ---- one process --------------------------------------------------------


def _flax_path(name: str):
    """The flax path of a port parameter name and whether the port's
    tensor is the flax leaf transposed."""
    parts = name.split(".")
    if parts[0] == "h":
        parts = [f"h{parts[1]}"] + parts[2:]
    transposed = parts[-1] == "weight"
    if transposed:
        parts[-1] = "kernel"
    return parts, transposed


def _leaf(tree, parts):
    for p in parts:
        tree = tree[p]
    return tree


def _port_spec_of(jax_spec, ndim: int, transposed: bool) -> tuple:
    spec = tuple(jax_spec) + (None,) * (ndim - len(jax_spec))
    return tuple(reversed(spec)) if transposed else spec


@pytest.fixture(scope="module")
def gpt2():
    cfg = JaxGPT2Config.tiny()
    tokens = jnp.zeros((1, 8), jnp.int32)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(JaxGPT2(cfg).init)(
        jax.random.key(0), tokens)["params"])
    model = gpt2_params_from_jax(params, GPT2Config.tiny(), "cpu")
    return params, {k: v.detach() for k, v in model.named_parameters()}


def _trimmed(spec) -> tuple:
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


@pytest.mark.parametrize("kw", [dict(), dict(min_size=1),
                                dict(min_size=1, divisor=3),
                                dict(min_size=1, divisor=8)],
                         ids=["default", "min1", "div3", "div8"])
def test_fsdp_param_specs_match_jax(gpt2, kw):
    jparams, tparams = gpt2
    want = jdo.fsdp_param_specs(jparams, **kw)
    got = tdo.fsdp_param_specs(tparams, **kw)
    assert set(got) == set(tparams)
    for name, t in tparams.items():
        parts, transposed = _flax_path(name)
        w = _leaf(want, parts)
        assert _trimmed(got[name]) == _trimmed(
            _port_spec_of(w, t.dim(), transposed)), (name, got[name], w)
    # the square-weight tie: flax splits the proj kernel's dim 0 (its
    # input features), the port the same features, its weight's dim 1
    if kw.get("min_size") == 1 and not kw.get("divisor"):
        assert got["h.0.proj.weight"] == (None, "fsdp")


def test_fsdp_and_opt_state_specs_on_jax_trees():
    shapes = {"big": (64, 256), "tall": (4096,), "small": (4, 4), "s": ()}
    jp = {k: jnp.zeros(s) for k, s in shapes.items()}
    tp = {k: torch.zeros(s) for k, s in shapes.items()}
    for kw in (dict(min_size=128), dict(min_size=1, divisor=8)):
        want = jdo.fsdp_param_specs(jp, **kw)
        got = tdo.fsdp_param_specs(tp, **kw)
        assert {k: tuple(v) for k, v in got.items()} == {
            k: tuple(v) for k, v in want.items()}
    odd = {"emb": (50257, 768)}
    for kw in (dict(min_size=1), dict(min_size=1, divisor=8)):
        assert tuple(tdo.fsdp_param_specs(
            {"emb": torch.empty(odd["emb"], device="meta")}, **kw)["emb"]) \
            == tuple(jdo.fsdp_param_specs(
                {"emb": jnp.zeros(odd["emb"])}, **kw)["emb"])
    # moments: dim 0 of every leaf, or the params' specs verbatim
    jst = FusedAdam(lr=1e-3).init({"w": jnp.zeros((16, 4)),
                                   "b": jnp.zeros(())})
    tst = fused_adam(1e-3).init({"w": torch.zeros(16, 4),
                                 "b": torch.zeros(())})
    want, got = jdo.shard_opt_state_specs(jst), tdo.shard_opt_state_specs(tst)
    for field in ("exp_avg", "exp_avg_sq"):
        for k in ("w", "b"):
            assert tuple(getattr(got, field)[k]) == tuple(
                getattr(want, field)[k])
    assert tuple(got.step) == tuple(want.step) == ()
    pspecs = {"w": tdo.P(None, "fsdp"), "b": tdo.P()}
    got = tdo.shard_opt_state_specs(tst, param_specs=pspecs)
    want = jdo.shard_opt_state_specs(jst, param_specs={"w": P(None, "fsdp"),
                                                       "b": P()})
    assert got.exp_avg == pspecs and tuple(want.exp_avg["w"]) == (
        None, "fsdp")


def test_opt_state_specs_of_gpt2_follow_the_params(gpt2):
    jparams, tparams = gpt2
    jps = jdo.fsdp_param_specs(jparams, min_size=1)
    tps = tdo.fsdp_param_specs(tparams, min_size=1)
    want = jdo.shard_opt_state_specs(FusedAdam(lr=1e-3).init(jparams),
                                     param_specs=jps)
    got = tdo.shard_opt_state_specs(fused_adam(1e-3).init(tparams),
                                    param_specs=tps)
    assert tuple(got.step) == tuple(want.step)
    for name, t in tparams.items():
        parts, transposed = _flax_path(name)
        assert _trimmed(got.exp_avg_sq[name]) == _trimmed(_port_spec_of(
            _leaf(want.exp_avg_sq, parts), t.dim(), transposed))


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("n,wf,wt", [(71, 2, 4), (71, 4, 1), (72, 4, 2),
                                     (10, 3, 7), (64, 8, 8)])
def test_flat_lengths_and_repack_bitwise(n, wf, wt):
    jp = {"a": jnp.zeros((n - 3,)), "b": jnp.zeros((3,)),
          "i": jnp.zeros((5,), jnp.int32)}
    tp = {"a": torch.zeros(n - 3), "b": torch.zeros(3),
          "i": torch.zeros(5, dtype=torch.int32)}
    assert tdo.flat_param_len(tp) == jdo.flat_param_len(jp) == n
    for w in (1, 2, 3, 4, 8):
        assert tdo.shard_padded_len(n, w) == jdo.shard_padded_len(n, w)
    flat = np.random.default_rng(n).standard_normal(
        jdo.shard_padded_len(n, wf)).astype(np.float32)
    flat[n:] = 0.0
    got = tdo.repack_flat_shard(flat, flat_len=n, world_from=wf, world_to=wt)
    want = jdo.repack_flat_shard(flat, flat_len=n, world_from=wf,
                                 world_to=wt)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    for bad in (flat[:-1], flat.reshape(1, -1)):
        e = _error(lambda: tdo.repack_flat_shard(
            bad, flat_len=n, world_from=wf, world_to=wt))
        assert e is not None and e == _error(lambda: jdo.repack_flat_shard(
            bad, flat_len=n, world_from=wf, world_to=wt))
