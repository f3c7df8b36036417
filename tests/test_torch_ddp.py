"""The port's data parallelism against the JAX package's, on the CPU.

Four ranks under gloo (`apex1_tpu_torch.parallel.launch`, body in
tests/torch_dist_ranks.py) on a dp 2 x tp 2 mesh; the JAX package runs
the same under ``shard_map`` on its 8-device CPU mesh,
``make_mesh(dp=2, tp=2)``, device r holding rank r's inputs:

- rank r sits at device r's mesh coordinate;
- `allreduce_grads` with ``gradient_predivide_factor=2`` (an integer
  leaf passes through), `broadcast_params` and
  `DistributedDataParallel.value_and_grad` equal JAX's within 1e-6;
- 3 O2 steps of a tiny GPT-2 through ``Amp(fused_adam(1e-3),
  grad_psum_axes=("dp",))``, each dp rank on its half of the batch:
  losses, grad norms and parameters within the O2 trajectory bound of
  tests/test_torch_amp.py (2e-2 relative) of JAX's, and the parameters
  bit-identical on all four ranks;
- `launch` fails within seconds when a rank raises while its peers wait
  on it in a collective, and `init_distributed` refuses NCCL without a
  card rather than switching to gloo.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from apex1_tpu.amp import Amp as JaxAmp
from apex1_tpu.core.mesh import MESH_AXES, make_mesh
from apex1_tpu.core.policy import get_policy as jax_get_policy
from apex1_tpu.models.gpt2 import GPT2 as JaxGPT2
from apex1_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from apex1_tpu.models.gpt2 import gpt2_loss_fn as jax_gpt2_loss_fn
from apex1_tpu.optim.fused_adam import fused_adam as jax_fused_adam
from apex1_tpu.parallel import ddp as jddp
from apex1_tpu_torch.interop import flax_from_named
from apex1_tpu_torch.parallel import launch

import torch_dist_ranks

N, STEPS, B, S = 4, 3, 4, 16


def _inputs() -> dict:
    rng = np.random.default_rng(30)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"ga": f(N, 3, 5), "gb": f(N, 7), "step": np.arange(N, dtype=
                                                                np.int32),
            "w": np.stack([f(5, 2)] * N), "xb": f(N, 6, 5), "yb": f(N, 6, 2)}


def _gpt2():
    kw = dict(vocab_size=250, use_flash=False)
    cfg = JaxGPT2Config.tiny(policy=jax_get_policy("O0"), **kw)
    tokens = np.random.default_rng(0).integers(0, 250, (B, S)).astype(
        np.int32)
    params = jax.jit(JaxGPT2(cfg).init)(jax.random.key(0),
                                        jnp.asarray(tokens))["params"]
    return dict(kw=kw, tokens=tokens,
                params=jax.tree_util.tree_map(np.asarray, params))


def _mesh():
    return make_mesh(dp=2, tp=2, devices=jax.devices()[:N])


def _jax_collectives(inputs):
    def body(i):
        i = {k: v[0] for k, v in i.items()}
        grads = {"a": i["ga"], "b": i["gb"], "step": i["step"]}
        out = {"allreduce": jddp.allreduce_grads(
            grads, axis_names=("dp",), gradient_predivide_factor=2.0),
            "broadcast": jddp.broadcast_params({"a": i["ga"]})}

        def loss_fn(p, x, y):
            return jnp.mean((x @ p["w"] - y) ** 2)

        ddp = jddp.DistributedDataParallel(loss_fn,
                                           gradient_predivide_factor=2.0)
        loss, g = ddp.value_and_grad()({"w": i["w"]}, i["xb"], i["yb"])
        out["ddp"] = [loss, g["w"]]
        return jax.tree_util.tree_map(lambda t: t[None], out)

    spec = P(("dp", "tp"))
    fn = jax.jit(jax.shard_map(body, mesh=_mesh(), in_specs=(spec,),
                               out_specs=spec, check_vma=False))
    return jax.tree_util.tree_map(
        np.asarray, fn({k: jnp.asarray(v) for k, v in inputs.items()}))


def _jax_amp(gpt2):
    cfg = JaxGPT2Config.tiny(policy=jax_get_policy("O2"), **gpt2["kw"])
    amp = JaxAmp(jax_fused_adam(1e-3, weight_decay=0.01), opt_level="O2",
                 grad_psum_axes=("dp",))
    step = jax.jit(jax.shard_map(
        amp.make_train_step(jax_gpt2_loss_fn(JaxGPT2(cfg),
                                             fuse_head=False)),
        mesh=_mesh(), in_specs=(P(), P("dp")), out_specs=P(),
        check_vma=False))
    state = amp.init(gpt2["params"])
    rows = []
    for _ in range(STEPS):
        state, m = step(state, jnp.asarray(gpt2["tokens"]))
        rows.append(jax.tree_util.tree_map(np.asarray, m))
    return rows, jax.tree_util.tree_map(np.asarray, state.params)


@pytest.fixture(scope="module")
def world():
    inputs, gpt2 = _inputs(), _gpt2()
    with ThreadPoolExecutor(1) as ex:
        port = ex.submit(launch, torch_dist_ranks.ddp_cases, N, inputs,
                         gpt2, STEPS, backend="gloo")
        coll = _jax_collectives(inputs)
        rows, params = _jax_amp(gpt2)
        return dict(port=port.result(), coll=coll, rows=rows, params=params)


def test_rank_r_sits_at_device_r(world):
    devs = np.asarray(_mesh().devices)
    for r, got in enumerate(world["port"]):
        want = [int(c[0]) for c in np.nonzero(devs == jax.devices()[r])]
        assert got["coords"] == want
        assert dict(zip(MESH_AXES, got["coords"]))["dp"] == r // 2


@pytest.mark.parametrize("case", ["allreduce", "broadcast"])
def test_grad_collectives_match_jax(world, case):
    want = world["coll"][case]
    for r, got in enumerate(world["port"]):
        assert set(got[case]) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(got[case][k], w[r], rtol=1e-6,
                                       atol=1e-7, err_msg=k)


def test_ddp_value_and_grad_matches_jax(world):
    want = world["coll"]["ddp"]
    for r, got in enumerate(world["port"]):
        for g, w in zip(got["ddp"], want):
            np.testing.assert_allclose(g, w[r], rtol=1e-6, atol=1e-7)


def test_amp_grad_psum_axes_three_o2_steps_match_jax(world):
    for r, got in enumerate(world["port"]):
        for m, jm in zip(got["amp"]["metrics"], world["rows"]):
            np.testing.assert_allclose(m["loss"], jm["loss"], rtol=2e-2)
            np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"],
                                       rtol=2e-2)
            assert bool(m["grads_finite"])
        # the distance over all params relative to their norm, as in
        # tests/test_torch_amp.py's O2 trajectory
        got_l = jax.tree_util.tree_leaves(flax_from_named(
            got["amp"]["params"]))
        want_l = jax.tree_util.tree_leaves(world["params"])
        dist = np.sqrt(sum(np.sum((g - w) ** 2)
                           for g, w in zip(got_l, want_l)))
        norm = np.sqrt(sum(np.sum(w ** 2) for w in want_l))
        assert dist <= 2e-2 * norm, (r, dist / norm)


def test_amp_params_bit_identical_across_ranks(world):
    first = world["port"][0]["amp"]
    for got in world["port"][1:]:
        for k, v in first["params"].items():
            np.testing.assert_array_equal(got["amp"]["params"][k], v)
        for m, m0 in zip(got["amp"]["metrics"], first["metrics"]):
            np.testing.assert_array_equal(m["loss"], m0["loss"])


def test_launch_fails_fast_on_a_broken_rank():
    """A rank that raises fails the launch with its traceback within a
    few seconds, though its peers wait on it in a collective."""
    import time
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 is broken"):
        launch(torch_dist_ranks.broken, 2, 2, backend="gloo", timeout=30)
    assert time.monotonic() - t0 < 25


def test_nccl_without_a_card_raises():
    """NCCL is the default backend; with no CUDA device it raises and
    names gloo instead of switching on its own."""
    import torch
    from apex1_tpu_torch.parallel import init_distributed
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        init_distributed(init_method="file:///nonexistent", rank=0,
                         world_size=1)
