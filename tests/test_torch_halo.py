"""The port's halo exchange and spatially split bottleneck against the
JAX package's, on the CPU.

Gloo worlds 2 and 4 (`apex1_tpu_torch.parallel.launch`, body in
tests/torch_dist_ranks.py) on a cp axis of n ranks; JAX runs the same
under ``shard_map`` on its 8-device CPU mesh (device r holds rank r's
block of the split axis):

- `halo_exchange` with halo 1 and 2, on dim 1 and 2, periodic or not:
  the extended shard and the gradient of <out, ct> bit for bit JAX's
  (its ``ppermute`` transposed);
- `exchange_overlap` equal to `halo_exchange` plus ``interior_fn``, and
  with ``halo=0`` the shard itself;
- `spatial_conv2d` (an OIHW weight) on H and W within 1e-5 of JAX's
  (tests/test_contrib.py:180-196, its HWIO kernel) and of the unsplit
  SAME convolution;
- `SpatialBottleneck` (tests/test_models.py:154-185: tiny config,
  features 4, x of 2 x 16 x 8 x 16), train and eval: the output within
  JAX's own 2e-4 of JAX's sharded module; the grads of x and of every
  param and the new batch statistics within 2e-4 of JAX's per device;
  and against the port's plain `Bottleneck` on the whole activation:
  the outputs and dx concatenated, the params' grads summed over the
  ranks and the statistics equal within 2e-4;
- a halo larger than the shard raises ValueError, as JAX's.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from apex1_tpu.core.mesh import make_mesh
from apex1_tpu.models.resnet import Bottleneck as JaxBottleneck
from apex1_tpu.models.resnet import ResNetConfig as JaxResNetConfig
from apex1_tpu.models.resnet import SpatialBottleneck as JaxSpatial
from apex1_tpu.parallel.halo import (exchange_overlap, halo_exchange,
                                     spatial_conv2d)
from apex1_tpu_torch.interop import _resnet_named
from apex1_tpu_torch.models.resnet import Bottleneck, ResNetConfig
from apex1_tpu_torch.parallel import launch

import torch_dist_ranks

X_SHAPE = (2, 8, 8, 3)
XB_SHAPE = (2, 16, 8, 16)


def _inputs(n: int) -> dict:
    rng = np.random.default_rng(70 + n)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    inputs = {"x": f(*X_SHAPE), "conv_w": f(5, 3, 3, 3),
              "xb": f(*XB_SHAPE), "ctb": f(*XB_SHAPE)}
    for dim in (1, 2):
        for h in (1, 2):
            shape = list(X_SHAPE)
            shape[dim] = shape[dim] // n + 2 * h
            inputs[f"ct{dim}{h}"] = f(n, *shape)
    # the plain block's variables, as tests/test_models.py:154-185 uses
    # them for the split one (the same tree)
    variables = JaxBottleneck(JaxResNetConfig.tiny(), features=4).init(
        jax.random.key(0), jnp.asarray(inputs["xb"]))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    # the port's names and layouts (OIHW weights)
    named = {**_resnet_named(params), **_resnet_named(stats)}
    inputs.update({f"bb.{k}": v for k, v in named.items()})
    return inputs, variables


def _jax_ranks(inputs: dict, variables, n: int) -> dict:
    mesh = make_mesh(cp=n, dp=1, devices=jax.devices()[:n])
    out = {}
    x = jnp.asarray(inputs["x"])
    for dim in (1, 2):
        spec = P(None, "cp") if dim == 1 else P(None, None, "cp")
        for h in (1, 2):
            for periodic in (False, True):
                def body(x, ct, h=h, dim=dim, periodic=periodic):
                    y, vjp = jax.vjp(lambda v: halo_exchange(
                        v, "cp", halo=h, dim=dim, periodic=periodic), x)
                    return y, vjp(ct[0])[0]

                ct = jnp.asarray(inputs[f"ct{dim}{h}"])
                out[f"ex_{dim}_{h}_{periodic}"] = jax.jit(jax.shard_map(
                    body, mesh=mesh, in_specs=(spec, P("cp")),
                    out_specs=(spec, spec)))(x, ct)
        k = jnp.asarray(inputs["conv_w"].transpose(2, 3, 1, 0))
        out[f"conv_{dim}"] = jax.jit(jax.shard_map(
            lambda v, dim=dim: spatial_conv2d(v, k, "cp", dim=dim),
            mesh=mesh, in_specs=spec, out_specs=spec))(x)
        out[f"ov_{dim}"] = jax.jit(jax.shard_map(
            lambda v, dim=dim: exchange_overlap(
                v, lambda u: jnp.tanh(u) * 2.0, "cp", halo=2, dim=dim),
            mesh=mesh, in_specs=spec, out_specs=(spec, spec)))(x)
    out["same_conv"] = jax.lax.conv_general_dilated(
        x, jnp.asarray(inputs["conv_w"].transpose(2, 3, 1, 0)), (1, 1),
        "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    block = JaxSpatial(JaxResNetConfig.tiny(), features=4)
    xb, ctb = jnp.asarray(inputs["xb"]), jnp.asarray(inputs["ctb"])
    for train in (True, False):
        def body(v, xs, ct, train=train):
            def loss(p, xs):
                y, upd = block.apply(
                    {"params": p, "batch_stats": v["batch_stats"]}, xs,
                    train=train, mutable=["batch_stats"])
                return jnp.sum(y * ct), (y, upd["batch_stats"])

            (_, (y, st)), (dp, dx) = jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True)(v["params"], xs)
            per = jax.tree_util.tree_map(lambda t: t[None], (dp, st))
            return y, dx, per

        y, dx, (dp, st) = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(P(), P(None, "cp"), P(None, "cp")),
            out_specs=(P(None, "cp"), P(None, "cp"), P("cp")),
            check_vma=False))(variables, xb, ctb)
        out[f"bottleneck_{train}"] = dict(y=y, dx=dx, grads=dp, stats=st)
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request):
    n = request.param
    inputs, variables = _inputs(n)
    with ThreadPoolExecutor(1) as ex:
        port = ex.submit(launch, torch_dist_ranks.halo_cases, n, inputs, n,
                         backend="gloo")
        want = _jax_ranks(inputs, variables, n)
        return dict(n=n, port=port.result(), want=want, inputs=inputs)


def _block(a, n, r, dim):
    return np.split(np.asarray(a), n, axis=dim)[r]


@pytest.mark.parametrize("dim", [1, 2])
@pytest.mark.parametrize("h", [1, 2])
@pytest.mark.parametrize("periodic", [False, True])
def test_halo_exchange_bitwise(world, dim, h, periodic):
    n = world["n"]
    y, g = world["want"][f"ex_{dim}_{h}_{periodic}"]
    for r, got in enumerate(world["port"]):
        gy, gg = got[f"ex_{dim}_{h}_{periodic}"]
        np.testing.assert_array_equal(gy, _block(y, n, r, dim))
        np.testing.assert_array_equal(gg, _block(g, n, r, dim))


@pytest.mark.parametrize("dim", [1, 2])
def test_exchange_overlap_and_zero_halo(world, dim):
    n, x = world["n"], world["inputs"]["x"]
    ext_w, inner_w = world["want"][f"ov_{dim}"]
    for r, got in enumerate(world["port"]):
        ext, inner, plain = got[f"ov_{dim}"]
        np.testing.assert_array_equal(ext, plain)
        np.testing.assert_array_equal(ext, _block(ext_w, n, r, dim))
        mine = _block(x, n, r, dim)
        np.testing.assert_allclose(inner, np.tanh(mine) * 2.0, rtol=1e-6)
        np.testing.assert_allclose(inner, _block(inner_w, n, r, dim),
                                   rtol=1e-6, atol=1e-7)
        ext0, inner0 = got[f"ov0_{dim}"]
        np.testing.assert_array_equal(ext0, mine)
        np.testing.assert_array_equal(inner0, mine + 1.0)


@pytest.mark.parametrize("dim", [1, 2])
def test_spatial_conv2d(world, dim):
    n = world["n"]
    want, same = world["want"][f"conv_{dim}"], world["want"]["same_conv"]
    for r, got in enumerate(world["port"]):
        np.testing.assert_allclose(got[f"conv_{dim}"], _block(want, n, r, dim),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[f"conv_{dim}"], _block(same, n, r, dim),
                                   rtol=1e-5, atol=1e-5)
    assert all(got["too_big"].startswith("ValueError: halo")
               for got in world["port"])


@pytest.mark.parametrize("train", [True, False])
def test_spatial_bottleneck_matches_jax(world, train):
    n = world["n"]
    want = world["want"][f"bottleneck_{train}"]
    wgrads = [_resnet_named(jax.tree_util.tree_map(lambda t, r=r: t[r],
                                                   want["grads"]))
              for r in range(n)]
    for r, got in enumerate(world["port"]):
        got = got[f"bottleneck_{train}"]
        np.testing.assert_allclose(got["y"], _block(want["y"], n, r, 1),
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got["dx"], _block(want["dx"], n, r, 1),
                                   rtol=2e-4, atol=2e-4)
        for k, g in got["grads"].items():
            np.testing.assert_allclose(g, wgrads[r][k], rtol=2e-4,
                                       atol=2e-4, err_msg=k)
        if train:
            stats = _resnet_named(jax.tree_util.tree_map(
                lambda t, r=r: t[r], want["stats"]))
            for k, v in got["stats"].items():
                np.testing.assert_allclose(v, stats[k[2:]], rtol=2e-4,
                                           atol=2e-4, err_msg=k)


@pytest.mark.parametrize("train", [True, False])
def test_spatial_bottleneck_matches_plain_block(world, train):
    inputs = world["inputs"]
    plain = Bottleneck(ResNetConfig.tiny(), 16, 4, device="cpu")
    plain.load_state_dict({k[3:]: torch.from_numpy(v.copy())
                           for k, v in inputs.items() if k.startswith("bb.")})
    xs = torch.from_numpy(inputs["xb"]).requires_grad_()
    stats = {}
    y = plain(xs.permute(0, 3, 1, 2), train=train, stats=stats,
              prefix="b").permute(0, 2, 3, 1)
    names, params = zip(*plain.named_parameters())
    grads = torch.autograd.grad(
        (y * torch.from_numpy(inputs["ctb"])).sum(), [xs, *params])
    ranks = [got[f"bottleneck_{train}"] for got in world["port"]]
    np.testing.assert_allclose(np.concatenate([g["y"] for g in ranks], 1),
                               y.detach().numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.concatenate([g["dx"] for g in ranks], 1),
                               grads[0].numpy(), rtol=2e-4, atol=2e-4)
    for k, g in zip(names, grads[1:]):
        np.testing.assert_allclose(sum(r["grads"][k] for r in ranks),
                                   g.numpy(), rtol=2e-4, atol=2e-4,
                                   err_msg=k)
    for k, v in stats.items():
        for r in ranks:
            np.testing.assert_allclose(r["stats"][k], v.detach().numpy(),
                                       rtol=2e-4, atol=2e-4, err_msg=k)
