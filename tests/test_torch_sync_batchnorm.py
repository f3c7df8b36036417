"""The port's SyncBatchNorm against the JAX package's, on the CPU.

Cross-replica: 2 and 4 ranks under gloo (`apex1_tpu_torch.parallel.
launch`, body in tests/torch_dist_ranks.py) against JAX's
``SyncBatchNorm(axis_name="dp")`` under ``shard_map`` on its 8-device
CPU mesh (device r holds rank r's x), at world 4 also with
``group_size=2`` (two groups of two): per rank y, the grads of
<y, ct> for x, γ and β (the sum's backward all-reduces, as JAX's psum
transpose), and the new running statistics, within 1e-5; the
module's forward writes the same statistics into its buffers.

Local (no group bound): y, the three grads and the running statistics
against JAX's ``axis_name=None`` path (two-pass variance) within 1e-5
in fp32, and with bf16 x and γ/β (the O2 casts) within bf16's rounding;
evaluation with the running statistics; `convert_syncbn_model` on a
torch model with ``nn.BatchNorm2d`` (channel axis 1) equal to torch's
own batch norm in training and evaluation, its running statistics too.
"""

import copy
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from apex1_tpu.core.mesh import make_mesh
from apex1_tpu.parallel.sync_batchnorm import SyncBatchNorm as JaxSyncBN
from apex1_tpu_torch.parallel import (SyncBatchNorm, convert_syncbn_model,
                                      launch)

import torch_dist_ranks

B, H, W, C = 3, 2, 5, 4
GROUPS = {2: [None], 4: [None, 2]}


def _inputs(n: int) -> dict:
    rng = np.random.default_rng(40 + n)

    def f(*shape, scale=1.0, shift=0.0):
        return (rng.standard_normal(shape) * scale + shift).astype(
            np.float32)

    return {"x": f(n, B, H, W, C, scale=2.0, shift=0.5),
            "ct": f(n, B, H, W, C), "scale": f(C, scale=0.1, shift=1.0),
            "bias": f(C, scale=0.1), "mean": f(C, scale=0.1),
            "var": np.abs(f(C)) + 0.5}


def _jax_cases(inputs: dict, n: int, group_size) -> dict:
    bn = JaxSyncBN(num_features=C, axis_name="dp", group_size=group_size,
                   use_running_average=False)
    params = {"scale": inputs["scale"], "bias": inputs["bias"]}
    stats = {"mean": inputs["mean"], "var": inputs["var"]}

    def body(x, ct):
        def loss(x_, p):
            y, upd = bn.apply({"params": p, "batch_stats": stats}, x_,
                              mutable=["batch_stats"])
            return jnp.sum(y * ct[0]), (y, upd["batch_stats"])

        (_, (y, st)), (dx, dp) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(x[0], params)
        out = dict(y=y, dx=dx, dscale=dp["scale"], dbias=dp["bias"],
                   mean=st["mean"], var=st["var"])
        return jax.tree_util.tree_map(lambda t: t[None], out)

    mesh = make_mesh(dp=n, devices=jax.devices()[:n])
    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("dp"), P("dp")),
                               out_specs=P("dp"), check_vma=False))
    return jax.tree_util.tree_map(np.asarray, fn(inputs["x"], inputs["ct"]))


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request):
    n = request.param
    inputs = _inputs(n)
    with ThreadPoolExecutor(1) as ex:
        port = ex.submit(launch, torch_dist_ranks.sync_bn_cases, n, inputs,
                         GROUPS[n], backend="gloo")
        want = {str(gs): _jax_cases(inputs, n, gs) for gs in GROUPS[n]}
        return dict(n=n, port=port.result(), want=want)


def test_synced_outputs_grads_and_stats_match_jax(world):
    for case, want in world["want"].items():
        for r, got in enumerate(world["port"]):
            g = got[case]
            for k in ("y", "dx", "dscale", "dbias", "mean", "var"):
                np.testing.assert_allclose(
                    g[k], want[k][r], rtol=1e-5, atol=1e-5,
                    err_msg=f"group_size {case} rank {r} {k}")
            np.testing.assert_array_equal(g["buffers"][0], g["mean"])
            np.testing.assert_array_equal(g["buffers"][1], g["var"])
    if world["n"] == 4:
        # two groups of two: the groups' statistics differ
        assert not np.allclose(world["port"][0]["2"]["mean"],
                               world["port"][2]["2"]["mean"])


def _local(dtype: str, use_running_average: bool):
    inputs = _inputs(1)
    x, ct = inputs["x"][0], inputs["ct"][0]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    bn = JaxSyncBN(num_features=C, axis_name=None,
                   use_running_average=use_running_average)
    params = {"scale": jnp.asarray(inputs["scale"], jdt),
              "bias": jnp.asarray(inputs["bias"], jdt)}
    stats = {"mean": inputs["mean"], "var": inputs["var"]}

    def loss(x_, p):
        y, upd = bn.apply({"params": p, "batch_stats": stats}, x_,
                          mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * ct), (y, upd["batch_stats"])

    (_, (jy, jst)), (jdx, jdp) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jnp.asarray(x, jdt), params)
    tbn = SyncBatchNorm(C, axis_name=None, device="cpu")
    with torch.no_grad():
        for k in ("mean", "var"):
            getattr(tbn, k).copy_(torch.from_numpy(inputs[k]))
    # γ and β in x's dtype, as the amp step's casts hand them in
    tp = {k: torch.nn.Parameter(torch.from_numpy(inputs[k]).to(tdt))
          for k in ("scale", "bias")}
    tbn.scale, tbn.bias = tp["scale"], tp["bias"]
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    ty, tst = tbn.stats_forward(tx, use_running_average=use_running_average)
    g = torch.autograd.grad((ty.float() * torch.from_numpy(ct)).sum(),
                            [tx, tp["scale"], tp["bias"]])
    assert ty.dtype == tdt
    got = dict(y=ty, dx=g[0], dscale=g[1], dbias=g[2], mean=tst["mean"],
               var=tst["var"])
    want = dict(y=jy, dx=jdx, dscale=jdp["scale"], dbias=jdp["bias"],
                mean=jst["mean"], var=jst["var"])
    return got, want


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("use_running_average", [False, True],
                         ids=["train", "eval"])
def test_local_path_matches_jax(dtype, tol, use_running_average):
    got, want = _local(dtype, use_running_average)
    for k in want:
        w = np.asarray(jnp.asarray(want[k], jnp.float32))
        np.testing.assert_allclose(got[k].detach().float().numpy(), w,
                                   rtol=tol, atol=tol * max(1.0,
                                                            np.abs(w).max()),
                                   err_msg=k)


@pytest.mark.parametrize("training", [True, False])
def test_convert_syncbn_model_equals_torch_batch_norm(training):
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3),
                              torch.nn.BatchNorm2d(4, momentum=0.2),
                              torch.nn.ReLU(),
                              torch.nn.Sequential(torch.nn.BatchNorm2d(4)))
    with torch.no_grad():
        net[1].weight.uniform_(0.5, 1.5)
        net[1].bias.uniform_(-0.5, 0.5)
        net[1].running_var.uniform_(0.5, 1.5)
    ref = copy.deepcopy(net)
    net.train(training)
    ref.train(training)
    conv = convert_syncbn_model(net, axis_name=None)
    assert isinstance(conv[1], SyncBatchNorm)
    assert isinstance(conv[3][0], SyncBatchNorm)
    assert conv[1].momentum == 0.2 and conv[1].training == training
    x = torch.randn(2, 3, 9, 7)
    np.testing.assert_allclose(conv(x).detach().numpy(),
                               ref(x).detach().numpy(), rtol=1e-5,
                               atol=1e-5)
    for mine, theirs in ((conv[1], ref[1]), (conv[3][0], ref[3][0])):
        np.testing.assert_allclose(mine.mean.numpy(),
                                   theirs.running_mean.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(mine.var.numpy(),
                                   theirs.running_var.numpy(), rtol=1e-5,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="momentum"):
        convert_syncbn_model(torch.nn.BatchNorm1d(3, momentum=None))
