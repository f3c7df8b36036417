"""The port's ResNet against the JAX package's, on the CPU.

A tiny ResNet (stage_sizes (1, 1), width 8, 10 classes) from JAX's
``init`` goes through both packages on the same numpy images and
labels; the JAX loss is the bench's (``bench.py:284-300``): the mean
fused cross-entropy of the fp32 logits, with the running statistics
carried as the aux. JAX runs its cross-entropy as its XLA composite and
as its Pallas kernels in interpret mode.

- O0: the logits, the loss, every grad leaf and the new running
  statistics within 1e-5, at an even (32) and an odd (33) image size;
  the evaluation forward (running statistics) likewise;
- flax SAME geometry: `Conv` and `max_pool_same` against ``nn.Conv``
  and ``nn.max_pool`` at odd and even sizes, stride 1 and 2 (the
  stem's 7x7 at 224 among them): exactly the same windows, within 1e-5;
- 3 O2 ``fused_sgd(LR, momentum=0.9, weight_decay=1e-4)`` steps with
  ``has_aux`` within 2e-2 of JAX's (loss, grad norm, params, running
  statistics), as the other O2 trajectories. ``LR`` is 0.01, not the
  bench's 0.1: at 0.1 this 4-image net's loss falls from 2.64 to 0.24
  in two steps, and the bf16 roundings of the backward (under jit XLA
  may keep some bf16 intermediates in f32; a max-pool window with tied
  bf16 values may route its gradient to another element) grow from
  about 1 % of each grad leaf at step 1 to 6 % of the grad norm at
  step 2;
- interop round trip, `param_specs`, and the spatial block: with no
  group bound equal to the plain one, a stride other than 1 raising.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex1_tpu.amp import Amp as JaxAmp
from apex1_tpu.core.policy import get_policy as jax_get_policy
from apex1_tpu.models.resnet import ResNet as JaxResNet
from apex1_tpu.models.resnet import ResNetConfig as JaxResNetConfig
from apex1_tpu.ops import _common as jax_common
from apex1_tpu.ops import softmax_cross_entropy_loss as jax_xent
from apex1_tpu.optim.fused_sgd import fused_sgd as jax_fused_sgd
from apex1_tpu_torch import Amp, get_policy
from apex1_tpu_torch.interop import (flax_from_named, resnet_params_from_jax,
                                     resnet_params_to_numpy)
from apex1_tpu_torch.models.resnet import (Bottleneck, Conv, ResNetConfig,
                                           SpatialBottleneck, max_pool_same,
                                           param_specs, resnet_loss_fn,
                                           same_pads)
from apex1_tpu_torch.optim import fused_sgd

B = 4
#: the O2 trajectory's learning rate (the bench takes 0.1; see
#: test_o2_three_fused_sgd_steps_match_jax)
LR = 0.01


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees(got, want, **tol):
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert flat_g.keys() == flat_w.keys()
    for k, w in flat_w.items():
        np.testing.assert_allclose(np.asarray(flat_g[k], np.float32),
                                   np.asarray(w, np.float32), err_msg=str(k),
                                   **tol)


def _setup(hw: int, level: str = "O0"):
    rng = np.random.default_rng(hw)
    images = rng.normal(size=(B, hw, hw, 3)).astype(np.float32)
    labels = rng.integers(0, 10, (B,)).astype(np.int32)
    jcfg = JaxResNetConfig.tiny(policy=jax_get_policy(level))
    model = JaxResNet(jcfg)
    variables = jax.jit(model.init)(jax.random.key(hw), images)
    return dict(images=images, labels=labels, model=model,
                params=_np_tree(variables["params"]),
                stats=_np_tree(variables["batch_stats"]))


def _jax_loss_fn(model):
    def loss_fn(params, images, labels, bn):
        logits, upd = model.apply({"params": params, "batch_stats": bn},
                                  images, mutable=["batch_stats"])
        loss = jnp.mean(jax_xent(logits.astype(jnp.float32), labels))
        return loss, (upd["batch_stats"], logits)
    return loss_fn


def _port(s, level="O0"):
    cfg = ResNetConfig.tiny(policy=get_policy(level))
    model = resnet_params_from_jax(s["params"], s["stats"], cfg, "cpu")
    return model, dict(model.named_buffers())


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("hw", [32, 33])
def test_o0_logits_loss_grads_and_stats_match_jax(hw, impl):
    s = _setup(hw)
    with jax_common.force_impl(impl):
        (jloss, (jstats, jlogits)), jgrads = jax.jit(jax.value_and_grad(
            _jax_loss_fn(s["model"]), has_aux=True))(
            s["params"], s["images"], s["labels"], s["stats"])
    model, stats = _port(s)
    params = dict(model.named_parameters())
    images = torch.from_numpy(s["images"])
    loss, new = resnet_loss_fn(model)(params, images,
                                      torch.from_numpy(s["labels"]), stats)
    grads = torch.autograd.grad(loss, list(params.values()))
    logits, _ = model(images)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    _assert_trees(flax_from_named(dict(zip(params, grads))),
                  _np_tree(jgrads), rtol=1e-5, atol=1e-5)
    _assert_trees(flax_from_named(new), _np_tree(jstats), rtol=1e-5,
                  atol=1e-5)


def test_eval_forward_uses_the_running_stats_like_jax():
    s = _setup(32)
    stats = jax.tree_util.tree_map(lambda a: a + 0.5, s["stats"])
    want = s["model"].apply({"params": s["params"], "batch_stats": stats},
                            s["images"], train=False)
    model = resnet_params_from_jax(s["params"], stats,
                                   ResNetConfig.tiny(), "cpu")
    got = model(torch.from_numpy(s["images"]), train=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,k,stride", [
    (n, k, s) for n in (7, 8, 9, 16) for k, s in
    ((1, 1), (1, 2), (3, 1), (3, 2), (7, 2))] + [(224, 7, 2)])
def test_same_geometry_matches_flax(n, k, stride):
    rng = np.random.default_rng(n * 10 + k)
    x = rng.normal(size=(2, n, n, 3)).astype(np.float32)
    conv = fnn.Conv(4, (k, k), strides=(stride, stride), use_bias=False)
    params = conv.init(jax.random.key(0), x)
    want = np.asarray(conv.apply(params, x))
    port = Conv(3, 4, k, stride, device="cpu")
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.asarray(
            params["params"]["kernel"]).transpose(3, 2, 0, 1).copy()))
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2), torch.float32)
    got = got.permute(0, 2, 3, 1).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    pool = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3),
                                   strides=(stride, stride), padding="SAME"))
    pgot = max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2), 3, stride)
    np.testing.assert_array_equal(pgot.permute(0, 2, 3, 1).numpy(), pool)


def test_same_pads_are_flax_asymmetric():
    assert same_pads(224, 7, 2) == (2, 3)
    assert same_pads(112, 3, 2) == (0, 1)
    assert same_pads(56, 3, 1) == (1, 1)
    assert same_pads(7, 3, 2) == (1, 1)


def _jax_o2(s, steps):
    amp = JaxAmp(jax_fused_sgd(LR, momentum=0.9, weight_decay=1e-4),
                 opt_level="O2")
    loss_fn = _jax_loss_fn(s["model"])
    step = jax.jit(amp.make_train_step(
        lambda p, x, y, bn: (lambda o: (o[0], o[1][0]))(loss_fn(p, x, y, bn)),
        has_aux=True))
    state, bn, rows = amp.init(s["params"]), s["stats"], []
    for _ in range(steps):
        with jax_common.force_impl("pallas"):
            state, m = step(state, s["images"], s["labels"], bn)
        bn = m["aux"]
        rows.append(_np_tree(m))
    return rows, _np_tree(state.params)


def test_o2_three_fused_sgd_steps_match_jax():
    s = _setup(32, "O2")
    want, jparams = _jax_o2(s, 3)
    model, bn = _port(s, "O2")
    amp = Amp(fused_sgd(LR, momentum=0.9, weight_decay=1e-4),
              opt_level="O2")
    state = amp.init(dict(model.named_parameters()))
    step = amp.make_train_step(resnet_loss_fn(model), has_aux=True)
    images, labels = torch.from_numpy(s["images"]), torch.from_numpy(
        s["labels"])
    for w in want:
        state, m = step(state, images, labels, bn)
        bn = m["aux"]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(m[k].item(), float(w[k]), rtol=2e-2,
                                       err_msg=k)
        _assert_trees(flax_from_named(bn), w["aux"], rtol=2e-2, atol=2e-2)
    assert state.opt_state.step.item() == 3
    _assert_trees(flax_from_named(state.params), jparams, rtol=2e-2,
                  atol=2e-2)


def test_interop_round_trip_and_specs():
    s = _setup(32)
    model = resnet_params_from_jax(s["params"], s["stats"],
                                   ResNetConfig.tiny(), "cpu")
    params, stats = resnet_params_to_numpy(model)
    _assert_trees(params, s["params"], rtol=0, atol=0)
    _assert_trees(stats, s["stats"], rtol=0, atol=0)
    assert not any(n.endswith((".mean", ".var"))
                   for n, _ in model.named_parameters())
    specs = param_specs(dict(model.named_parameters()))
    assert set(specs) == {n for n, _ in model.named_parameters()}
    assert set(specs.values()) == {()}


def test_spatial_parallelism_raises():
    """Spatial parallelism is ported (tests/test_torch_halo.py holds it
    against JAX's at worlds 2 and 4); with no group bound it is the
    plain block, and a stride other than 1 raises as in JAX."""
    cfg = ResNetConfig.tiny()
    with pytest.raises(ValueError, match="stride 1 only"):
        Bottleneck(cfg, 8, 8, strides=2, spatial_axis_name="cp",
                   device="cpu")
    spatial = SpatialBottleneck(cfg, 8, device="cpu")
    plain = Bottleneck(cfg, 32, 8, device="cpu")
    plain.load_state_dict(spatial.state_dict())
    x = torch.randn(2, 32, 8, 8, generator=torch.Generator().manual_seed(0))
    for train in (True, False):
        ys = [b(x, train=train, stats={}, prefix="b")
              for b in (spatial, plain)]
        torch.testing.assert_close(ys[0], ys[1], rtol=0, atol=0)
