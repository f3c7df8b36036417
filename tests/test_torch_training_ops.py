"""The training slice's ops against the JAX package, forward and grads.

The same numpy inputs and cotangents go through the JAX function (its
XLA composite, and its Pallas kernels in interpret mode) under
``jax.grad``, and through the port's plain PyTorch path under
autograd, on the CPU:

- LayerNorm/RMSNorm dx, dγ, dβ: f32 within 1e-5; bf16 x with bf16 γ/β
  (the amp compute params) within 1e-2 (bf16 roundings of y and of the
  grads);
- causal and masked softmax, forward and dx, odd sq/sk: f32 1e-5;
- softmax cross-entropy loss and dlogits with smoothing, padding_idx
  and num_classes < width, on a strided logits[:, :-1] slice: f32 1e-5.

The CUDA kernels are held against the same plain versions on the card
(tests/test_torch_kernels_gpu.py and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex1_tpu.ops import _common as jax_common
from apex1_tpu.ops.layer_norm import FusedLayerNorm as JaxFusedLayerNorm
from apex1_tpu.ops.layer_norm import FusedRMSNorm as JaxFusedRMSNorm
from apex1_tpu.ops.layer_norm import layer_norm as jax_layer_norm
from apex1_tpu.ops.layer_norm import rms_norm as jax_rms_norm
from apex1_tpu.ops.softmax import scaled_masked_softmax as jax_masked_sm
from apex1_tpu.ops.softmax import \
    scaled_upper_triang_masked_softmax as jax_causal_sm
from apex1_tpu.ops.xentropy import masked_next_token_mean as jax_masked_mean
from apex1_tpu.ops.xentropy import softmax_cross_entropy_loss as jax_xent
from apex1_tpu_torch.ops import (FusedLayerNorm, FusedRMSNorm, force_impl,
                                 layer_norm, masked_next_token_mean,
                                 rms_norm, scaled_masked_softmax,
                                 scaled_upper_triang_masked_softmax,
                                 softmax_cross_entropy_loss)

IMPLS = ["xla", "pallas"]


def _t(a, dtype=torch.float32, grad=True):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype) \
        .requires_grad_(grad)


def _np(t):
    return t.detach().float().numpy()


def _value_and_vjp(f, x, ct):
    """f(x) and the vjp of ``ct`` through f, as one function to jit."""
    y, vjp = jax.vjp(f, x)
    return y, vjp(ct)[0]


# ---- LayerNorm / RMSNorm -------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("shape", [(3, 5, 128), (7, 96)])
@pytest.mark.parametrize("rms", [False, True], ids=["ln", "rms"])
def test_norm_grads_match_jax(shape, impl, dtype, rms):
    rng = np.random.default_rng(1)
    H = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    b = (0.1 * rng.standard_normal(H)).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    jdt = getattr(jnp, dtype)

    def jf(x_, g_, b_):
        y = jax_rms_norm(x_, g_) if rms else jax_layer_norm(x_, g_, b_)
        return jnp.sum(y.astype(jnp.float32) * dy)

    with jax_common.force_impl(impl):
        want = jax.jit(jax.grad(jf, argnums=(0, 1, 2)))(
            jnp.asarray(x, jdt), jnp.asarray(g, jdt), jnp.asarray(b, jdt))
    tdt = getattr(torch, dtype)
    tx, tg, tb = _t(x, tdt), _t(g, tdt), _t(b, tdt)
    y = rms_norm(tx, tg) if rms else layer_norm(tx, tg, tb)
    (y.float() * torch.from_numpy(dy)).sum().backward()
    got = (tx.grad, tg.grad, tb.grad)
    tol = 1e-5 if dtype == "float32" else 1e-2
    for i, (gt, w) in enumerate(zip(got, want)):
        if rms and i == 2:
            assert gt is None
            continue
        assert gt.dtype == tdt
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(_np(gt), w, rtol=tol,
                                   atol=tol * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("memory_efficient", [False, True])
@pytest.mark.parametrize("rms", [False, True], ids=["ln", "rms"])
def test_fused_norm_modules_match_jax(rms, memory_efficient):
    """The apex.normalization modules: a multi-dim normalized_shape is
    flattened into the row; output and dx against the flax modules."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 4, 8)).astype(np.float32)
    dy = rng.standard_normal((3, 4, 8)).astype(np.float32)
    jmod = (JaxFusedRMSNorm if rms else JaxFusedLayerNorm)(
        (4, 8), memory_efficient=memory_efficient)
    params = jax.jit(jmod.init)(jax.random.key(0), jnp.asarray(x))
    y_j, dx_j = jax.jit(lambda x_, dy_: _value_and_vjp(
        lambda z: jmod.apply(params, z), x_, dy_))(jnp.asarray(x),
                                                   jnp.asarray(dy))
    mod = (FusedRMSNorm if rms else FusedLayerNorm)(
        (4, 8), memory_efficient=memory_efficient)
    tx = _t(x)
    y = mod(tx)
    (y * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(_np(y), np.asarray(y_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_np(tx.grad), np.asarray(dx_j), rtol=1e-5,
                               atol=1e-5)
    assert mod.scale.grad.shape == (32,)
    assert (mod.bias is None) == rms


# ---- softmax -------------------------------------------------------------


_MASKS = {"causal": None, "b1qk": lambda sq, sk: (2, 1, sq, sk),
          "k": lambda sq, sk: (1, 1, 1, sk), "qk": lambda sq, sk: (sq, sk)}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("mask_kind", list(_MASKS))
@pytest.mark.parametrize("sq,sk", [(11, 19), (13, 13)])
def test_softmax_and_grad_match_jax(impl, mask_kind, sq, sk):
    """Causal, or an additive mask broadcast over batch, heads or
    queries."""
    mask_shape = _MASKS[mask_kind] and _MASKS[mask_kind](sq, sk)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 3, sq, sk)) * 3).astype(np.float32)
    dy = rng.standard_normal((2, 3, sq, sk)).astype(np.float32)
    mask = None if mask_shape is None else np.where(
        rng.random(mask_shape) < 0.3, -1e30, 0.0).astype(np.float32)
    scale = 0.37

    def jf(x_):
        if mask is None:
            return jax_causal_sm(x_, scale=scale)
        return jax_masked_sm(x_, jnp.asarray(mask), scale=scale)

    with jax_common.force_impl(impl):
        y_j, dx_j = jax.jit(lambda x_, dy_: _value_and_vjp(jf, x_, dy_))(
            jnp.asarray(x), jnp.asarray(dy))
    tx = _t(x)
    if mask is None:
        y = scaled_upper_triang_masked_softmax(tx, scale=scale)
    else:
        y = scaled_masked_softmax(tx, torch.from_numpy(mask), scale=scale)
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(_np(y), np.asarray(y_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(_np(tx.grad), np.asarray(dx_j), rtol=1e-5,
                               atol=1e-6)


def test_softmax_keeps_half_dtype():
    x = _t(np.random.default_rng(4).standard_normal((2, 5, 7)),
           torch.bfloat16)
    y = scaled_upper_triang_masked_softmax(x, scale=0.5)
    y.float().sum().backward()
    assert y.dtype == torch.bfloat16 and x.grad.dtype == torch.bfloat16


# ---- cross-entropy -------------------------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("smoothing,padding_idx,num_classes",
                         [(0.0, None, None), (0.1, None, 290),
                          (0.0, 3, 290), (0.2, 3, None)])
def test_xent_loss_and_grad_match_jax(impl, smoothing, padding_idx,
                                      num_classes):
    rng = np.random.default_rng(5)
    full = (rng.standard_normal((3, 8, 300)) * 4).astype(np.float32)
    hi = num_classes or 300
    tokens = rng.integers(0, hi, (3, 8))
    tokens[:, ::3] = 3
    dl = rng.standard_normal((3, 7)).astype(np.float32)
    kw = dict(smoothing=smoothing, padding_idx=padding_idx,
              num_classes=num_classes)

    def jf(lg):
        return jax_xent(lg[:, :-1], jnp.asarray(tokens[:, 1:]), **kw)

    with jax_common.force_impl(impl):
        loss_j, dx_j = jax.jit(lambda x_, d_: _value_and_vjp(jf, x_, d_))(
            jnp.asarray(full), jnp.asarray(dl))
    tf = _t(full)
    loss = softmax_cross_entropy_loss(tf[:, :-1],
                                      torch.from_numpy(tokens[:, 1:]), **kw)
    loss.backward(torch.from_numpy(dl))
    assert loss.dtype == torch.float32 and loss.shape == (3, 7)
    np.testing.assert_allclose(_np(loss), np.asarray(loss_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_np(tf.grad), np.asarray(dx_j), rtol=1e-5,
                               atol=1e-6)
    if num_classes:
        assert not tf.grad[..., num_classes:].any()


def test_xent_rejects_bad_num_classes():
    with pytest.raises(ValueError, match="num_classes"):
        softmax_cross_entropy_loss(torch.zeros(2, 8), torch.zeros(2).long(),
                                   num_classes=9)


def test_masked_next_token_mean_matches_jax():
    rng = np.random.default_rng(6)
    losses = rng.random((2, 9)).astype(np.float32)
    seg = np.array([[0, 0, 0, 1, 1, 1, 1, -1, -1, -1],
                    [0, 0, 0, 0, 0, 2, 2, 2, 2, 2]], np.int32)
    want = jax_masked_mean(jnp.asarray(losses), jnp.asarray(seg))
    got = masked_next_token_mean(torch.from_numpy(losses),
                                 torch.from_numpy(seg))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_kernel_impl_refuses_cpu_tensors():
    """No silent plain run for the new wrappers either."""
    x = torch.zeros(1, 1, 4, 4)
    with force_impl("kernel"), pytest.raises(RuntimeError, match="CUDA"):
        scaled_upper_triang_masked_softmax(x)
    with force_impl("kernel"), pytest.raises(RuntimeError, match="CUDA"):
        softmax_cross_entropy_loss(torch.zeros(2, 8), torch.zeros(2).long())
