"""The training slice's ops against the JAX package, forward and grads.

The same numpy inputs and cotangents go through the JAX function (its
XLA composite, and its Pallas kernels in interpret mode) under
``jax.grad``, and through the port's plain PyTorch path under
autograd, on the CPU:

- LayerNorm/RMSNorm dx, dγ, dβ: f32 within 1e-5, also at the H edges
  of the Hopper backward's paths (1 to 8192); bf16 or fp16 x with half
  or fp32 γ/β (the amp compute params, MixedFused) within 1e-2 (half
  roundings of y and of the grads);
- causal and masked softmax, forward and dx, odd sq/sk, the forward's
  Sk edges (1 to 2052, Sq != Sk, each mask broadcast): f32 1e-5;
- softmax cross-entropy loss and dlogits with smoothing, padding_idx
  and num_classes < width, on a strided logits[:, :-1] slice: f32 1e-5;
  bf16 and fp16 logits: the loss at 1e-5, dlogits one half ulp apart.

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


def _norm_grads(x, g, b, dy, rms, impl, dtype, gdtype=None):
    """(JAX's dx, dγ, dβ under ``impl``, the port's) for numpy inputs,
    x in ``dtype`` and γ/β in ``gdtype`` (x's by default)."""
    jdt = getattr(jnp, dtype)
    jgdt = getattr(jnp, gdtype or dtype)

    def jf(x_, g_, b_):
        y = jax_rms_norm(x_, g_) if rms else jax_layer_norm(x_, g_, b_)
        return jnp.sum(y.astype(jnp.float32) * dy)

    with jax_common.force_impl(impl):
        want = jax.jit(jax.grad(jf, argnums=(0, 1, 2)))(
            jnp.asarray(x, jdt), jnp.asarray(g, jgdt), jnp.asarray(b, jgdt))
    tdt = getattr(torch, dtype)
    tgdt = getattr(torch, gdtype or dtype)
    tx, tg, tb = _t(x, tdt), _t(g, tgdt), _t(b, tgdt)
    y = rms_norm(tx, tg) if rms else layer_norm(tx, tg, tb)
    (y.float() * torch.from_numpy(dy)).sum().backward()
    return want, (tx.grad, tg.grad, tb.grad)


def _assert_grads(want, got, rms, tol, dtypes):
    for i, (gt, w) in enumerate(zip(got, want)):
        if rms and i == 2:
            assert gt is None
            continue
        assert gt.dtype == dtypes[i]
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(_np(gt), w, rtol=tol,
                                   atol=tol * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("h", [1, 7, 767, 768, 769, 2048, 4096, 4104, 6016,
                               6024, 8192])
@pytest.mark.parametrize("rms", [False, True], ids=["ln", "rms"])
def test_norm_grads_at_row_edges_match_jax(h, rms, impl):
    """dx, dγ, dβ at the H edges of the Hopper backward's paths, up to
    8192 (past the 6016 its first kernel took), a few rows, f32."""
    rng = np.random.default_rng(h)
    x = (rng.standard_normal((3, h)) * 2 + 0.5).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    b = (0.1 * rng.standard_normal(h)).astype(np.float32)
    dy = rng.standard_normal((3, h)).astype(np.float32)
    want, got = _norm_grads(x, g, b, dy, rms, impl, "float32")
    _assert_grads(want, got, rms, 1e-5, (torch.float32,) * 3)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("gdtype", ["float32", "half"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("rms", [False, True], ids=["ln", "rms"])
def test_half_norm_grads_match_jax(dtype, gdtype, rms, impl):
    """Half x with fp32 γ/β (MixedFused) or half γ/β (the amp compute
    params) at GPT-2's width: the grads in x's and γ's dtypes, within
    1e-2 (half roundings of y and of the grads)."""
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((4, 6, 768)) * 2 + 0.5).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(768)).astype(np.float32)
    b = (0.1 * rng.standard_normal(768)).astype(np.float32)
    dy = rng.standard_normal((4, 6, 768)).astype(np.float32)
    gdt = dtype if gdtype == "half" else "float32"
    want, got = _norm_grads(x, g, b, dy, rms, impl, dtype, gdt)
    tdt, tgdt = getattr(torch, dtype), getattr(torch, gdt)
    _assert_grads(want, got, rms, 1e-2, (tdt, tgdt, tgdt))


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
        (4, 8), memory_efficient=memory_efficient, device="cpu")
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


#: (Sq, Sk) at the Sk edges of the Hopper forward's paths: one column,
#: one 16-byte fp32 chunk, past 1024 off a chunk, and a chunk multiple
#: past 16 chunks a lane; Sq past Sk and short of it
_SOFTMAX_EDGES = [(3, 1), (7, 4), (6, 1025), (5, 2052)]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("mask_kind", ["causal", "b1qk", "k", "bh"])
@pytest.mark.parametrize("sq,sk", _SOFTMAX_EDGES)
def test_softmax_and_grad_at_sk_edges_match_jax(impl, mask_kind, sq, sk):
    """Causal with Sq != Sk, or a mask broadcast over batch and heads,
    over queries, or over queries and keys (one value a row)."""
    shapes = {"b1qk": (2, 1, sq, sk), "k": (1, 1, 1, sk), "bh": (2, 3, 1, 1)}
    rng = np.random.default_rng(sk)
    x = (rng.standard_normal((2, 3, sq, sk)) * 3).astype(np.float32)
    dy = rng.standard_normal((2, 3, sq, sk)).astype(np.float32)
    mask = None if mask_kind == "causal" else np.where(
        rng.random(shapes[mask_kind]) < 0.3, -1e30, 0.0).astype(np.float32)
    scale = 0.125

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


#: dlogits tolerance per logits dtype, |port - JAX| <= atol + rtol·|JAX|:
#: fp32 sums in another order; half dx is one rounding of an fp32 value
#: on each side, so the two may lie one ulp apart (bf16 2^-7 relative,
#: fp16 2^-10, and fp16's subnormal step 2^-24 below its normal range)
_XENT_DX_TOLS = {"float32": (1e-5, 1e-6), "bfloat16": (2.0 ** -7, 1e-6),
                 "float16": (2.0 ** -10, 2.0 ** -24)}


_XENT_CASES = [(0.0, None, None), (0.1, None, 290), (0.0, 3, 290),
               (0.2, 3, None)]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("smoothing,padding_idx,num_classes", _XENT_CASES)
def test_xent_loss_and_grad_match_jax(impl, smoothing, padding_idx,
                                      num_classes):
    _xent_matches_jax(impl, smoothing, padding_idx, num_classes, "float32")


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("smoothing,padding_idx,num_classes", _XENT_CASES)
def test_xent_half_loss_and_grad_match_jax(impl, smoothing, padding_idx,
                                           num_classes, dtype):
    _xent_matches_jax(impl, smoothing, padding_idx, num_classes, dtype)


def _xent_matches_jax(impl, smoothing, padding_idx, num_classes, dtype):
    """The loss (fp32 from the logits widened exactly, so at fp32's
    tolerance in every dtype) and dlogits in the logits' dtype
    (`_XENT_DX_TOLS`), on a strided logits[:, :-1] slice."""
    rng = np.random.default_rng(5)
    full = (rng.standard_normal((3, 8, 300)) * 4).astype(np.float32)
    tf = _t(full, getattr(torch, dtype))
    # the logits as the half type holds them, for both sides
    full = _np(tf)
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
            jnp.asarray(full).astype(dtype), jnp.asarray(dl))
    assert dx_j.dtype == jnp.dtype(dtype)
    loss = softmax_cross_entropy_loss(tf[:, :-1],
                                      torch.from_numpy(tokens[:, 1:]), **kw)
    loss.backward(torch.from_numpy(dl))
    assert loss.dtype == torch.float32 and loss.shape == (3, 7)
    assert tf.grad.dtype == tf.dtype
    np.testing.assert_allclose(_np(loss), np.asarray(loss_j, np.float32),
                               rtol=1e-5, atol=1e-5)
    rtol, atol = _XENT_DX_TOLS[dtype]
    np.testing.assert_allclose(_np(tf.grad), np.asarray(dx_j, np.float32),
                               rtol=rtol, atol=atol)
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
