"""The chunked preference and distillation losses against the JAX
package, on the CPU.

The same numpy inputs go through the JAX function (its Pallas kernels
in interpret mode, or its XLA composite) and through the port's plain
path, with a ragged vocab (V not a multiple of the chunk):

- ``chunked_logprob`` and its grads in x and W, chunk sizes 128 and
  256, ``num_classes`` masking: f32 within 2e-5 (the tolerance of
  tests/test_chunked_loss.py); chunk-size invariance within 1e-6;
- ``chunked_dpo_loss`` (with and without ``padding_idx``) and
  ``chunked_orpo_loss``, loss and grads in both hidden states and W:
  f32 within 2e-5;
- ``chunked_kl_loss`` at two temperatures, loss and student grads
  within 2e-5; the teacher's grads exactly zero;
- the geometry and vocab errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex1_tpu.ops import _common as jax_common
from apex1_tpu.ops import chunked_loss as jcl
from apex1_tpu_torch.ops import chunked_loss as cl

FP32_TOL = dict(rtol=2e-5, atol=2e-5)


def _mk(rng, *shape):
    return (rng.standard_normal(shape) * 0.3).astype(np.float32)


def _grads(fn, args, argnums):
    """fn(*args) and its grads w.r.t. ``argnums`` in both frameworks:
    ``fn(lib, *arrays)`` with lib "jax" or "torch"."""
    jout, jgrads = jax.value_and_grad(
        lambda *a: jnp.sum(fn("jax", *a)), argnums=argnums)(
        *map(jnp.asarray, args))
    targs = [torch.from_numpy(a) for a in args]
    for i in argnums:
        targs[i].requires_grad_()
    tout = fn("torch", *targs).sum()
    tgrads = torch.autograd.grad(tout, [targs[i] for i in argnums])
    return ((tout.item(), [g.numpy() for g in tgrads]),
            (float(jout), [np.asarray(g) for g in jgrads]))


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("chunk_v", [128, 256])
def test_chunked_logprob_and_grads_match_jax(chunk_v, impl):
    rng = np.random.default_rng(0)
    B, S, H, V = 2, 12, 64, 517
    x, w = _mk(rng, B, S, H), _mk(rng, V, H)
    t = rng.integers(0, V, (B, S)).astype(np.int32)

    def fn(lib, x_, w_):
        if lib == "jax":
            with jax_common.force_impl(impl):
                return jcl.chunked_logprob(x_, w_, jnp.asarray(t),
                                           chunk_v=chunk_v)
        lp = cl.chunked_logprob(x_, w_, torch.from_numpy(t),
                                chunk_v=chunk_v)
        assert lp.shape == (B, S) and lp.dtype == torch.float32
        return lp

    (got, gg), (want, wg) = _grads(fn, (x, w), (0, 1))
    np.testing.assert_allclose(got, want, **FP32_TOL)
    for a, b in zip(gg, wg):
        np.testing.assert_allclose(a, b, **FP32_TOL)


def test_chunk_size_invariance_and_num_classes():
    rng = np.random.default_rng(1)
    T, H, V, k = 16, 32, 384, 300
    x, w = map(torch.from_numpy, (_mk(rng, T, H), _mk(rng, V, H)))
    t = torch.from_numpy(rng.integers(0, k, T).astype(np.int32))
    base = cl.chunked_logprob(x, w, t, chunk_v=384, num_classes=k)
    for cv in (128, 256):
        np.testing.assert_allclose(
            cl.chunked_logprob(x, w, t, chunk_v=cv, num_classes=k).numpy(),
            base.numpy(), rtol=1e-6, atol=1e-6)
    want = jcl.chunked_logprob(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                               jnp.asarray(t.numpy()), chunk_v=128,
                               num_classes=k)
    np.testing.assert_allclose(base.numpy(), np.asarray(want), **FP32_TOL)
    # the default chunk: the vocab rounded up to 128, at most 8192
    assert cl._auto_chunk(50304, None) == 8192
    assert cl._auto_chunk(300, None) == 384


@pytest.mark.parametrize("padding_idx", [None, 0])
def test_dpo_and_grads_match_jax(padding_idx):
    rng = np.random.default_rng(2)
    B, S, H, V = 3, 10, 48, 389
    hc, hr, w = _mk(rng, B, S, H), _mk(rng, B, S, H), _mk(rng, V, H)
    tc = rng.integers(1, V, (B, S)).astype(np.int32)
    tr = rng.integers(1, V, (B, S)).astype(np.int32)
    if padding_idx is not None:
        tc[:, -3:] = padding_idx
        tr[:, -2:] = padding_idx
    rc = (rng.standard_normal(B) * 2.0).astype(np.float32)
    rr = (rng.standard_normal(B) * 2.0).astype(np.float32)

    def fn(lib, hc_, hr_, w_, rc_, rr_):
        mod, conv = ((jcl, jnp.asarray) if lib == "jax"
                     else (cl, torch.from_numpy))
        return mod.chunked_dpo_loss(hc_, hr_, w_, conv(tc), conv(tr), rc_,
                                    rr_, beta=0.25, padding_idx=padding_idx,
                                    chunk_v=128)

    (got, gg), (want, wg) = _grads(fn, (hc, hr, w, rc, rr), (0, 1, 2))
    np.testing.assert_allclose(got, want, **FP32_TOL)
    for a, b in zip(gg, wg):
        np.testing.assert_allclose(a, b, **FP32_TOL)


def test_orpo_and_grads_match_jax():
    rng = np.random.default_rng(3)
    B, S, H, V = 2, 8, 32, 261
    hc, hr, w = _mk(rng, B, S, H), _mk(rng, B, S, H), _mk(rng, V, H)
    tc = rng.integers(1, V, (B, S)).astype(np.int32)
    tr = rng.integers(1, V, (B, S)).astype(np.int32)

    def fn(lib, hc_, hr_, w_):
        mod, conv = ((jcl, jnp.asarray) if lib == "jax"
                     else (cl, torch.from_numpy))
        return mod.chunked_orpo_loss(hc_, hr_, w_, conv(tc), conv(tr),
                                     lam=0.3, chunk_v=128)

    (got, gg), (want, wg) = _grads(fn, (hc, hr, w), (0, 1, 2))
    np.testing.assert_allclose(got, want, **FP32_TOL)
    for a, b in zip(gg, wg):
        np.testing.assert_allclose(a, b, **FP32_TOL)


@pytest.mark.parametrize("temperature", [1.0, 2.5])
def test_kl_and_student_grads_match_jax(temperature):
    rng = np.random.default_rng(4)
    B, S, H, V = 2, 6, 40, 453
    xs, xt = _mk(rng, B, S, H), _mk(rng, B, S, H)
    ws, wt = _mk(rng, V, H), _mk(rng, V, H)

    def fn(lib, xs_, ws_, xt_, wt_):
        mod = jcl if lib == "jax" else cl
        return mod.chunked_kl_loss(xs_, ws_, xt_, wt_,
                                   temperature=temperature, chunk_v=128,
                                   num_classes=440)

    (got, gg), (want, wg) = _grads(fn, (xs, ws, xt, wt), (0, 1))
    np.testing.assert_allclose(got, want, **FP32_TOL)
    for a, b in zip(gg, wg):
        np.testing.assert_allclose(a, b, **FP32_TOL)


def test_kl_teacher_gets_zero_grads():
    rng = np.random.default_rng(5)
    T, H, V = 8, 32, 256
    xs, xt = (torch.from_numpy(_mk(rng, T, H)).requires_grad_()
              for _ in range(2))
    ws, wt = (torch.from_numpy(_mk(rng, V, H)).requires_grad_()
              for _ in range(2))
    kl = cl.chunked_kl_loss(xs, ws, xt, wt, chunk_v=128)
    assert kl.shape == (T,) and kl.dtype == torch.float32
    gxt, gwt = torch.autograd.grad(kl.sum(), (xt, wt))
    assert not gxt.any() and not gwt.any()


def test_geometry_and_vocab_errors():
    with pytest.raises(ValueError, match="multiple"):
        cl.check_chunk_geometry(100)
    with pytest.raises(ValueError, match="multiple"):
        cl.chunked_logprob(torch.zeros(4, 32), torch.zeros(256, 32),
                           torch.zeros(4, dtype=torch.int32), chunk_v=100)
    with pytest.raises(ValueError, match="one vocab"):
        cl.chunked_kl_loss(torch.zeros(4, 32), torch.zeros(256, 32),
                           torch.zeros(4, 32), torch.zeros(384, 32),
                           chunk_v=128)
