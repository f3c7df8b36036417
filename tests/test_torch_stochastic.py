"""The port's counter-based dropout and fused bias-dropout-add against
the JAX package's ``apex1_tpu.ops.stochastic``, on the CPU.

- the hash (``hash_bits_u32``), ``fold_seed``, ``threshold_u32`` and
  ``attn_keep_mask`` bit for bit, seeds near ``SEED_MAX`` and negative
  int32 seeds included (the port computes in int64 with 32-bit masks);
- ``fused_bias_dropout_add``: the output bit for bit against the
  reference's XLA composite and its Pallas kernel in interpret mode, in
  f32, bf16 and fp16 (both round the same fp32 values once); the x,
  residual and bias grads (f32 1e-6: dbias sums rows in another order;
  half dtypes 1e-2); ``p == 0`` is the plain add; the ValueErrors;
- ``fused_dropout_add_layer_norm`` (LayerNorm, RMSNorm, prenorm) and its
  grads within 1e-5 (f32).

The CUDA kernels are held against the same plain versions on the card
(tests/test_torch_kernels_gpu.py and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex1_tpu.ops import _common as jax_common
from apex1_tpu.ops import stochastic as js
from apex1_tpu_torch.ops import KERNEL_WRAPPERS, force_impl
from apex1_tpu_torch.ops import stochastic as ts

SEEDS = [0, 1, 12345, js.SEED_MAX, js.SEED_MAX - 1, -1, -2 ** 31]
DTYPES = ["float32", "bfloat16", "float16"]


@pytest.mark.parametrize("seed", SEEDS)
def test_hash_and_fold_seed_bitwise(seed):
    rng = np.random.default_rng(abs(seed) % 1000)
    row = rng.integers(-2 ** 31, 2 ** 31 - 1, (64, 5)).astype(np.int32)
    col = rng.integers(0, 2 ** 31 - 1, (64, 5)).astype(np.int32)
    for salt in (0, 7, 2 ** 31 - 1):
        want = np.asarray(js.hash_bits_u32(
            jnp.int32(seed), jnp.int32(salt), jnp.asarray(row),
            jnp.asarray(col))).astype(np.int64)
        got = ts.hash_bits_u32(seed, salt, torch.from_numpy(row),
                               torch.from_numpy(col))
        np.testing.assert_array_equal(got.numpy(), want)
        # a 0-d int32 tensor seed is the same stream
        got_t = ts.hash_bits_u32(torch.tensor(seed, dtype=torch.int32),
                                 salt, torch.from_numpy(row),
                                 torch.from_numpy(col))
        np.testing.assert_array_equal(got_t.numpy(), want)
    for salt in range(4):
        want = int(js.fold_seed(jnp.int32(seed), salt))
        assert ts.fold_seed(seed, salt) == want
        t = ts.fold_seed(torch.tensor(seed, dtype=torch.int32), salt)
        assert t.dtype == torch.int32 and int(t) == want
        assert 0 <= want <= ts.SEED_MAX


def test_threshold_and_keep_mask_bitwise():
    for p in (0.1, 0.5, 1e-9, 0.999999999, 0.3333):
        assert ts.threshold_u32(p) == int(js.threshold_u32(p))
    for p in (0.0, 1.0, -0.5):
        with pytest.raises(ValueError, match=r"\(0, 1\)"):
            ts.threshold_u32(p)
    rows = np.arange(40, dtype=np.int32)[:, None] + 64
    cols = np.arange(72, dtype=np.int32)[None, :] + 192
    rg, cg = np.broadcast_arrays(rows, cols)
    want = np.asarray(js.attn_keep_mask(jnp.int32(99), 3, 4, jnp.asarray(rg),
                                        jnp.asarray(cg), 0.1))
    got = ts.attn_keep_mask(99, 3, 4, torch.from_numpy(rows),
                            torch.from_numpy(cols), 0.1)
    np.testing.assert_array_equal(got.numpy(), want)
    # the keep rate is 1 - p within 3 sigma
    n = want.size
    assert abs(want.mean() - 0.9) < 3 * np.sqrt(0.09 / n)


def _bda_inputs(rows=37, h=96, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((3, rows, h)).astype(np.float32),
            rng.standard_normal((3, rows, h)).astype(np.float32),
            rng.standard_normal(h).astype(np.float32),
            rng.standard_normal((3, rows, h)).astype(np.float32))


def _jax_bda(x, r, b, dy, dtype, impl, p, seed, with_bias):
    jdt = getattr(jnp, dtype)

    def f(x, r, b):
        return js.fused_bias_dropout_add(x, r, p=p, seed=seed,
                                         bias=b if with_bias else None)

    def run(x, r, b):
        y, vjp = jax.vjp(f, x, r, b)
        return y, vjp(jnp.asarray(dy, jdt))

    with jax_common.force_impl(impl):
        y, grads = jax.jit(run)(jnp.asarray(x, jdt), jnp.asarray(r, jdt),
                                jnp.asarray(b))
    return [np.asarray(t.astype(jnp.float32)) for t in (y, *grads)]


def _port_bda(x, r, b, dy, dtype, p, seed, with_bias):
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    rt = torch.from_numpy(r).to(tdt).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    y = ts.fused_bias_dropout_add(xt, rt, p=p, seed=seed,
                                  bias=bt if with_bias else None)
    assert y.dtype == tdt
    y.backward(torch.from_numpy(dy).to(tdt))
    assert xt.grad.dtype == tdt and rt.grad.dtype == tdt
    db = bt.grad if with_bias else torch.zeros(b.shape)
    return [t.detach().float().numpy() for t in (y, xt.grad, rt.grad, db)]


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_bias_dropout_add_matches_jax(dtype, impl, with_bias):
    x, r, b, dy = _bda_inputs()
    want = _jax_bda(x, r, b, dy, dtype, impl, 0.1, 77, with_bias)
    got = _port_bda(x, r, b, dy, dtype, 0.1, 77, with_bias)
    # the output and the grads of x and the residual: bit for bit
    for n, g, w in zip(("y", "dx", "dres"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=n)
    if with_bias:
        tol = 1e-6 if dtype == "float32" else 1e-2
        np.testing.assert_allclose(got[3], want[3], rtol=tol,
                                   atol=tol * np.abs(want[3]).max(),
                                   err_msg="dbias")
    # the output's dropped elements are exactly the residual
    y32 = _port_bda(x, r, b, dy, "float32", 0.1, 77, False)[0]
    dropped = y32 == r
    assert 0.05 < dropped.mean() < 0.15


def test_zero_p_is_the_plain_add_and_errors():
    x, r, b, _ = _bda_inputs()
    xt, rt, bt = (torch.from_numpy(a) for a in (x, r, b))
    assert torch.equal(ts.fused_bias_dropout_add(xt, rt, p=0.0), xt + rt)
    assert torch.equal(ts.fused_bias_dropout_add(xt, rt, p=0.0, bias=bt),
                       xt + bt + rt)
    with pytest.raises(ValueError, match="residual shape"):
        ts.fused_bias_dropout_add(xt, rt[:, :3], p=0.1, seed=1)
    with pytest.raises(ValueError, match="bias must be"):
        ts.fused_bias_dropout_add(xt, rt, p=0.1, seed=1, bias=bt[:5])
    with pytest.raises(ValueError, match="explicit int32 seed"):
        ts.fused_bias_dropout_add(xt, rt, p=0.1)
    with pytest.raises(ValueError, match=r"\(0, 1\)"):
        ts.fused_bias_dropout_add(xt, rt, p=1.0, seed=1)
    # one seed, one mask; the CPU runs the plain versions
    before = {n: KERNEL_WRAPPERS[n].launches for n in ("bda_fwd", "bda_bwd")}
    a = ts.fused_bias_dropout_add(xt, rt, p=0.3, seed=5)
    assert torch.equal(a, ts.fused_bias_dropout_add(
        xt, rt, p=0.3, seed=torch.tensor(5, dtype=torch.int32)))
    assert not torch.equal(a, ts.fused_bias_dropout_add(xt, rt, p=0.3,
                                                        seed=6))
    assert {n: KERNEL_WRAPPERS[n].launches for n in before} == before
    with force_impl("kernel"), pytest.raises(RuntimeError, match="CUDA"):
        ts.bda_fwd(xt[0], rt[0], None, 5, 0.3)


@pytest.mark.parametrize("mode", ["ln", "rms", "prenorm"])
def test_dropout_add_layer_norm_matches_jax(mode):
    x, r, b, dy = _bda_inputs(rows=20, h=64, seed=3)
    rng = np.random.default_rng(4)
    g = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(64)).astype(np.float32)
    kw = dict(p=0.2, seed=31, rms=mode == "rms", prenorm=mode == "prenorm")

    def jf(x, r, b, g, beta):
        out = js.fused_dropout_add_layer_norm(x, r, g, beta, bias=b, **kw)
        return out if mode == "prenorm" else (out,)

    for impl in ("xla", "pallas"):
        with jax_common.force_impl(impl):
            outs, vjp = jax.vjp(jf, *map(jnp.asarray, (x, r, b, g, beta)))
            cts = tuple(jnp.asarray(dy) for _ in outs)
            want = [np.asarray(t) for t in (*outs, *vjp(cts))]
        ins = [torch.from_numpy(a).requires_grad_() for a in (x, r, b, g,
                                                              beta)]
        out = ts.fused_dropout_add_layer_norm(ins[0], ins[1], ins[3], ins[4],
                                              bias=ins[2], **kw)
        outs_t = out if mode == "prenorm" else (out,)
        torch.autograd.backward(outs_t, [torch.from_numpy(dy)] * len(outs_t))
        got = [t.detach().numpy() for t in outs_t] + [
            (t.grad if t.grad is not None else torch.zeros_like(t)).numpy()
            for t in ins]
        for i, (g_, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g_, w, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{impl} output {i}")
