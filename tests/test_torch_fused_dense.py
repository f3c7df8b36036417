"""The thin modules of ``ops/fused_dense.py``: the port against the JAX
package on the CPU.

- `fused_dense` and `fused_dense_gelu_dense` in fp32 (within 1e-5 of
  JAX's) and bf16: the port's output is the fp32 sum plus the fp32 bias
  rounded to bf16 once, bit for bit, within one bf16 ulp of JAX's
  (whose fp32 sums run in another order), and a bf16 product rounded
  before the bias differs from it;
- `FusedDense`, `FusedDenseGeluDense` and `MLP` ("none", "relu",
  "sigmoid"; with and without biases) from the flax modules' params
  (`interop.module_params_from_jax`): outputs and every grad (input and
  params) within 1e-5 of ``jax.grad``'s;
- the modules default to CUDA, or raise naming it where there is none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex1_tpu.ops import fused_dense as jfd
from apex1_tpu_torch.interop import module_params_from_jax
from apex1_tpu_torch.ops import fused_dense as tfd


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _data(seed=0, t=5, k=16, n=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((t, k)).astype(np.float32),
            rng.standard_normal((n, k)).astype(np.float32) * 0.3,
            rng.standard_normal(n).astype(np.float32))


def test_fused_dense_f32_matches_jax():
    x, w, b = _data()
    for bias in (b, None):
        want = jfd.fused_dense(jnp.asarray(x), jnp.asarray(w),
                               None if bias is None else jnp.asarray(bias))
        got = tfd.fused_dense(_t(x), _t(w), None if bias is None
                              else _t(bias))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_fused_dense_bf16_rounds_once():
    x, w, b = _data(1, t=64, k=512, n=32)
    xb, wb, bb = (torch.from_numpy(a).bfloat16() for a in (x, w, b))
    got = tfd.fused_dense(xb, wb, bb)
    assert got.dtype == torch.bfloat16
    once = (xb.float() @ wb.float().t() + bb.float()).bfloat16()
    assert torch.equal(got, once)
    want = jfd.fused_dense(jnp.asarray(x, jnp.bfloat16),
                           jnp.asarray(w, jnp.bfloat16),
                           jnp.asarray(b, jnp.bfloat16))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2 ** -7,
                               atol=1e-6)
    twice = xb @ wb.t() + bb
    assert not torch.equal(got, twice)


def test_gelu_dense_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, 16)).astype(np.float32)
    w1 = rng.standard_normal((32, 16)).astype(np.float32) * 0.3
    b1 = rng.standard_normal(32).astype(np.float32)
    w2 = rng.standard_normal((8, 32)).astype(np.float32) * 0.3
    b2 = rng.standard_normal(8).astype(np.float32)
    args = (x, w1, b1, w2, b2)
    want = jfd.fused_dense_gelu_dense(*(jnp.asarray(a) for a in args))
    got = tfd.fused_dense_gelu_dense(*(_t(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    xb = [_t(a).bfloat16() for a in args]
    gb = tfd.fused_dense_gelu_dense(*xb)
    wb = jfd.fused_dense_gelu_dense(*(jnp.asarray(a, jnp.bfloat16)
                                      for a in args))
    np.testing.assert_allclose(gb.float().numpy(),
                               np.asarray(wb, np.float32), rtol=2 ** -6,
                               atol=2e-2)


#: name -> (flax module, port module factory)
MODULES = {
    "FusedDense": (lambda: jfd.FusedDense(16, 8),
                   lambda: tfd.FusedDense(16, 8, device="cpu")),
    "FusedDense_nobias": (lambda: jfd.FusedDense(16, 8, bias=False),
                          lambda: tfd.FusedDense(16, 8, bias=False,
                                                 device="cpu")),
    "FusedDenseGeluDense": (
        lambda: jfd.FusedDenseGeluDense(16, 32, 8),
        lambda: tfd.FusedDenseGeluDense(16, 32, 8, device="cpu")),
    "MLP_relu": (lambda: jfd.MLP((16, 32, 12, 8)),
                 lambda: tfd.MLP((16, 32, 12, 8), device="cpu")),
    "MLP_sigmoid": (lambda: jfd.MLP((16, 32, 8), activation="sigmoid"),
                    lambda: tfd.MLP((16, 32, 8), activation="sigmoid",
                                    device="cpu")),
    "MLP_none_nobias": (lambda: jfd.MLP((16, 32, 8), bias=False,
                                       activation="none"),
                        lambda: tfd.MLP((16, 32, 8), bias=False,
                                        activation="none", device="cpu")),
}


@pytest.mark.parametrize("name", list(MODULES))
def test_modules_and_grads_match_flax(name):
    jmake, tmake = MODULES[name]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 16)).astype(np.float32)
    ct = rng.standard_normal((5, 8)).astype(np.float32)
    jm = jmake()
    params = jm.init(jax.random.key(1), jnp.asarray(x))["params"]

    def jloss(p, xx):
        return jnp.sum(jm.apply({"params": p}, xx) * jnp.asarray(ct))

    jy = jm.apply({"params": params}, jnp.asarray(x))
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    tm = module_params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                tmake())
    tx = _t(x).requires_grad_()
    ty = tm(tx)
    (ty * _t(ct)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-5)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgp[n]),
                                   rtol=1e-5, atol=1e-5, err_msg=n)


def test_mlp_needs_two_sizes_and_modules_default_to_cuda():
    with pytest.raises(ValueError, match="mlp_sizes"):
        tfd.MLP((4,), device="cpu")
    for make in (lambda: tfd.FusedDense(4, 4),
                 lambda: tfd.FusedDenseGeluDense(4, 8, 4),
                 lambda: tfd.MLP((4, 8))):
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                make()
        else:
            assert {p.device.type for p in make().parameters()} == {"cuda"}
