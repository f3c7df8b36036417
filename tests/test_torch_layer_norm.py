"""`apex1_tpu_torch.ops.layer_norm` against `apex1_tpu.ops.layer_norm`.

The same numpy inputs go through the JAX function (its XLA composite
and its Pallas kernel in interpret mode) and the port's plain PyTorch
version on the CPU. f32 within 1e-5; bf16 x with f32 γ/β within 1e-2
(one bf16 rounding of the output). The CUDA kernel is held against the
plain version on the card (tests/test_torch_kernels_gpu.py and
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex1_tpu.ops import _common as jax_common
from apex1_tpu.ops.layer_norm import layer_norm as jax_layer_norm
from apex1_tpu.ops.layer_norm import rms_norm as jax_rms_norm
from apex1_tpu_torch.ops import force_impl
from apex1_tpu_torch.ops.layer_norm import (layer_norm, layer_norm_fwd,
                                            rms_norm)

_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    g = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    b = (0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    return x, g, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("shape", [(3, 5, 128), (7, 96)])
@pytest.mark.parametrize("rms", [False, True], ids=["ln", "rms"])
def test_norm_matches_jax(shape, impl, dtype, rms):
    x, g, b = _inputs(shape)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    with jax_common.force_impl(impl):
        if rms:
            want = jax_rms_norm(jx, jnp.asarray(g))
        else:
            want = jax_layer_norm(jx, jnp.asarray(g), jnp.asarray(b))
    want = np.asarray(want.astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    if rms:
        got = rms_norm(tx, torch.from_numpy(g))
    else:
        got = layer_norm(tx, torch.from_numpy(g), torch.from_numpy(b))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    tol = _TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol)


def test_stats_are_the_row_moments():
    """mean and rstd: the fp32 row statistics the backward will reuse."""
    x, g, b = _inputs((6, 96), seed=3)
    y, mean, rstd = layer_norm_fwd(torch.from_numpy(x), torch.from_numpy(g),
                                   torch.from_numpy(b), 1e-5, False)
    np.testing.assert_allclose(mean.numpy(), x.mean(-1), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), 1 / np.sqrt(x.var(-1) + 1e-5),
                               rtol=1e-4)


def test_kernel_impl_refuses_cpu_tensors():
    """No silent plain run: forcing the kernel on a CPU tensor raises."""
    x, g, b = _inputs((2, 32))
    with force_impl("kernel"), pytest.raises(RuntimeError, match="CUDA"):
        layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                   torch.from_numpy(b))
