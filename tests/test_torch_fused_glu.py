"""The fused gated MLP (``fused_glu``), the port against the JAX package
on the CPU.

The same numpy inputs and cotangent go through JAX's ``fused_glu`` (its
Pallas kernel in interpret mode, whose dots sum in fp32 and whose
epilogue is fp32, and its XLA composite) and through the port's plain
path (the CUDA kernel's plain version, the same fp32 numbers): the
output and the three grads of the recompute backward, for silu and
gelu, also at the CUDA kernel's tile edges (T around 128, H around 64,
F around 128 and 64). f32 within 1e-5 of both; bf16 within one ulp of
JAX's Pallas
kernel (the composite rounds g and u to bf16 before the product, so it
is held only in f32). Plus the activation and tile errors. The CUDA
kernel is held against the same plain version on the card
(tests/test_torch_kernels_gpu.py and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex1_tpu.ops import _common as jax_common
from apex1_tpu.ops import fused_dense as jax_fd
from apex1_tpu_torch.ops import fused_dense as fd

T, H, F = 20, 72, 136


def _inputs(seed, lead=(4, 5)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*lead, H)).astype(np.float32)
    wg = (rng.standard_normal((H, F)) * H ** -0.5).astype(np.float32)
    wu = (rng.standard_normal((H, F)) * H ** -0.5).astype(np.float32)
    ct = rng.standard_normal((*lead, F)).astype(np.float32)
    return x, wg, wu, ct


def _jax(x, wg, wu, ct, impl, dtype, activation):
    def f(*a):
        with jax_common.force_impl(impl):
            return jax_fd.fused_glu(*a, activation=activation)

    out, vjp = jax.vjp(f, *(jnp.asarray(a, dtype) for a in (x, wg, wu)))
    grads = vjp(jnp.asarray(ct, dtype))
    return [np.asarray(a, np.float32) for a in (out, *grads)]


def _port(x, wg, wu, ct, dtype, activation):
    ins = [torch.from_numpy(a).to(dtype).requires_grad_()
           for a in (x, wg, wu)]
    out = fd.fused_glu(*ins, activation=activation)
    grads = torch.autograd.grad(out, ins, torch.from_numpy(ct).to(dtype))
    assert out.dtype == dtype and all(g.dtype == dtype for g in grads)
    return [t.detach().float().numpy() for t in (out, *grads)]


@pytest.mark.parametrize("activation", ["silu", "gelu"])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_f32_out_and_grads_match_jax(impl, activation):
    x, wg, wu, ct = _inputs(0)
    want = _jax(x, wg, wu, ct, impl, jnp.float32, activation)
    got = _port(x, wg, wu, ct, torch.float32, activation)
    for g, w, name in zip(got, want, ("out", "dx", "dwg", "dwu")):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=name)


#: the CUDA kernel's tile edges, small: T on both sides of its 128-row
#: tile, H of its 64-deep K step, F of its 128- and 64-column tiles
_TILE_EDGES = [(127, 63, 127), (128, 64, 128), (129, 65, 129), (1, 64, 64)]


@pytest.mark.parametrize("activation", ["silu", "gelu"])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("shape", _TILE_EDGES,
                         ids=lambda s: "x".join(map(str, s)))
def test_f32_tile_edges_match_jax(shape, impl, activation):
    """Out and the three grads at the CUDA kernel's tile edges against
    JAX's Pallas kernel (interpret mode) and its XLA composite, f32
    within 1e-5 (the plain version the kernel is held to on the card)."""
    T, Hs, Fs = shape
    rng = np.random.default_rng(T + Hs + Fs)
    x = rng.standard_normal((T, Hs)).astype(np.float32)
    wg = (rng.standard_normal((Hs, Fs)) * Hs ** -0.5).astype(np.float32)
    wu = (rng.standard_normal((Hs, Fs)) * Hs ** -0.5).astype(np.float32)
    ct = rng.standard_normal((T, Fs)).astype(np.float32)
    want = _jax(x, wg, wu, ct, impl, jnp.float32, activation)
    got = _port(x, wg, wu, ct, torch.float32, activation)
    for g, w, name in zip(got, want, ("out", "dx", "dwg", "dwu")):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_bf16_within_one_ulp_of_jax_kernel(activation):
    x, wg, wu, ct = _inputs(1)
    want = _jax(x, wg, wu, ct, "pallas", jnp.bfloat16, activation)
    got = _port(x, wg, wu, ct, torch.bfloat16, activation)
    # one bf16 ulp of each element; the grads' fp32 sums run in another
    # order, so an element near 0 also gets 1e-3 of the output's scale
    for g, w, name in zip(got, want, ("out", "dx", "dwg", "dwu")):
        np.testing.assert_allclose(g, w, rtol=2.0 ** -7,
                                   atol=1e-3 * np.abs(w).max(),
                                   err_msg=name)


def test_errors_and_launch_counter():
    x, wg, wu, _ = (torch.from_numpy(a) for a in _inputs(2))
    with pytest.raises(ValueError, match="activation must be one of"):
        fd.fused_glu(x, wg, wu, activation="relu")
    with pytest.raises(ValueError, match="multiple of 8"):
        fd.fused_glu(x, wg, wu, block_t=12)
    with pytest.raises(ValueError, match="multiple of 128"):
        fd.fused_glu(x, wg, wu, block_f=100)
    with pytest.raises(ValueError, match="multiple of 8"):
        jax_fd.check_glu_geometry(12, 256, H)
    assert fd.check_glu_geometry(16, 256) == (16, 256)
    # CPU tensors take the plain version: no launch is counted
    before = fd.glu_fwd.launches
    out = fd.fused_glu(x.requires_grad_(), wg, wu, block_t=8, block_f=128)
    out.sum().backward()
    assert out.shape == (4, 5, F)
    assert fd.glu_fwd.launches == before
