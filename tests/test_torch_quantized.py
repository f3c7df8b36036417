"""Weight-only int8 quantization and matmul (`ops.quantized`, TPU row 20)
against the JAX package on the CPU.

- `quantize_int8`: ``q`` and ``s`` bit for bit against JAX's, on random
  weights, with an all-zero channel, with ``axis=0``;
- `int8_matmul`: against JAX's XLA composite (``_dequant_matmul_xla``)
  and its Pallas kernel in interpret mode (128-aligned shapes, also at
  T on both sides of the CUDA kernel's token tiles: 1, 8, 9, 63, 64, 65,
  129, 257) within 1e-5 relative (the sums' order is not pinned),
  leading dimensions kept, and ``dx`` against ``jax.grad`` within 1e-5;
  the weights get no gradient; a CUDA-only kernel call on the CPU raises
  under ``force_impl("kernel")``; the kernel's K-split plan.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex1_tpu.ops import _common as jax_common
from apex1_tpu.ops.quantized import _dequant_matmul_xla
from apex1_tpu.ops.quantized import int8_matmul as jax_int8_matmul
from apex1_tpu.ops.quantized import quantize_int8 as jax_quantize_int8
from apex1_tpu_torch.ops import force_impl
from apex1_tpu_torch.ops.quantized import (_split_k, int8_matmul, int8_mm,
                                           quantize_int8)


def _w(shape, seed, scale=0.1):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


@pytest.mark.parametrize("case", ["random", "zero_channel", "axis0", "wide"])
def test_quantize_int8_bitwise(case):
    w = _w((48, 80), 1)
    axis = -1
    if case == "zero_channel":
        w[3] = 0.0
        w[7, :5] = 0.0
    elif case == "axis0":
        axis = 0
    elif case == "wide":
        w = _w((16, 300), 2, scale=7.0)
    jq, js = jax_quantize_int8(jnp.asarray(w), axis=axis)
    q, s = quantize_int8(torch.from_numpy(w), axis=axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    if case == "zero_channel":
        assert (q.numpy()[3] == 0).all() and s[3].item() == np.float32(1e-12)


def test_quantize_int8_rejects_bad_input():
    with pytest.raises(ValueError, match="2-D"):
        quantize_int8(torch.zeros(2, 3, 4))
    with pytest.raises(ValueError, match="axis"):
        quantize_int8(torch.zeros(2, 3), axis=2)


def _operands(T, N, K, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, K)).astype(np.float32)
    wq, s = jax_quantize_int8(jnp.asarray(_w((N, K), seed + 1)))
    return x, np.array(wq), np.array(s)


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("shape", [(8, 256, 128), (5, 128, 384),
                                   (16, 384, 256)])
def test_int8_matmul_matches_jax(impl, shape):
    T, N, K = shape
    x, wq, s = _operands(T, N, K, seed=T + N)
    xb = jnp.asarray(x, jnp.bfloat16)
    with jax_common.force_impl(impl):
        want = jax_int8_matmul(xb, jnp.asarray(wq), jnp.asarray(s))
    got = int8_matmul(torch.from_numpy(x).to(torch.bfloat16),
                      torch.from_numpy(wq), torch.from_numpy(s))
    assert got.dtype == torch.float32 and tuple(got.shape) == (T, N)
    _close(got.numpy(), np.asarray(want))


#: the CUDA kernel's tile edges in T (its 8-, 16-, 32-, 64- and 128-token
#: tiles) at shapes JAX's Pallas gate takes (N and K multiples of 128,
#: T <= 1024): (T, N, K)
_TILE_EDGES = [(1, 128, 128), (8, 256, 256), (9, 128, 384), (63, 256, 128),
               (64, 128, 256), (65, 384, 128), (129, 256, 256),
               (257, 128, 128)]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("shape", _TILE_EDGES,
                         ids=lambda s: "x".join(map(str, s)))
def test_int8_matmul_tile_edges_match_jax(impl, shape):
    """The plain version the kernel is held to on the card, against JAX's
    composite and its Pallas kernel (interpret mode) at the rows on both
    sides of the kernel's token tiles, within 1e-5."""
    T, N, K = shape
    x, wq, s = _operands(T, N, K, seed=3 * T + N)
    with jax_common.force_impl(impl):
        want = jax_int8_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(wq),
                               jnp.asarray(s))
    got = int8_matmul(torch.from_numpy(x).to(torch.bfloat16),
                      torch.from_numpy(wq), torch.from_numpy(s))
    assert got.dtype == torch.float32 and tuple(got.shape) == (T, N)
    _close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(3, 60, 72), (1, 200, 16), (7, 5, 33)])
def test_int8_matmul_ragged_matches_composite(shape):
    """Shapes JAX's kernel gate sends to its composite: the port's plain
    version is that composite (fp32 x rounded to bf16 first)."""
    T, N, K = shape
    x, wq, s = _operands(T, N, K, seed=K)
    want = _dequant_matmul_xla(jnp.asarray(x), jnp.asarray(wq),
                               jnp.asarray(s))
    got = int8_mm(torch.from_numpy(x), torch.from_numpy(wq),
                  torch.from_numpy(s))
    _close(got.numpy(), np.asarray(want))


def test_int8_matmul_leading_dims_and_grad():
    rng = np.random.default_rng(3)
    wq, s = jax_quantize_int8(jnp.asarray(_w((128, 128), 4, 1.0)))
    x = rng.normal(size=(2, 5, 128)).astype(np.float32)
    dy = rng.normal(size=(2, 5, 128)).astype(np.float32)
    want, vjp = jax.vjp(lambda x: jax_int8_matmul(x, wq, s), jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(np.array(wq))
    st = torch.from_numpy(np.array(s)).requires_grad_()
    y = int8_matmul(xt, wt, st)
    assert tuple(y.shape) == (2, 5, 128) and y.dtype == torch.float32
    _close(y.detach().numpy(), np.asarray(want))
    y.backward(torch.from_numpy(dy))
    assert xt.grad.dtype == torch.float32 and st.grad is None
    _close(xt.grad.numpy(), np.asarray(jdx))
    # bf16 activations: dx comes back in bf16, as JAX's x_proto dtype
    xb = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    int8_matmul(xb, wt, st).sum().backward()
    assert xb.grad.dtype == torch.bfloat16


def test_int8_mm_cpu_refuses_forced_kernel():
    x, wq, s = _operands(2, 4, 16, seed=9)
    with force_impl("kernel"), pytest.raises(RuntimeError, match="CUDA"):
        int8_mm(torch.from_numpy(x), torch.from_numpy(wq),
                torch.from_numpy(s))


@pytest.mark.parametrize("shape,want", [
    ((8, 5632, 2048), (3, 704)), ((8, 256, 2048), (16, 128)),
    ((8, 32000, 2048), (1, 2048)), ((1024, 5632, 2048), (1, 2048)),
    ((5, 200, 72), (2, 64))])
def test_split_k_plan(shape, want):
    """The kernel's K split: narrow grids split K into 64-deep multiples
    that cover it exactly once."""
    T, N, K = shape
    splits, kc = _split_k(T, N, K)
    assert (splits, kc) == want
    assert kc % 64 == 0 and (splits - 1) * kc < K <= splits * kc
