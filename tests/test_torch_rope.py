"""Rotary positional embedding, the port against the JAX package on the
CPU.

The same numpy inputs and cotangents go through JAX's
``apply_rotary_pos_emb`` (its XLA composite at head_dim 16 and 128,
where the TPU kernel's lane rule keeps JAX off its Pallas kernel, and
its Pallas kernel in interpret mode at head_dim 256) and through the
port's plain path (the CUDA kernel's plain version): the output and
the gradient, for shared and per-row tables, both conventions, an
explicit and an inferred sequence axis; f32 within 1e-5, bf16 and fp16
within one ulp of the output type. The CUDA kernel is held against the
same plain version on the card (tests/test_torch_kernels_gpu.py and
chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex1_tpu.ops import _common as jax_common
from apex1_tpu.ops import rope as jax_rope
from apex1_tpu_torch.ops import rope as rp

#: (rtol, atol) per dtype: f32 1e-5; half types one ulp of the value
TOLS = {"float32": (1e-5, 1e-6), "bfloat16": (2.0 ** -7, 1e-6),
        "float16": (2.0 ** -10, 1e-6)}

#: (name, x shape, table kind, interleaved, seq_axis, JAX impl)
CASES = [
    ("d16", (2, 5, 3, 16), "shared", False, None, "xla"),
    ("d128", (2, 7, 4, 128), "shared", False, None, "xla"),
    ("d128-per-row", (2, 7, 4, 128), "per_row", False, None, "xla"),
    ("d16-interleaved", (2, 5, 3, 16), "shared", True, None, "xla"),
    ("d128-interleaved-per-row", (3, 6, 2, 128), "per_row", True, None,
     "xla"),
    ("seq-head_dim", (2, 9, 16), "shared", False, None, "xla"),
    ("explicit-seq-axis", (4, 4, 4, 16), "shared", False, -2, "xla"),
    ("d256-pallas", (2, 4, 2, 256), "shared", False, None, "pallas"),
    ("d256-pallas-per-row", (2, 4, 2, 256), "per_row", False, None,
     "pallas"),
    ("d256-pallas-interleaved", (2, 4, 2, 256), "shared", True, None,
     "pallas"),
]


def _inputs(shape, kind, seq_axis, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    ct = rng.standard_normal(shape).astype(np.float32)
    # every case's sequence axis is 1 unless named
    ax = 1 if seq_axis is None else seq_axis % len(shape)
    S, D = shape[ax], shape[-1]
    if kind == "per_row":
        pos = rng.integers(0, 50, (shape[0], S))
        cos, sin = jax_rope.rope_tables(jnp.asarray(pos.reshape(-1)), D)
        cos = np.asarray(cos).reshape(shape[0], S, -1)
        sin = np.asarray(sin).reshape(shape[0], S, -1)
    else:
        cos, sin = (np.asarray(t) for t in
                    jax_rope.rope_tables(jnp.arange(S) + 3, D, base=500000.0))
    return x, ct, cos, sin


def _jax(x, ct, cos, sin, impl, dtype, **kw):
    def f(x_):
        with jax_common.force_impl(impl):
            return jax_rope.apply_rotary_pos_emb(
                x_, jnp.asarray(cos), jnp.asarray(sin), **kw)

    out, vjp = jax.vjp(f, jnp.asarray(x, dtype))
    dx, = vjp(jnp.asarray(ct, dtype))
    return np.asarray(out, np.float32), np.asarray(dx, np.float32)


def _port(x, ct, cos, sin, dtype, **kw):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    out = rp.apply_rotary_pos_emb(xt, torch.from_numpy(cos),
                                  torch.from_numpy(sin), **kw)
    dx, = torch.autograd.grad(out, xt, torch.from_numpy(ct).to(dtype))
    assert out.dtype == dtype and dx.dtype == dtype
    return out.detach().float().numpy(), dx.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_rope_and_grad_match_jax(case, dtype):
    name, shape, kind, interleaved, seq_axis, impl = case
    x, ct, cos, sin = _inputs(shape, kind, seq_axis, len(name))
    kw = dict(interleaved=interleaved, seq_axis=seq_axis)
    want = _jax(x, ct, cos, sin, impl, getattr(jnp, dtype), **kw)
    got = _port(x, ct, cos, sin, getattr(torch, dtype), **kw)
    rtol, atol = TOLS[dtype]
    for g, w, what in zip(got, want, ("out", "dx")):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=what)


def test_tables_match_jax():
    pos = np.asarray([0, 1, 7, 4095, 8191])
    want = jax_rope.rope_tables(jnp.asarray(pos), 128, base=500000.0)
    got = rp.rope_tables(torch.from_numpy(pos), 128, base=500000.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_backward_is_the_rotation_by_minus_theta():
    x, ct, cos, sin = _inputs((2, 5, 3, 16), "shared", None, 0)
    xt = torch.from_numpy(x)
    c, s = torch.from_numpy(cos), torch.from_numpy(sin)
    there = rp.apply_rotary_pos_emb(xt, c, s)
    back = rp.rotate(there, c, s, interleaved=False, seq_axis=1, sign=-1.0)
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-5, atol=1e-5)


def test_errors_and_launch_counter():
    x = torch.zeros(2, 5, 3, 16)
    c, s = rp.rope_tables(torch.arange(5), 16)
    with pytest.raises(ValueError, match="cannot infer sequence axis"):
        rp.apply_rotary_pos_emb(x, c[:4], s[:4])
    with pytest.raises(ValueError, match="head_dim must be even"):
        rp.apply_rotary_pos_emb(torch.zeros(2, 5, 3, 15), c, s)
    with pytest.raises(ValueError, match="per-row tables"):
        rp.apply_rotary_pos_emb(x, c.expand(3, 5, 8), s.expand(3, 5, 8))
    with pytest.raises(ValueError, match="cannot infer"):
        jax_rope.apply_rotary_pos_emb(jnp.zeros((2, 5, 3, 16)),
                                      jnp.asarray(c[:4].numpy()),
                                      jnp.asarray(s[:4].numpy()))
    # CPU tensors take the plain version: no launch is counted
    before = rp.rotate.launches
    rp.apply_rotary_pos_emb(x.requires_grad_(), c, s).sum().backward()
    assert rp.rotate.launches == before
