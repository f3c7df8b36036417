"""The fused LM-head cross-entropy against the JAX package, on the CPU.

The same numpy inputs and cotangents go through the JAX function (its
Pallas kernels in interpret mode, the XLA composite where stated) and
through the port's plain PyTorch path (the CUDA kernels' plain
versions), with V and H not multiples of 128:

- ``linear_cross_entropy`` loss, dx and dW under ``jax.vjp`` and
  autograd, with smoothing 0 and 0.1, ``padding_idx``, ``num_classes``
  masking and leading dims: f32 within 2e-5 (the tolerance of
  tests/test_linear_xent.py);
- bf16 and fp16 inputs against JAX's interpret-mode kernels, which
  round the grad tile to the operand type as the port does: within
  1e-2 relative to each output's largest value (bf16 and fp16
  roundings of G, dx and dW);
- ``shard_stats`` with a ``col_offset`` shard, ``shard_stats_packed``
  bit-equal to it, and ``shard_grads`` with labels outside the shard:
  f32 within 2e-5;
- the loss (against ``_fused`` in interpret mode and the XLA composite)
  and ``shard_stats`` (interpret mode) at the edges of the Hopper
  forward's tiles: T and V off 128 and 256, H of 64k ± 1 and 769, a
  ``num_classes`` cut inside a tile, a shard whose last tiles hold no
  valid column, labels on the tiles' edges: f32 within 2e-5.

The CUDA kernels are held against the same plain versions on the card
(tests/test_torch_kernels_gpu.py and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex1_tpu.ops import _common as jax_common
from apex1_tpu.ops import linear_xent as jax_lx
from apex1_tpu_torch.ops import linear_xent as lx

FP32_TOL = dict(rtol=2e-5, atol=2e-5)
T, H, V = 24, 96, 307


def _inputs(seed, t=T, h=H, v=V, lead=None):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((t, h)) * 0.3).astype(np.float32)
    w = (rng.standard_normal((v, h)) * 0.3).astype(np.float32)
    labels = rng.integers(0, v, t).astype(np.int32)
    ct = rng.standard_normal(t).astype(np.float32)
    if lead is not None:
        x = x.reshape(*lead, h)
        labels = labels.reshape(lead)
        ct = ct.reshape(lead)
    return x, w, labels, ct


def _jax_vjp(x, w, labels, ct, impl, dtype=jnp.float32, **kw):
    def f(x_, w_):
        with jax_common.force_impl(impl):
            return jax_lx.linear_cross_entropy(
                x_, w_, jnp.asarray(labels), block_t=16, block_v=64, **kw)

    loss, vjp = jax.vjp(f, jnp.asarray(x, dtype), jnp.asarray(w, dtype))
    dx, dw = vjp(jnp.asarray(ct))
    return [np.asarray(a, np.float32) for a in (loss, dx, dw)]


def _port_vjp(x, w, labels, ct, dtype=torch.float32, **kw):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    wt = torch.from_numpy(w).to(dtype).requires_grad_()
    loss = lx.linear_cross_entropy(xt, wt, torch.from_numpy(labels), **kw)
    dx, dw = torch.autograd.grad(loss, (xt, wt), torch.from_numpy(ct))
    assert loss.dtype == torch.float32
    assert dx.dtype == dtype and dw.dtype == dtype
    return [t.detach().float().numpy() for t in (loss, dx, dw)]


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_loss_dx_dw_match_jax(impl, smoothing):
    x, w, labels, ct = _inputs(0)
    want = _jax_vjp(x, w, labels, ct, impl, smoothing=smoothing)
    got = _port_vjp(x, w, labels, ct, smoothing=smoothing)
    for g, wv, name in zip(got, want, ("loss", "dx", "dw")):
        np.testing.assert_allclose(g, wv, err_msg=name, **FP32_TOL)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_padding_idx_num_classes_and_leading_dims_match_jax(impl):
    x, w, labels, ct = _inputs(1, lead=(3, 8))
    labels[:, ::3] = 7
    kw = dict(smoothing=0.1, padding_idx=7, num_classes=290)
    labels = np.minimum(labels, 289)
    want = _jax_vjp(x, w, labels, ct, impl, **kw)
    got = _port_vjp(x, w, labels, ct, **kw)
    assert got[0].shape == (3, 8)
    assert not got[0][:, ::3].any() and not got[1][:, ::3].any()
    # the masked vocab rows get no gradient
    assert not got[2][290:].any()
    for g, wv, name in zip(got, want, ("loss", "dx", "dw")):
        np.testing.assert_allclose(g, wv, err_msg=name, **FP32_TOL)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_wide_head_matches_jax(impl):
    """H = 1024 > MAX_H: the head width the CUDA kernels' wide path
    takes (the plain versions are the same at any H)."""
    assert 1024 > lx.MAX_H
    x, w, labels, ct = _inputs(4, t=16, h=1024, v=203)
    kw = dict(smoothing=0.1, num_classes=200)
    labels = np.minimum(labels, 199)
    want = _jax_vjp(x, w, labels, ct, impl, **kw)
    got = _port_vjp(x, w, labels, ct, **kw)
    for g, wv, name in zip(got, want, ("loss", "dx", "dw")):
        np.testing.assert_allclose(g, wv, err_msg=name, **FP32_TOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_half_inputs_match_jax_kernels(dtype):
    x, w, labels, ct = _inputs(2, lead=(2, 12))
    want = _jax_vjp(x, w, labels, ct, "pallas", getattr(jnp, dtype),
                    num_classes=300)
    got = _port_vjp(x, w, labels, ct, getattr(torch, dtype),
                    num_classes=300)
    for g, wv, name in zip(got, want, ("loss", "dx", "dw")):
        scale = np.abs(wv).max()
        np.testing.assert_allclose(g, wv, rtol=1e-2, atol=1e-2 * scale,
                                   err_msg=name)


def _shard(seed):
    """A (T, H) x, a W shard of 130 rows at global columns [200, 330)
    of K = 317 classes, and labels half inside the shard."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((T, H)) * 0.3).astype(np.float32)
    w = (rng.standard_normal((130, H)) * 0.3).astype(np.float32)
    labels = rng.integers(0, 317, T).astype(np.int32)
    labels[::2] = rng.integers(200, 317, T // 2)
    return x, w, labels, dict(col_offset=200, num_classes=317)


def test_shard_stats_and_packed_match_jax():
    x, w, labels, kw = _shard(3)
    want = jax_lx.shard_stats(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(labels).reshape(-1, 1),
                              block_t=16, block_v=64, **kw)
    xt, wt, lt = map(torch.from_numpy, (x, w, labels))
    got = lx.shard_stats(xt, wt, lt, **kw)
    for g, wv, name in zip(got, want, ("m", "l", "tgt", "sumx")):
        assert g.shape == (T,) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), err_msg=name,
                                   **FP32_TOL)
    packed = lx.shard_stats_packed(xt, wt, lt, **kw)
    assert packed.shape == (T, 4)
    assert torch.equal(packed, torch.stack(got, dim=1))
    jpacked = jax_lx.shard_stats_packed(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(labels).reshape(-1, 1),
                                        block_t=16, block_v=64, **kw)
    np.testing.assert_allclose(packed.numpy(), np.asarray(jpacked),
                               **FP32_TOL)


def test_shard_grads_match_jax():
    x, w, labels, kw = _shard(4)
    rng = np.random.default_rng(5)
    lse = (rng.standard_normal(T) + 6.0).astype(np.float32)
    dloss = rng.standard_normal(T).astype(np.float32)
    jdx, jdw = jax_lx.shard_grads(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels).reshape(-1, 1),
        jnp.asarray(lse), jnp.asarray(dloss), smoothing=0.1, padding_idx=3,
        block_t=16, block_v=64, **kw)
    dx, dw = lx.shard_grads(*map(torch.from_numpy, (x, w, labels, lse,
                                                    dloss)),
                            smoothing=0.1, padding_idx=3, **kw)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **FP32_TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), **FP32_TOL)
    assert dx.shape == (T, H) and dw.shape == (130, H)


def test_plain_versions_walk_the_vocab_in_chunks(monkeypatch):
    """The plain versions never hold a (T, V) tile: a 64-column walk
    gives what one chunk gives, within fp32 rounding."""
    x, w, labels, ct = _inputs(6)
    whole = _port_vjp(x, w, labels, ct, smoothing=0.1)
    monkeypatch.setattr(lx, "PLAIN_CHUNK", 64)
    chunked = _port_vjp(x, w, labels, ct, smoothing=0.1)
    for g, wv in zip(chunked, whole):
        np.testing.assert_allclose(g, wv, rtol=1e-6, atol=1e-6)


def test_shape_checks_and_launch_counters():
    x, w, labels, _ = _inputs(7)
    xt, wt, lt = map(torch.from_numpy, (x, w, labels))
    with pytest.raises(ValueError, match="hidden mismatch"):
        lx.linear_cross_entropy(xt[:, :50], wt, lt)
    with pytest.raises(ValueError, match="num_classes"):
        lx.linear_cross_entropy(xt, wt, lt, num_classes=V + 1)
    with pytest.raises(ValueError, match="mode"):
        lx.lxent_fwd(xt, wt, lt, num_classes=V, mode=3)
    # CPU tensors take the plain versions: no launch is counted
    before = (lx.lxent_fwd.launches, lx.lxent_dx.launches,
              lx.lxent_dw.launches)
    loss = lx.linear_cross_entropy(xt.requires_grad_(), wt, lt)
    loss.sum().backward()
    assert (lx.lxent_fwd.launches, lx.lxent_dx.launches,
            lx.lxent_dw.launches) == before
    # mixed operand types promote, as JAX's dot does
    mixed = lx.linear_cross_entropy(xt.detach(), wt.bfloat16(), lt)
    assert mixed.dtype == torch.float32 and mixed.shape == (T,)


#: the Hopper forward's tile edges (tests/test_torch_kernels_gpu.py
#: ``_LXENT_FWD``) at a CPU size: name -> (T, V, H, K, col_offset,
#: smoothing, padding_idx)
_EDGES = {
    "t130_v333": (130, 333, 96, 333, 0, 0.0, None),
    "h63": (40, 300, 63, 300, 0, 0.0, None),
    "h65_smooth_pad": (40, 300, 65, 300, 0, 0.1, 3),
    "h127": (24, 280, 127, 280, 0, 0.0, None),
    "h769": (24, 300, 769, 300, 0, 0.1, None),
    "k_cut_in_tile": (40, 700, 128, 450, 0, 0.1, 5),
    "shard_cut_and_empty_tiles": (40, 700, 128, 700, 300, 0.0, None),
}
#: label columns around the tiles' edges (global = col_offset + these;
#: the real classes among them)
_TILE_EDGES = (0, 1, 63, 64, 127, 128, 129, 255, 256, 257, 383, 384, 399,
               400, 511, 512)


def _edge_inputs(name):
    T_, V_, H_, K, off, eps, pad = _EDGES[name]
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((T_, H_)) * 0.3).astype(np.float32)
    w = (rng.standard_normal((V_, H_)) * 0.3
         * min(1.0, (96 / H_) ** 0.5)).astype(np.float32)
    labels = rng.integers(0, K, T_).astype(np.int32)
    edges = [off + e for e in _TILE_EDGES if off + e < K]
    labels[::2] = np.resize(edges, labels[::2].shape)
    if pad is not None:
        labels[::9] = pad
    return x, w, labels, K, off, eps, pad


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("name", [n for n, c in _EDGES.items() if not c[4]])
def test_loss_at_tile_edges_matches_jax(name, impl):
    x, w, labels, K, _, eps, pad = _edge_inputs(name)
    kw = dict(smoothing=eps, padding_idx=pad, num_classes=K)
    with jax_common.force_impl(impl):
        want = jax_lx.linear_cross_entropy(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels), block_t=16,
            block_v=64, **kw)
    got = lx.linear_cross_entropy(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(labels), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)
    if pad is not None:
        assert not got.numpy()[labels == pad].any()


@pytest.mark.parametrize("name", list(_EDGES))
def test_shard_stats_at_tile_edges_match_jax(name):
    x, w, labels, K, off, _, _ = _edge_inputs(name)
    kw = dict(col_offset=off, num_classes=K)
    want = jax_lx.shard_stats(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(labels).reshape(-1, 1),
                              block_t=16, block_v=64, **kw)
    xt, wt, lt = map(torch.from_numpy, (x, w, labels))
    got = lx.shard_stats(xt, wt, lt, **kw)
    for g, wv, stat in zip(got, want, ("m", "l", "tgt", "sumx")):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), err_msg=stat,
                                   **FP32_TOL)
    assert torch.equal(lx.shard_stats_packed(xt, wt, lt, **kw),
                       torch.stack(got, dim=1))
