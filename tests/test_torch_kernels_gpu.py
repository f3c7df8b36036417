"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one; the
file imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_kernels_gpu.py

Tolerances: layer norm f32 1e-5 and bf16 1e-2 (one bf16 rounding).
Paged attention (an online softmax across pages against one softmax
over the gathered lane), per element, |got - want| <= rtol * |want| +
atol * rms(want): f32 rtol 1e-5, atol 1e-4; bf16 rtol 2^-7 (one bf16
ulp), atol 3e-2 (the plain version rounds the probabilities to bf16).
Sampled token ids exactly (the kernel's gumbel noise equals torch.log's
on the card). The training kernels (layer norm backward, softmax
forward and backward, cross-entropy forward and backward) per element
as paged attention, with fp16 at rtol 2^-10 (one fp16 ulp), atol 1e-2;
the layer norm backward also gives the same bits on a second run.
"""

import numpy as np
import pytest
import torch

from apex1_tpu_torch.ops import force_impl
from apex1_tpu_torch.ops import paged_decode as tpd
from apex1_tpu_torch.ops.layer_norm import layer_norm, rms_norm

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _both(fn):
    got = fn()
    with force_impl("torch"):
        want = fn()
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("rms", [False, True], ids=["ln", "rms"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_layer_norm_kernel_matches_plain(cuda, dtype, rms):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((64, 768)).astype(np.float32))
    x = (x * 2 + 0.5).to(cuda, getattr(torch, dtype))
    g = torch.from_numpy(1 + 0.1 * rng.standard_normal(768)).float().to(cuda)
    b = torch.from_numpy(0.1 * rng.standard_normal(768)).float().to(cuda)
    got, want = _both((lambda: rms_norm(x, g)) if rms
                      else (lambda: layer_norm(x, g, b)))
    assert got.dtype == x.dtype
    tol = 1e-5 if dtype == "float32" else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("hkv", [12, 4], ids=["mha", "gqa3"])
@pytest.mark.parametrize("s", [1, 5])
@pytest.mark.parametrize("page_dtype", ["float32", "bfloat16", "int8"])
def test_paged_attend_kernel_matches_plain(cuda, page_dtype, s, hkv):
    rng = np.random.default_rng(6)
    N, P, T, D = 4, 16, 6, 64
    n_pages = 1 + N * T
    raw = rng.standard_normal((2, n_pages, hkv, P, D))
    q = rng.standard_normal((N, 12, s, D))
    if page_dtype == "int8":
        # K at 30x scale, q at 1/30: unit-spread scores, so the softmax
        # folds over many positions across pages
        kv = torch.from_numpy(np.clip(np.round(raw * 30), -127, 127)
                              ).to(cuda, torch.int8)
        q, q_dt = q / 30, torch.bfloat16
    else:
        kv = torch.from_numpy(raw).to(cuda, getattr(torch, page_dtype))
        q_dt = getattr(torch, page_dtype)
    q = torch.from_numpy(q).to(cuda, q_dt)
    bt = torch.from_numpy(rng.permutation(np.arange(1, n_pages))
                          .reshape(N, T).astype(np.int32)).to(cuda)
    lens = torch.tensor([0, 15, 16, T * P - s], dtype=torch.int32,
                        device=cuda)
    k, v = kv[0].contiguous(), kv[1].contiguous()
    got, want = _both(lambda: tpd.paged_attend(q, k, v, bt, lens,
                                               total_len=T * P))
    assert got.dtype == q.dtype and got.shape == q.shape
    rms = want.float().pow(2).mean().sqrt().item()
    rtol, atol = (1e-5, 1e-4) if q_dt == torch.float32 else (2.0 ** -7, 3e-2)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol * rms)


@pytest.mark.parametrize("top_k", [None, 40])
@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.3])
@pytest.mark.parametrize("partitionable", [True, False])
def test_fused_sample_kernel_bitwise_plain(cuda, temperature, top_k,
                                           partitionable):
    rng = np.random.default_rng(3)
    lg = torch.from_numpy(rng.standard_normal((8, 50304)).astype(
        np.float32) * 3).to(cuda)
    seeds = torch.tensor([0, 1, 7, 977, 2**31 - 1, 5, 5, 12],
                         dtype=torch.int32, device=cuda)
    pos = torch.tensor([0, 0, 3, 63, 1023, 1, 2, 0], dtype=torch.int32,
                       device=cuda)
    got, want = _both(lambda: tpd.fused_sample(
        lg, seeds, pos, temperature=temperature, top_k=top_k,
        vocab_size=50257, partitionable=partitionable))
    assert got.dtype == torch.int32
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wrappers_count_launches(cuda):
    before = tpd.fused_sample.launches
    lg = torch.zeros(2, 256, device=cuda)
    tpd.fused_sample(lg, [1, 2], [0, 0])
    with force_impl("torch"):
        tpd.fused_sample(lg, [1, 2], [0, 0])
    assert tpd.fused_sample.launches == before + 1


# ---- the training slice's kernels ---------------------------------------

#: (rtol, atol) per dtype for |got - want| <= rtol * |want| + atol *
#: rms(want): f32 sums in another order; half one rounding of the output
#: (bf16 2^-7, fp16 2^-10 relative) on top of that
_TOLS = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2.0 ** -7, 3e-2),
         torch.float16: (2.0 ** -10, 1e-2)}


def _close(got, want, dtype):
    rtol, atol = _TOLS[dtype]
    rms = want.float().pow(2).mean().sqrt().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol * rms + 1e-30)


@pytest.mark.parametrize("rms", [False, True], ids=["ln", "rms"])
@pytest.mark.parametrize("shape", [(64, 768), (37, 200)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_layer_norm_bwd_kernel_matches_plain(cuda, dtype, shape, rms):
    from apex1_tpu_torch.ops.layer_norm import (layer_norm_bwd,
                                                layer_norm_fwd)
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(7)
    R, H = shape
    x = torch.from_numpy(rng.standard_normal(shape) * 2 + 0.5).to(cuda, dt)
    dy = torch.from_numpy(rng.standard_normal(shape)).to(cuda, dt)
    # under amp the compute params, norms included, are half
    g = torch.from_numpy(1 + 0.1 * rng.standard_normal(H)).to(cuda, dt)
    b = None if rms else torch.zeros(H, device=cuda, dtype=dt)
    _, mean, rstd = layer_norm_fwd(x, g, b, 1e-5, rms)
    (dx, dg, db), (wdx, wdg, wdb) = _both(
        lambda: layer_norm_bwd(dy, x, g, mean, rstd, rms, not rms))
    assert dx.dtype == dt and dg.dtype == dt
    _close(dx, wdx, dt)
    _close(dg, wdg, dt)
    if not rms:
        _close(db, wdb, dt)
    # the same bits on every run: no atomics in the dγ/dβ reduction
    dx2, dg2, _ = layer_norm_bwd(dy, x, g, mean, rstd, rms, not rms)
    assert torch.equal(dg, dg2) and torch.equal(dx, dx2)


_SOFTMAX_MASKS = {"causal": None, "b1qk": lambda sq, sk: (2, 1, sq, sk),
                  "k": lambda sq, sk: (1, 1, 1, sk),
                  "bh": lambda sq, sk: (2, 3, 1, 1)}


@pytest.mark.parametrize("mask_kind", list(_SOFTMAX_MASKS))
@pytest.mark.parametrize("sq,sk", [(37, 53), (5, 1100)],
                         ids=["registers", "streamed"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_softmax_kernels_match_plain(cuda, dtype, sq, sk, mask_kind):
    """Rows of up to 1024 columns stay in registers; longer ones are
    streamed."""
    from apex1_tpu_torch.ops.softmax import softmax_bwd, softmax_fwd
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((2, 3, sq, sk)) * 3).to(cuda,
                                                                    dt)
    dy = torch.from_numpy(rng.standard_normal((2, 3, sq, sk))).to(cuda, dt)
    mask_shape = (_SOFTMAX_MASKS[mask_kind]
                  and _SOFTMAX_MASKS[mask_kind](sq, sk))
    m = None
    if mask_shape is not None:
        m = torch.from_numpy(np.where(rng.random(mask_shape) < 0.3, -1e30,
                                      0.0)).to(cuda, torch.float32)
    causal = mask_shape is None
    y, wy = _both(lambda: softmax_fwd(x, m, 0.125, causal))
    assert y.dtype == dt
    _close(y, wy, dt)
    dx, wdx = _both(lambda: softmax_bwd(wy, dy, 0.125))
    _close(dx, wdx, dt)


@pytest.mark.parametrize("smoothing,padding_idx", [(0.0, None), (0.1, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xent_kernels_match_plain(cuda, dtype, smoothing, padding_idx):
    from apex1_tpu_torch.ops.xentropy import xent_bwd, xent_fwd
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(9)
    full = torch.from_numpy(rng.standard_normal((3, 18, 300)) * 4).to(cuda,
                                                                     dt)
    x = full[:, :-1]            # the strided slice the GPT-2 loss reads
    t = torch.from_numpy(rng.integers(0, 290, (3 * 17,))).to(cuda)
    t[::7] = 3
    (loss, lse), (wloss, wlse) = _both(
        lambda: xent_fwd(x, t, smoothing, padding_idx, 290))
    _close(loss, wloss, torch.float32)
    _close(lse, wlse, torch.float32)
    dloss = torch.from_numpy(rng.standard_normal(3 * 17)).float().to(cuda)
    dx, wdx = _both(lambda: xent_bwd(x, t, wlse, dloss, smoothing,
                                     padding_idx, 290))
    assert dx.dtype == dt and dx.shape == (51, 300)
    _close(dx, wdx, dt)
    assert not dx[:, 290:].any()


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_layer_norm_kernel_takes_half_gamma(cuda, dtype):
    """Under amp the norms' γ/β are half like x (the training path)."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.standard_normal((64, 768)) * 2).to(cuda, dt)
    g = torch.from_numpy(1 + 0.1 * rng.standard_normal(768)).to(cuda, dt)
    b = torch.from_numpy(0.1 * rng.standard_normal(768)).to(cuda, dt)
    got, want = _both(lambda: layer_norm(x, g, b))
    assert got.dtype == dt
    _close(got, want, dt)
