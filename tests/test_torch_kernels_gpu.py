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
on the card).
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
