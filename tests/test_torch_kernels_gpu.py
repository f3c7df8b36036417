"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one; the
file imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_kernels_gpu.py

Tolerances: layer norm f32 1e-5 and bf16 1e-2 (one bf16 rounding); the
norm forward at its paths' H edges (1 to 4104, a misaligned x) as the
training kernels below, half γ/β handed to the kernel as they are (no
cast launch).
Paged attention (an online softmax across pages, split over them and
merged, against one softmax over the gathered lane), per element,
|got - want| <= rtol * |want| + atol * rms(want): f32 rtol 1e-5, atol
1e-4; bf16 rtol 2^-7 (one bf16 ulp), atol 3e-2, fp16 2^-10 and 1e-2 (the
plain version rounds the probabilities to q's type, the kernel's tensor
cores its unnormalized ones); the same bits on a second launch.
Sampled token ids exactly (the kernel's gumbel noise equals torch.log's
on the card), at the vocab split's edges (1, 8 and 40 rows; 1, 3, 4097
and 50304 columns, a masked tail inside the last split), a maximum at
two columns in different splits resolved to the lower, and the same ids
on a second launch and across CUDA-graph replays (the splits' ticket
counters reset). The training kernels (layer norm backward, softmax
forward and backward, cross-entropy forward and backward) per element
as paged attention, with fp16 at rtol 2^-10 (one fp16 ulp), atol 1e-2;
the layer norm backward also gives the same bits on a second run, and
the cross-entropy kernels too, in every dtype, with rows off 16 bytes
(an odd width, a logits[:, :-1] slice), K off the vector width and
K = 2, and dx's padding columns zero. The
flash kernels (forward, dq, dk/dv) the same way: the plain backward
rounds p and dS to the operand type where the kernels do; the forward
kernel rounds exp(s - m) against a running max where the plain forward
keeps fp32, about one rounding of the output; dq and dk/dv give the
same bits on a second run (no atomics). The linear-xent kernels
(forward modes 0-2, dx, dW) the same way, ragged T, V and H, a
col_offset shard with smoothing and padding_idx: the plain versions
round G to the operand type as the kernels do; mode 2 equals mode 1
bit for bit and dx, dW give the same bits on a second run; the bf16/fp16
forward (one wgmma product, 128 x 256 tiles) at its tiles' edges (T and
V off the tile, H of 64k ± 1 and 769, a num_classes cut inside a tile,
a shard with empty tiles or none valid, labels on tile edges) with the
same bits twice and one counted launch a call; the
chunked backward (bf16 and fp16 at every H on the wgmma kernels, fp32
past H = 768) in vocab chunks of 128 rows, dx and dW formed together
equal to each alone, also at the wgmma tiles' edges (T and vocab rows
off the tile, BERT's padded 776 and 1032 and its 769 on the plain-load
branch, H 4096 at a small T). RoPE exactly (both sides round the same fp32
operations once each). The fused GLU per element as the training
kernels (fp32 products either way, in another order). The
bias-dropout-add kernels: y and dx exactly (the same fp32 operations,
each rounded once), dbias at f32 tolerance with the same bits on a
second run; the flash kernels with dropout as without it; both with a
mask witness whose zero pattern must equal the plain version's mask
exactly. The flash kernels with an additive bias (broadcast over batch,
heads or both, NEG_INF entries, segments, offsets, dropout) as without
it, and dbias (an fp32 sum over the broadcast (b, h)) at f32 tolerance
with the same bits on a second launch, also at the bf16/fp16 wgmma
kernel's edges (ragged tiles, every broadcast form, sweeps of 1 to 16);
flash_attention launches dbias only for a bias that takes a gradient. The int8 matmul and the LoRA
delta (exact products, or fp32 ones, summed in fp32 in another order
than the plain version's) per element within 3u·|want| + 1e-5·Σ|a||b|
(u = 2^-24, Σ|a||b| the plain function on the absolute operands), the
same bits on a second launch; every shape the kernels take (ragged
tiles, K % 16 != 0, an unaligned x); each LoRA row equal to itself
computed alone (also where a block of the stream kernel takes several
rows and reuses B across those naming the same pages) and page-0 rows
exactly 0.0.
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


#: (rtol, atol) per dtype for |got - want| <= rtol * |want| + atol *
#: rms(want): f32 sums in another order; half one rounding of the output
#: (bf16 2^-7, fp16 2^-10 relative) on top of that
_TOLS = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2.0 ** -7, 3e-2),
         torch.float16: (2.0 ** -10, 1e-2)}


#: paged attention's head layouts: (Hq, Hkv, D); "odd_d" has 40- and
#: 80-byte rows (no 16-byte copies); "d256" the CUDA cores at D 256, one
#: key block in the ring for fp32 pages (two do not fit)
_PAGED_HEADS = {"mha": (12, 12, 64), "gqa3_d128": (12, 4, 128),
                "gqa4_d128": (32, 8, 128), "odd_d": (4, 2, 20),
                "d256": (4, 2, 256)}
#: paged attention's page geometries: (N, P, T). p16: two splits that
#: end on a page edge; p48: four that end inside pages (and the last on
#: an edge); n1: one row (its length T·P - S) over p48's pages; n64: 64
#: rows, one split (the kernel writes the output itself)
_PAGED_GEOM = {"p16": (4, 16, 6), "p48": (4, 48, 5), "n1": (1, 48, 5),
               "n64": (64, 16, 8)}


@pytest.mark.parametrize("geom", list(_PAGED_GEOM))
@pytest.mark.parametrize("heads", list(_PAGED_HEADS))
@pytest.mark.parametrize("s", [1, 5, 16, 64])
@pytest.mark.parametrize("page_dtype",
                         ["float32", "bfloat16", "float16", "int8"])
def test_paged_attend_kernel_matches_plain(cuda, page_dtype, s, heads,
                                           geom):
    """Every row length kind: 0 (the horizon inside the first split
    only), a page's end and start, T·P - S (the last position), the rest
    drawn; the page split's runs on and off page edges; decode (the CUDA
    cores) and chunk rows (the tensor cores for half q); the same bits on
    a second launch."""
    hq, hkv, D = _PAGED_HEADS[heads]
    N, P, T = _PAGED_GEOM[geom]
    rng = np.random.default_rng(6)
    n_pages = 1 + N * T
    raw = rng.standard_normal((2, n_pages, hkv, P, D))
    q = rng.standard_normal((N, hq, s, D))
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
    lens = np.concatenate([[T * P - s, 0, P - 1, P][:N],
                           rng.integers(0, T * P - s + 1, max(N - 4, 0))])
    lens = torch.from_numpy(lens.astype(np.int32)).to(cuda)
    k, v = kv[0].contiguous(), kv[1].contiguous()
    got, want = _both(lambda: tpd.paged_attend(q, k, v, bt, lens,
                                               total_len=T * P))
    assert got.dtype == q.dtype and got.shape == q.shape
    rms = want.float().pow(2).mean().sqrt().item()
    rtol, atol = _TOLS[q_dt]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol * rms)
    assert torch.equal(tpd.paged_attend(q, k, v, bt, lens,
                                        total_len=T * P), got)


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


#: fused_sample's split edges: the engine's prefill row, a decode batch
#: and `serve-lora`'s verify rows; one column, three, a last split of one
#: column past 4096, GPT-2's padded head
_SAMPLE_ROWS = [1, 8, 40]
_SAMPLE_V = [1, 3, 4097, 50304]


def _sample_inputs(R, V, cuda, seed):
    rng = np.random.default_rng(seed)
    lg = torch.from_numpy(rng.standard_normal((R, V)).astype(
        np.float32) * 3).to(cuda)
    seeds = torch.from_numpy(rng.integers(0, 2**31 - 1, R).astype(
        np.int32)).to(cuda)
    pos = torch.from_numpy(rng.integers(0, 1024, R).astype(np.int32)).to(
        cuda)
    return lg, seeds, pos


def _sample_split(R, V):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return tpd.sample_splits(R, V, sms)


@pytest.mark.parametrize("top_k", [None, 40])
@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.3])
@pytest.mark.parametrize("V", _SAMPLE_V)
@pytest.mark.parametrize("R", _SAMPLE_ROWS)
def test_fused_sample_split_edges(cuda, R, V, temperature, partitionable,
                                  top_k):
    """Ids equal to the plain version's with ``vocab_size`` masking a tail
    that starts inside the last split (the whole one-column split past
    4096; none at one column)."""
    splits, per = _sample_split(R, V)
    start = (splits - 1) * per
    vocab = max(1, start + (V - start) // 2)
    lg, seeds, pos = _sample_inputs(R, V, cuda, 7 * R + V)
    got, want = _both(lambda: tpd.fused_sample(
        lg, seeds, pos, temperature=temperature, top_k=top_k,
        vocab_size=vocab, partitionable=partitionable))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (got < vocab).all()


@pytest.mark.parametrize("V", [4097, 50304])
@pytest.mark.parametrize("R", _SAMPLE_ROWS)
def test_fused_sample_tie_across_splits(cuda, R, V):
    """A row's maximum at two columns in different splits (the first and
    the last) gives the lower column, as argmax does."""
    splits, per = _sample_split(R, V)
    assert splits >= 2
    lo, hi = per // 2, (splits - 1) * per
    lg, seeds, pos = _sample_inputs(R, V, cuda, R + V)
    lg[:, lo] = lg[:, hi] = 100.0
    got, want = _both(lambda: tpd.fused_sample(lg, seeds, pos))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (got == lo).all()


@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("R", _SAMPLE_ROWS)
def test_fused_sample_counters_reset(cuda, R, temperature):
    """The same ids on a second launch and on two replays of a captured
    CUDA graph: the last split of each row zeroes its ticket counter."""
    lg, seeds, pos = _sample_inputs(R, 50304, cuda, 11 + R)

    def run():
        return tpd.fused_sample(lg, seeds, pos, temperature=temperature,
                                vocab_size=50257)

    with force_impl("torch"):
        want = run()
    assert torch.equal(run(), want) and torch.equal(run(), want)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        run()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = run()
    for _ in range(2):
        out.fill_(-1)
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)
    assert (tpd._COUNTERS[lg.device] == 0).all()


def test_wrappers_count_launches(cuda):
    before = tpd.fused_sample.launches
    lg = torch.zeros(2, 256, device=cuda)
    tpd.fused_sample(lg, [1, 2], [0, 0])
    with force_impl("torch"):
        tpd.fused_sample(lg, [1, 2], [0, 0])
    assert tpd.fused_sample.launches == before + 1


# ---- the training slice's kernels ---------------------------------------

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


#: the cross-entropy kernels' shapes: (A, T, V, K, sliced): logits (A,
#: T, V), the first K columns real classes, read as logits[:, :-1] (in
#: place, two strides) where sliced. 122: rows of 244 or 488 bytes, so
#: most start off 16 bytes, fewer vectors than threads; 300: rows of 600
#: or 1200 bytes, half of them off 16 bytes; 4099: an odd width; 4104:
#: whole vectors, K on and off the vector width; NSP's K = 2 (8-byte
#: rows); the ResNet head's 1000; the GPT-2 head's width, K = 50257
_XENT_SHAPES = {"w122_k113": (3, 18, 122, 113, True),
                "w300_k290": (3, 18, 300, 290, True),
                "w4099_k4093": (2, 9, 4099, 4093, True),
                "w4104": (2, 7, 4104, 4104, True),
                "w4104_k4097": (2, 7, 4104, 4097, False),
                "nsp_k2": (1, 8, 2, 2, False),
                "resnet_1000": (1, 64, 1000, 1000, False),
                "gpt2_k50257": (1, 6, 50304, 50257, True)}


@pytest.mark.parametrize("smoothing,padding_idx", [(0.0, None), (0.1, 3)])
@pytest.mark.parametrize("shape", list(_XENT_SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_xent_kernels_match_plain(cuda, dtype, shape, smoothing,
                                  padding_idx):
    """Loss and lse at f32 tolerance, dx at its dtype's, each the same
    bits on a second launch; the padding columns [K, V) of dx exactly
    zero. The logits rise along each row (a ramp of 16 under draws of
    scale 4), so a thread's running max moves often."""
    from apex1_tpu_torch.ops.xentropy import xent_bwd, xent_fwd
    A, T, V, K, sliced = _XENT_SHAPES[shape]
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(9)
    full = (rng.standard_normal((A, T, V)) * 4
            + np.linspace(-8.0, 8.0, V))
    full = torch.from_numpy(full).to(cuda, dt)
    x = full[:, :-1] if sliced else full
    n = x.shape[0] * x.shape[1]
    t = torch.from_numpy(rng.integers(0, K, (n,))).to(cuda)
    t[::7] = 3 % K
    fwd = lambda: xent_fwd(x, t, smoothing, padding_idx, K)  # noqa: E731
    (loss, lse), (wloss, wlse) = _both(fwd)
    _close(loss, wloss, torch.float32)
    _close(lse, wlse, torch.float32)
    again = fwd()
    assert torch.equal(loss, again[0]) and torch.equal(lse, again[1])
    dloss = torch.from_numpy(rng.standard_normal(n)).float().to(cuda)
    bwd = lambda: xent_bwd(x, t, wlse, dloss, smoothing,  # noqa: E731
                           padding_idx, K)
    dx, wdx = _both(bwd)
    assert dx.dtype == dt and dx.shape == (n, V)
    _close(dx, wdx, dt)
    assert torch.equal(dx, bwd())
    assert not dx[:, K:].any()


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


#: the norm forward's H edges: the register path from one chunk a lane
#: to 16 (bf16/fp16 H = 4096, fp32 2048), its two-pass path past that
#: (4104; fp32 4096 too), and value by value where H is not a multiple
#: of a 16-byte chunk (1, 7, 767, 769)
_NORM_H = [1, 7, 767, 768, 769, 2048, 4096, 4104]


def _norm_inputs(rows, h, dt, cuda, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((rows, h)) * 2 + 0.5).to(
        cuda, dt)
    g = torch.from_numpy(1 + 0.1 * rng.standard_normal(h)).float().to(cuda)
    b = torch.from_numpy(0.1 * rng.standard_normal(h)).float().to(cuda)
    return x, g, b


def _norm_close(got, want, dt):
    """y at the dtype's tolerance, mean and rstd at fp32's."""
    _close(got[0], want[0], dt)
    for g, w in zip(got[1:], want[1:]):
        _close(g, w, torch.float32)


@pytest.mark.parametrize("rms", [False, True], ids=["ln", "rms"])
@pytest.mark.parametrize("h", _NORM_H)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_layer_norm_fwd_row_edges(cuda, dtype, h, rms):
    """y, mean and rstd against the plain version at every H edge of
    the kernel's paths; the same bits on a second launch."""
    from apex1_tpu_torch.ops.layer_norm import layer_norm_fwd
    dt = getattr(torch, dtype)
    x, g, b = _norm_inputs(37, h, dt, cuda, 15)
    beta = None if rms else b
    got, want = _both(lambda: layer_norm_fwd(x, g, beta, 1e-5, rms))
    assert got[0].dtype == dt and got[0].shape == x.shape
    _norm_close(got, want, dt)
    again = layer_norm_fwd(x, g, beta, 1e-5, rms)
    assert all(torch.equal(a, c) for a, c in zip(again, got))


@pytest.mark.parametrize("h", [768, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_fwd_misaligned_x(cuda, dtype, h):
    """x one element past a 16-byte boundary (a contiguous view into a
    larger buffer): the value-by-value path, the same numbers."""
    from apex1_tpu_torch.ops.layer_norm import layer_norm_fwd
    dt = getattr(torch, dtype)
    x, g, b = _norm_inputs(9, h, dt, cuda, 16)
    buf = torch.empty(x.numel() + 1, dtype=dt, device=cuda)
    xs = buf[1:].view(x.shape)
    xs.copy_(x)
    assert xs.is_contiguous() and xs.data_ptr() % 16 != 0
    got = layer_norm_fwd(xs, g, b, 1e-5, False)
    want = layer_norm_fwd(x, g, b, 1e-5, False)
    with force_impl("torch"):
        plain = layer_norm_fwd(x, g, b, 1e-5, False)
    _norm_close(got, plain, dt)
    _norm_close(want, plain, dt)


@pytest.mark.parametrize("rms", [False, True], ids=["ln", "rms"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_layer_norm_fwd_reads_half_gamma_directly(cuda, dtype, rms,
                                                  monkeypatch):
    """Half γ/β (the amp compute params) go to the kernel as they are:
    the launch gets their own pointers and dtype code, so no cast runs
    before it; one counted launch; y as the plain version's."""
    from apex1_tpu_torch.ops import _build
    from apex1_tpu_torch.ops._common import DTYPE_CODES
    from apex1_tpu_torch.ops.layer_norm import layer_norm_fwd
    dt = getattr(torch, dtype)
    x, g, b = _norm_inputs(64, 768, dt, cuda, 17)
    g, b = g.to(dt), b.to(dt)
    beta = None if rms else b
    calls = []
    launch = _build.launch

    def spy(name, *args):
        calls.append((name, args))
        launch(name, *args)

    monkeypatch.setattr(_build, "launch", spy)
    before = layer_norm_fwd.launches
    got = layer_norm_fwd(x, g, beta, 1e-5, rms)
    assert layer_norm_fwd.launches == before + 1
    assert [c[0] for c in calls] == ["apex1_layer_norm_fwd"]
    args = calls[0][1]
    assert args[1] == g.data_ptr()
    assert args[2] == (None if rms else b.data_ptr())
    assert args[-2] == DTYPE_CODES[dt]
    with force_impl("torch"):
        want = layer_norm_fwd(x, g, beta, 1e-5, rms)
    _norm_close(got, want, dt)


#: the norm backward's H edges: its register path from one chunk a lane
#: to 16 (bf16/fp16 H = 4096, fp32 2048), partials in registers (to H
#: 768-2048) or shared memory past them, the two-pass path past 16
#: chunks (4104 to 8192, beyond the 6016 the first kernel took) and
#: value by value where H is not a multiple of a 16-byte chunk
_NORM_BWD_H = [1, 7, 767, 768, 769, 2048, 4096, 4104, 6016, 6024, 8192]


def _norm_bwd_case(rows, h, dt, gdt, cuda, seed, rms, dy_dt=None):
    """x, dy, γ and the saved statistics of a norm backward case."""
    from apex1_tpu_torch.ops.layer_norm import layer_norm_fwd
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((rows, h)) * 2 + 0.5).to(
        cuda, dt)
    dy = torch.from_numpy(rng.standard_normal((rows, h))).to(
        cuda, dy_dt or dt)
    g = torch.from_numpy(1 + 0.1 * rng.standard_normal(h)).to(cuda, gdt)
    b = None if rms else torch.from_numpy(
        0.1 * rng.standard_normal(h)).to(cuda, gdt)
    _, mean, rstd = layer_norm_fwd(x, g, b, 1e-5, rms)
    return x, dy, g, mean, rstd


def _norm_bwd_check(x, dy, g, mean, rms, rstd, gtol=None):
    """dx, dγ (and dβ) against the plain version, dx at x's tolerance
    and dγ/dβ at ``gtol`` (γ's by default), in their dtypes; the same
    bits on a second launch (no atomics)."""
    from apex1_tpu_torch.ops.layer_norm import layer_norm_bwd

    def run():
        return layer_norm_bwd(dy, x, g, mean, rstd, rms, not rms)

    got, want = _both(run)
    assert got[0].dtype == x.dtype and got[0].shape == x.shape
    assert got[1].dtype == g.dtype and (rms or got[2].dtype == g.dtype)
    assert (got[2] is None) == rms
    _close(got[0], want[0], x.dtype)
    for a, w in zip(got[1:], want[1:]):
        if w is not None:
            _close(a, w, gtol or g.dtype)
    again = run()
    assert all(a is None or torch.equal(a, c) for a, c in zip(again, got))


@pytest.mark.parametrize("rms", [False, True], ids=["ln", "rms"])
@pytest.mark.parametrize("h", _NORM_BWD_H)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_layer_norm_bwd_row_edges(cuda, dtype, h, rms):
    """dx, dγ, dβ at every H edge of the kernel's paths, 37 rows (a
    ragged run for the rows pass), half γ under half x."""
    dt = getattr(torch, dtype)
    x, dy, g, mean, rstd = _norm_bwd_case(37, h, dt, dt, cuda, h, rms)
    _norm_bwd_check(x, dy, g, mean, rms, rstd)


@pytest.mark.parametrize("dy_dtype", ["same", "float32"])
@pytest.mark.parametrize("rms", [False, True], ids=["ln", "rms"])
@pytest.mark.parametrize("gdtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_layer_norm_bwd_gamma_and_dy_dtypes(cuda, dtype, gdtype, rms,
                                            dy_dtype):
    """γ in fp32, in x's half type (read as it is) or in another one
    (widened to fp32 first); dy in x's dtype or in fp32 (taken in x's
    dtype, so dγ/dβ hold to the coarser of x's and γ's tolerance)."""
    dt, gdt = getattr(torch, dtype), getattr(torch, gdtype)
    dy_dt = dt if dy_dtype == "same" else torch.float32
    x, dy, g, mean, rstd = _norm_bwd_case(64, 768, dt, gdt, cuda, 21, rms,
                                          dy_dt)
    coarse = max((dt, gdt), key=lambda d: _TOLS[d][1])
    _norm_bwd_check(x, dy, g, mean, rms, rstd,
                    gtol=coarse if dy_dt != dt else gdt)


@pytest.mark.parametrize("rms", [False, True], ids=["ln", "rms"])
@pytest.mark.parametrize("h", [768, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_layer_norm_bwd_misaligned_x(cuda, dtype, h, rms):
    """x one element past a 16-byte boundary: the value-by-value path,
    the numbers of the aligned launch."""
    dt = getattr(torch, dtype)
    x, dy, g, mean, rstd = _norm_bwd_case(9, h, dt, dt, cuda, 22, rms)
    buf = torch.empty(x.numel() + 1, dtype=dt, device=cuda)
    xs = buf[1:].view(x.shape)
    xs.copy_(x)
    assert xs.is_contiguous() and xs.data_ptr() % 16 != 0
    _norm_bwd_check(xs, dy, g, mean, rms, rstd)


@pytest.mark.parametrize("rms", [False, True], ids=["ln", "rms"])
@pytest.mark.parametrize("h", [768, 4096])
@pytest.mark.parametrize("rows", [1, 37, 4097])
def test_layer_norm_bwd_ragged_rows(cuda, rows, h, rms):
    """Row counts that leave a warp's run of rows ragged (one row, a
    few, one past a power of two), bf16 with half γ."""
    dt = torch.bfloat16
    x, dy, g, mean, rstd = _norm_bwd_case(rows, h, dt, dt, cuda, rows,
                                          rms)
    _norm_bwd_check(x, dy, g, mean, rms, rstd)


#: the softmax forward's Sk edges: fp32 from one chunk a lane to 16
#: (2048), streamed off a 16-byte chunk (1, 3, 1023, 1025) and past 16
#: chunks a lane (2052, a chunk multiple); bf16 at 16 chunks a lane
#: (4096) and past it
_SOFTMAX_SK = [("float32", 1), ("float32", 3), ("float32", 4),
               ("float32", 1023), ("float32", 1024), ("float32", 1025),
               ("float32", 2048), ("float32", 2052), ("bfloat16", 4096),
               ("bfloat16", 4104)]


def _softmax_check(x, m, causal, dt):
    """y against the plain version; the same bits on a second launch."""
    from apex1_tpu_torch.ops.softmax import softmax_fwd
    y, want = _both(lambda: softmax_fwd(x, m, 0.125, causal))
    assert y.dtype == dt and y.shape == x.shape
    _close(y, want, dt)
    assert torch.equal(softmax_fwd(x, m, 0.125, causal), y)


@pytest.mark.parametrize("mask_kind", [k for k in _SOFTMAX_MASKS
                                       if k != "causal"])
@pytest.mark.parametrize("dtype,sk", _SOFTMAX_SK)
def test_softmax_fwd_sk_edges(cuda, dtype, sk, mask_kind):
    """Each mask broadcast at every Sk edge of the forward's paths."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(sk)
    sq = 5
    x = torch.from_numpy(rng.standard_normal((2, 3, sq, sk)) * 3).to(cuda,
                                                                    dt)
    m = torch.from_numpy(np.where(
        rng.random(_SOFTMAX_MASKS[mask_kind](sq, sk)) < 0.3, -1e30,
        0.0)).to(cuda, torch.float32)
    _softmax_check(x, m, False, dt)


@pytest.mark.parametrize("rows", ["sq<sk", "sq>sk"])
@pytest.mark.parametrize("dtype,sk", _SOFTMAX_SK)
def test_softmax_fwd_causal_edges(cuda, dtype, sk, rows):
    """Causal at every Sk edge: Sq < Sk (every row ends early), and Sq >
    Sk (rows end at every column, inside chunks and on their edges, and
    the rows past Sk are whole)."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(sk + 1)
    sq = sk // 3 + 1 if rows == "sq<sk" else sk + 3
    x = torch.from_numpy(rng.standard_normal((1, 2, sq, sk)) * 3).to(cuda,
                                                                    dt)
    _softmax_check(x, None, True, dt)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "mask"])
def test_softmax_fwd_misaligned_x(cuda, causal):
    """x one element past a 16-byte boundary: the streamed path, the
    numbers of the aligned launch."""
    rng = np.random.default_rng(30)
    x = torch.from_numpy(rng.standard_normal((2, 3, 40, 1024)) * 3).to(
        cuda, torch.float32)
    buf = torch.empty(x.numel() + 1, device=cuda)
    xs = buf[1:].view(x.shape)
    xs.copy_(x)
    assert xs.is_contiguous() and xs.data_ptr() % 16 != 0
    m = None if causal else torch.from_numpy(np.where(
        rng.random((1, 1, 1, 1024)) < 0.3, -1e30, 0.0)).to(cuda,
                                                          torch.float32)
    _softmax_check(xs, m, causal, torch.float32)


# ---- the flash slice's kernels --------------------------------------------

#: name -> (B, Hq, Hkv, Sq, Sk, D, causal, segments, q_off, k_off, dlse)
_FLASH = {
    "causal": (2, 4, 4, 128, 128, 64, True, None, 0, 0, False),
    "gqa": (2, 12, 4, 96, 96, 64, True, None, 0, 0, False),
    "segments": (2, 4, 4, 160, 160, 64, True, "array", 0, 0, False),
    "odd": (1, 4, 4, 77, 200, 64, False, None, 0, 0, False),
    "offsets_lse": (1, 4, 2, 100, 130, 64, True, None, 7, 40, True),
    "d32_pair": (2, 2, 1, 70, 90, 32, False, "pair", 0, 0, True),
    "d128": (1, 2, 2, 96, 96, 128, True, None, 0, 0, False),
}


def _flash_inputs(name, dt, cuda, cases=None):
    B, Hq, Hkv, Sq, Sk, D, causal, seg, q_off, k_off, dl = (
        (cases or _FLASH)[name][:11])
    rng = np.random.default_rng(12)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(cuda, dt)

    q, k, v, do = t(B, Hq, Sq, D), t(B, Hkv, Sk, D), t(B, Hkv, Sk, D), \
        t(B, Hq, Sq, D)
    dlse = (torch.from_numpy(rng.standard_normal((B, Hq, Sq))).float()
            .to(cuda) if dl else None)
    qseg = kseg = None
    if seg is not None:
        # documents in a row with a padded tail: -1 on q, -2 on k for the
        # pair (those q rows see no key)
        qseg = np.sort(rng.integers(0, 4, (B, Sq)), axis=1)
        qseg[:, -9:] = -1
        kseg = qseg if seg == "array" else np.sort(
            rng.integers(0, 4, (B, Sk)), axis=1)
        if seg == "pair":
            kseg[:, -5:] = -2
        qseg = torch.from_numpy(qseg).to(cuda, torch.int32)
        kseg = torch.from_numpy(kseg).to(cuda, torch.int32)
    args = (1.0 / np.sqrt(D), causal, q_off, k_off)
    return q, k, v, do, dlse, qseg, kseg, args


@pytest.mark.parametrize("name", list(_FLASH))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_flash_kernels_match_plain(cuda, dtype, name):
    """Forward, dq and dk/dv each against its plain version on the same
    inputs (the backward from the plain forward's out and lse); dq and
    dk/dv give the same bits on a second run (no atomics)."""
    from apex1_tpu_torch.ops.attention import flash_dkv, flash_dq, flash_fwd
    dt = getattr(torch, dtype)
    q, k, v, do, dlse, qseg, kseg, args = _flash_inputs(name, dt, cuda)
    (out, lse), (wout, wlse) = _both(
        lambda: flash_fwd(q, k, v, qseg, kseg, *args))
    assert out.dtype == dt and lse.dtype == torch.float32
    _close(out, wout, dt)
    empty = wlse <= -1e29
    assert torch.equal(lse <= -1e29, empty)
    _close(torch.where(empty, 0.0, lse), torch.where(empty, 0.0, wlse),
           torch.float32)
    delta = (do.float() * wout.float()).sum(-1)
    bwd = (q, k, v, do, wlse, delta, dlse, qseg, kseg, *args)
    dq, wdq = _both(lambda: flash_dq(*bwd))
    assert dq.dtype == dt
    _close(dq, wdq, dt)
    (dk, dv), (wdk, wdv) = _both(lambda: flash_dkv(*bwd))
    assert dk.dtype == dt and dv.dtype == dt
    _close(dk, wdk, dt)
    _close(dv, wdv, dt)
    assert torch.equal(flash_dq(*bwd), dq)
    dk2, dv2 = flash_dkv(*bwd)
    assert torch.equal(dk2, dk) and torch.equal(dv2, dv)


def test_flash_attention_autograd_launches_the_kernels(cuda):
    from apex1_tpu_torch.ops import KERNEL_WRAPPERS
    from apex1_tpu_torch.ops.attention import flash_attention
    names = ("flash_fwd", "flash_dq", "flash_dkv")
    before = {n: KERNEL_WRAPPERS[n].launches for n in names}
    q = torch.randn(2, 4, 64, 64, device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    flash_attention(q, q, q, causal=True).float().sum().backward()
    assert {n: KERNEL_WRAPPERS[n].launches - before[n] for n in names} == \
        {n: 1 for n in names}
    with pytest.raises(ValueError, match="head dim"):
        z = torch.zeros(1, 1, 8, 160, device=cuda)
        flash_attention(z, z, z)


# ---- the linear-xent slice's kernels --------------------------------------

#: name -> (T, V_l, H, K, col_offset, smoothing, padding_idx)
_LXENT = {
    "ragged": (200, 333, 96, 320, 0, 0.0, None),
    "shard_smooth_pad": (77, 130, 768, 317, 200, 0.1, 3),
    "h40_scalar_loads": (64, 256, 40, 256, 0, 0.0, None),
    "wide_ragged": (200, 333, 1000, 320, 0, 0.0, None),
    "wide_shard_smooth_pad": (77, 530, 1032, 900, 200, 0.1, 3),
    # the bf16/fp16 backward's wgmma tiles (128 rows x 128 or 256 columns,
    # K steps of 64) at their edges: T and vocab rows off the tile, the
    # last chunk ragged (333 = 128 + 128 + 77), BERT's padded MLM widths
    # and its H + 1 on the plain-load branch, a Llama-wide head at a small
    # T, two whole chunks, and a shard with smoothing and padding_idx
    "wg_t130_v333": (130, 333, 96, 320, 0, 0.0, None),
    "wg_t257_h256": (257, 333, 256, 333, 0, 0.0, None),
    "wg_h776": (200, 300, 776, 300, 0, 0.0, None),
    "wg_h1032": (130, 300, 1032, 290, 0, 0.0, None),
    "wg_h769_plain_loads": (130, 333, 769, 333, 0, 0.0, None),
    "wg_h4096_small_t": (64, 300, 4096, 300, 0, 0.0, None),
    "wg_two_whole_chunks": (129, 256, 64, 256, 0, 0.0, None),
    "wg_shard_h776_smooth_pad": (257, 333, 776, 900, 300, 0.1, 3),
}


def _lxent_inputs(name, dt, cuda):
    T, V, H, K, off, eps, pad = _LXENT[name]
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((T, H)) * 0.5).to(cuda, dt)
    # past H = 768, W shrinks so that the logits keep the H = 96 case's
    # spread (fp32 logits of a wider spread carry more rounding into G)
    w = torch.from_numpy(rng.standard_normal((V, H)) * 0.5
                         * ((96 / H) ** 0.5 if H > 768 else 1.0)).to(cuda, dt)
    # half the labels inside the shard's columns, the rest anywhere
    labels = rng.integers(0, K, T)
    labels[::2] = rng.integers(off, min(off + V, K), T)[::2]
    labels[::9] = 3
    t = torch.from_numpy(labels).to(cuda, torch.int32)
    dloss = torch.from_numpy(rng.standard_normal(T)).float().to(cuda)
    kw = dict(num_classes=K, col_offset=off, smoothing=eps,
              padding_idx=pad)
    return x, w, t, dloss, kw


@pytest.mark.parametrize("name", list(_LXENT))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_linear_xent_kernels_match_plain(cuda, dtype, name, monkeypatch):
    """The forward (modes 0 and 1; mode 2 bit for bit mode 1), dx and dW
    each against its plain version on the same inputs (the backward
    from the plain forward's lse); dx and dW give the same bits on a
    second run (no atomics). The backward runs in vocab chunks of 128
    rows (bf16 and fp16 at every H, fp32 past H = 768); dx and dW
    formed together (one G a chunk) equal each formed alone."""
    from apex1_tpu_torch.ops import linear_xent
    from apex1_tpu_torch.ops.linear_xent import (lxent_dw, lxent_dx,
                                                 lxent_fwd, lxent_grads)
    monkeypatch.setattr(linear_xent, "WIDE_G_BYTES", 1)  # 128-row chunks
    monkeypatch.setattr(linear_xent, "F32_CHUNK", 128)
    dt = getattr(torch, dtype)
    x, w, t, dloss, kw = _lxent_inputs(name, dt, cuda)
    (loss, lse), (wloss, wlse) = _both(lambda: lxent_fwd(x, w, t, **kw))
    _close(loss, wloss, torch.float32)
    _close(lse, wlse, torch.float32)
    stat_kw = dict(num_classes=kw["num_classes"],
                   col_offset=kw["col_offset"])
    stats, wstats = _both(lambda: lxent_fwd(x, w, t, mode=1, **stat_kw))
    for g, wv in zip(stats, wstats):
        _close(g, wv, torch.float32)
    packed = lxent_fwd(x, w, t, mode=2, **stat_kw)
    assert torch.equal(packed, torch.stack(stats, dim=1))
    dx, wdx = _both(lambda: lxent_dx(x, w, t, wlse, dloss, **kw))
    dw, wdw = _both(lambda: lxent_dw(x, w, t, wlse, dloss, **kw))
    assert dx.dtype == dt and dx.shape == x.shape
    assert dw.dtype == dt and dw.shape == w.shape
    _close(dx, wdx, dt)
    _close(dw, wdw, dt)
    assert torch.equal(lxent_dx(x, w, t, wlse, dloss, **kw), dx)
    assert torch.equal(lxent_dw(x, w, t, wlse, dloss, **kw), dw)
    both = lxent_grads(x, w, t, wlse, dloss, **kw)
    assert torch.equal(both[0], dx) and torch.equal(both[1], dw)


#: the bf16/fp16 forward's tiles at their edges: name -> (T, V_l, H, K,
#: col_offset, smoothing, padding_idx). T and V_l off the 128/256 tiles;
#: H of 64k ± 1 and BERT's 769 (plain loads); a shard whose num_classes
#: cut falls inside a tile and whose last tiles hold no valid column; a
#: shard past num_classes (no valid column at all: stats only)
_LXENT_FWD = {
    "t130_v333": (130, 333, 96, 333, 0, 0.0, None),
    "t257_v513_h63": (257, 513, 63, 513, 0, 0.0, None),
    "h65_smooth_pad": (129, 300, 65, 300, 0, 0.1, 3),
    "h127": (200, 640, 127, 640, 0, 0.0, None),
    "h129_pad": (64, 257, 129, 250, 0, 0.0, 3),
    "h769_plain_loads": (200, 600, 769, 600, 0, 0.1, None),
    "h4096": (70, 300, 4096, 300, 0, 0.0, None),
    "k_cut_in_tile": (131, 700, 128, 450, 0, 0.1, 5),
    "shard_cut_and_empty_tiles": (131, 700, 128, 700, 300, 0.0, None),
    "shard_past_k": (64, 200, 96, 400, 500, 0.0, None),
}
#: label columns around the tiles' edges (global = col_offset + these)
_TILE_EDGES = (0, 1, 63, 64, 127, 128, 129, 255, 256, 257, 383, 384, 399,
               400, 511, 512)


@pytest.mark.parametrize("name", list(_LXENT_FWD))
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_linear_xent_fwd_wgmma_tile_edges(cuda, dtype, name):
    """The bf16/fp16 forward (128 x 256 tiles, K steps of 64) at its
    tiles' edges: loss and lse (mode 0) and the four statistics (mode 1)
    against the plain versions at fp32's tolerance, labels on the tiles'
    edges; mode 2 equal to mode 1 bit for bit; the same bits on a second
    launch; one counted launch a call. A shard with no valid column
    gives m = -1e30, l = 0 and sumx = 0 exactly."""
    from apex1_tpu_torch.ops.linear_xent import lxent_fwd
    T, V, H, K, off, eps, pad = _LXENT_FWD[name]
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(18)
    x = torch.from_numpy(rng.standard_normal((T, H)) * 0.5).to(cuda, dt)
    w = torch.from_numpy(rng.standard_normal((V, H)) * 0.5
                         * min(1.0, (96 / H) ** 0.5)).to(cuda, dt)
    labels = rng.integers(0, K, T)
    labels[::2] = off + np.resize(_TILE_EDGES, labels[::2].shape)
    if pad is not None:
        labels[::9] = pad
    t = torch.from_numpy(labels).to(cuda, torch.int32)
    skw = dict(num_classes=K, col_offset=off)
    before = lxent_fwd.launches
    stats, wstats = _both(lambda: lxent_fwd(x, w, t, mode=1, **skw))
    assert lxent_fwd.launches == before + 1
    packed = lxent_fwd(x, w, t, mode=2, **skw)
    assert torch.equal(packed, torch.stack(stats, dim=1))
    again = lxent_fwd(x, w, t, mode=1, **skw)
    assert all(torch.equal(a, b) for a, b in zip(again, stats))
    if K <= off:
        assert (stats[0] == -1e30).all() and not stats[1].any()
        assert not stats[3].any()
        _close(stats[2], wstats[2], torch.float32)
        return
    for g, wv in zip(stats, wstats):
        _close(g, wv, torch.float32)
    if off:
        return
    fkw = dict(num_classes=K, smoothing=eps, padding_idx=pad)
    (loss, lse), (wloss, wlse) = _both(lambda: lxent_fwd(x, w, t, **fkw))
    _close(loss, wloss, torch.float32)
    _close(lse, wlse, torch.float32)
    if pad is not None:
        assert not loss[t == pad].any()
    again = lxent_fwd(x, w, t, **fkw)
    assert torch.equal(again[0], loss) and torch.equal(again[1], lse)


def test_chunked_logprob_kernels_match_plain(cuda):
    """`chunked_logprob` and its grads through the kernels against the
    plain versions, in f32: 517 vocab rows in chunks of 128, so the last
    chunk holds 5 rows (the kernels mask the rest); one forward, dx and
    dW launch a chunk."""
    from apex1_tpu_torch.ops import KERNEL_WRAPPERS
    from apex1_tpu_torch.ops.chunked_loss import chunked_logprob
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.standard_normal((2, 40, 96)) * 0.5).to(
        cuda, torch.float32)
    w = torch.from_numpy(rng.standard_normal((517, 96)) * 0.5).to(
        cuda, torch.float32)
    t = torch.from_numpy(rng.integers(0, 500, (2, 40))).to(cuda)
    g = torch.from_numpy(rng.standard_normal((2, 40))).float().to(cuda)

    def run():
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        lp = chunked_logprob(xr, wr, t, chunk_v=128, num_classes=500)
        return (lp, *torch.autograd.grad(lp, (xr, wr), g))

    names = ("lxent_fwd", "lxent_dx", "lxent_dw")
    before = {n: KERNEL_WRAPPERS[n].launches for n in names}
    got, want = _both(run)
    assert {n: KERNEL_WRAPPERS[n].launches - before[n] for n in names} == \
        {n: 5 for n in names}
    for a, b in zip(got, want):
        _close(a, b, torch.float32)
    assert not got[2][500:].any()


def test_linear_cross_entropy_autograd_launches_the_kernels(cuda):
    from apex1_tpu_torch.ops import KERNEL_WRAPPERS
    from apex1_tpu_torch.ops.linear_xent import linear_cross_entropy
    names = ("lxent_fwd", "lxent_dx", "lxent_dw")
    before = {n: KERNEL_WRAPPERS[n].launches for n in names}
    x = torch.randn(3, 50, 64, device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    w = torch.randn(300, 64, device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    t = torch.randint(0, 290, (3, 50), device=cuda)
    linear_cross_entropy(x, w, t, num_classes=290).sum().backward()
    assert {n: KERNEL_WRAPPERS[n].launches - before[n] for n in names} == \
        {n: 1 for n in names}
    # a head wider than 768 takes the wide path: one launch each too
    before = {n: KERNEL_WRAPPERS[n].launches for n in names}
    z = torch.randn(8, 800, device=cuda, requires_grad=True)
    wz = torch.randn(16, 800, device=cuda, requires_grad=True)
    linear_cross_entropy(z, wz, torch.zeros(8, dtype=torch.int64,
                                            device=cuda)).sum().backward()
    assert {n: KERNEL_WRAPPERS[n].launches - before[n] for n in names} == \
        {n: 1 for n in names}


# ---- the Llama slice's kernels ---------------------------------------------

#: name -> (x shape, per-row tables, interleaved)
_ROPE = {
    "q": ((2, 40, 4, 128), False, False),
    "per_row_interleaved": ((2, 40, 4, 128), True, True),
    "odd_half_scalar": ((3, 17, 2, 10), False, False),
    "decode_step": ((5, 1, 8, 128), True, False),
}


@pytest.mark.parametrize("name", list(_ROPE))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_rope_kernel_bitwise_plain(cuda, dtype, name):
    """The forward and the backward (the rotation by -θ, through
    autograd) equal the plain version bit for bit; one launch each way."""
    from apex1_tpu_torch.ops.rope import apply_rotary_pos_emb, rope_tables
    from apex1_tpu_torch.ops.rope import rotate
    shape, per_row, inter = _ROPE[name]
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(15)
    B, S, _, D = shape
    x = torch.from_numpy(rng.standard_normal(shape)).to(cuda, dt)
    dy = torch.from_numpy(rng.standard_normal(shape)).to(cuda, dt)
    pos = torch.from_numpy(rng.integers(0, 5000, B * S if per_row else S))
    cos, sin = rope_tables(pos.to(cuda), D, base=500000.0)
    if per_row:
        cos, sin = cos.reshape(B, S, -1), sin.reshape(B, S, -1)

    def run():
        xr = x.clone().requires_grad_()
        out = apply_rotary_pos_emb(xr, cos, sin, interleaved=inter)
        return (out, *torch.autograd.grad(out, xr, dy))

    before = rotate.launches
    got, want = _both(run)
    assert rotate.launches == before + 2
    for a, b in zip(got, want):
        assert a.dtype == dt
        assert torch.equal(a, b)


#: name -> (T, H, F, activation)
_GLU = {
    "swiglu": (256, 512, 384, "silu"),
    "geglu": (256, 512, 384, "gelu"),
    "ragged": (100, 200, 136, "silu"),
    "odd_scalar_loads": (37, 65, 131, "gelu"),
}


@pytest.mark.parametrize("name", list(_GLU))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_glu_kernel_matches_plain(cuda, dtype, name):
    """``glu_fwd`` against its plain version (fp32 products, the
    epilogue in fp32, one rounding); `fused_glu`'s grads are the plain
    recompute backward's on either side; one launch a forward."""
    from apex1_tpu_torch.ops.fused_dense import fused_glu, glu_fwd
    T, H, F, act = _GLU[name]
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(16)
    x = torch.from_numpy(rng.standard_normal((T, H))).to(cuda, dt)
    wg, wu = (torch.from_numpy(rng.standard_normal((H, F)) / np.sqrt(H))
              .to(cuda, dt) for _ in range(2))
    before = glu_fwd.launches
    got, want = _both(lambda: glu_fwd(x, wg, wu, act))
    assert glu_fwd.launches == before + 1
    assert got.dtype == dt and got.shape == (T, F)
    _close(got, want, dt)
    dy = torch.from_numpy(rng.standard_normal((T, F))).to(cuda, dt)

    def grads():
        ins = [t.clone().requires_grad_() for t in (x, wg, wu)]
        return torch.autograd.grad(fused_glu(*ins, activation=act), ins, dy)

    for a, b in zip(*_both(grads)):
        assert torch.equal(a, b)


#: the wgmma GLU's tile edges: name -> (T, H, F). T on both sides of
#: the 128-row tile, H of the 64-deep K step, F of the 128- and 64-column
#: tiles; odd H or F take the plain loads. "wide_*" have at least four
#: waves of 128 x 128 tiles (so they run them); "under_filled" would
#: leave the 132 SMs under-filled with them and runs 128 x 64
_GLU_EDGES = {
    "t127_h63_f127": (127, 63, 127),
    "t128_h64_f128": (128, 64, 128),
    "t129_h65_f129": (129, 65, 129),
    "t129_h64_f136": (129, 64, 136),
    "t255_h136_f120": (255, 136, 120),
    "wide_ragged_f": (2048, 128, 4200),
    "wide_ragged_t": (2047, 72, 4224),
    "under_filled": (512, 256, 2048),
}


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("name", list(_GLU_EDGES))
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_glu_wgmma_tile_edges(cuda, dtype, name, act):
    """The wgmma ``glu_fwd`` at its tiles' edges against the plain
    version (fp32 products and epilogue, one rounding), the tile the
    launch takes pinned; one launch a call."""
    from apex1_tpu_torch.ops.fused_dense import glu_fwd, glu_tile
    T, H, F = _GLU_EDGES[name]
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(T + H + F)
    x = torch.from_numpy(rng.standard_normal((T, H))).to(cuda, dt)
    wg, wu = (torch.from_numpy(rng.standard_normal((H, F)) / np.sqrt(H))
              .to(cuda, dt) for _ in range(2))
    assert glu_tile(T, F, dt) == (128, 128 if name.startswith("wide")
                                  else 64)
    before = glu_fwd.launches
    got, want = _both(lambda: glu_fwd(x, wg, wu, act))
    assert glu_fwd.launches == before + 1
    assert got.dtype == dt and got.shape == (T, F)
    _close(got, want, dt)
    assert torch.equal(glu_fwd(x, wg, wu, act), got)


# ---- the BERT slice's kernels: dropout ------------------------------------

#: name -> (rows, h, residual dtype or None for x's, bias)
_BDA = {
    "h768_bias": (333, 768, None, True),
    "h1024": (300, 1024, None, False),
    "h1000_scalar_loads": (129, 1000, None, True),
    "f32_residual": (64, 768, "float32", True),
}


@pytest.mark.parametrize("name", list(_BDA))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_bda_kernels_match_plain(cuda, dtype, name):
    """``bda_fwd`` and ``bda_bwd`` against their plain versions: y and
    dx bit for bit (the same fp32 operations, each rounded once); dbias
    (fp32 sums over rows in another order) at f32 tolerance, and the
    same bits on a second run (no atomics)."""
    from apex1_tpu_torch.ops.stochastic import bda_bwd, bda_fwd
    rows, h, rdt, with_bias = _BDA[name]
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(17)

    def t(shape, d=dt):
        return torch.from_numpy(rng.standard_normal(shape)).to(cuda, d)

    x, dy = t((rows, h)), t((rows, h))
    r = t((rows, h), dt if rdt is None else getattr(torch, rdt))
    b = t((h,), torch.float32) if with_bias else None
    before = (bda_fwd.launches, bda_bwd.launches)
    y, wy = _both(lambda: bda_fwd(x, r, b, 1234, 0.1))
    assert y.dtype == dt and torch.equal(y, wy)
    (dx, db), (wdx, wdb) = _both(lambda: bda_bwd(dy, 1234, 0.1, with_bias))
    assert dx.dtype == dt and torch.equal(dx, wdx)
    assert (bda_fwd.launches, bda_bwd.launches) == (before[0] + 1,
                                                    before[1] + 1)
    if with_bias:
        _close(db, wdb, torch.float32)
        assert torch.equal(bda_bwd(dy, 1234, 0.1, True)[1], db)
    else:
        assert db is None and wdb is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_bda_mask_witness(cuda, dtype):
    """x = 1, residual 0, no bias: y is 1/(1-p) where kept and 0 where
    dropped, so its zero pattern is the kernel's mask. It must equal
    the plain version's mask exactly, and keep about 1 - p (3 sigma)."""
    from apex1_tpu_torch.ops.stochastic import _row_keep, bda_fwd, inv_keep
    dt = getattr(torch, dtype)
    rows, h, p = 1000, 768, 0.1
    x = torch.ones(rows, h, device=cuda, dtype=dt)
    y = bda_fwd(x, torch.zeros_like(x), None, 99, p)
    keep = _row_keep(99, rows, h, p, cuda)
    assert torch.equal(y != 0, keep)
    assert torch.equal(y[keep].float(),
                       torch.full_like(y[keep].float(),
                                       float(torch.tensor(inv_keep(p))
                                             .to(dt))))
    rate = keep.float().mean().item()
    assert abs(rate - (1 - p)) < 3 * (p * (1 - p) / keep.numel()) ** 0.5


@pytest.mark.parametrize("name", ["causal", "gqa", "segments",
                                  "offsets_lse", "d128"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_flash_dropout_kernels_match_plain(cuda, dtype, name):
    """The flash kernels with dropout 0.1 against their plain versions
    (the same hash mask); dq and dk/dv give the same bits twice; p = 0.1
    changes out, and lse stays the undropped one (f32 tolerance: the
    kernel without dropout is another compiled function)."""
    from apex1_tpu_torch.ops.attention import flash_dkv, flash_dq, flash_fwd
    dt = getattr(torch, dtype)
    q, k, v, do, dlse, qseg, kseg, args = _flash_inputs(name, dt, cuda)
    drop = (0.1, 4321)
    (out, lse), (wout, wlse) = _both(
        lambda: flash_fwd(q, k, v, qseg, kseg, *args, *drop))
    _close(out, wout, dt)
    empty = wlse <= -1e29
    _close(torch.where(empty, 0.0, lse), torch.where(empty, 0.0, wlse),
           torch.float32)
    out0, lse0 = flash_fwd(q, k, v, qseg, kseg, *args)
    _close(lse0, lse, torch.float32)
    assert not torch.equal(out0, out)
    delta = (do.float() * wout.float()).sum(-1)
    bwd = (q, k, v, do, wlse, delta, dlse, qseg, kseg, *args, *drop)
    dq, wdq = _both(lambda: flash_dq(*bwd))
    _close(dq, wdq, dt)
    (dk, dv), (wdk, wdv) = _both(lambda: flash_dkv(*bwd))
    _close(dk, wdk, dt)
    _close(dv, wdv, dt)
    assert torch.equal(flash_dq(*bwd), dq)
    dk2, dv2 = flash_dkv(*bwd)
    assert torch.equal(dk2, dk) and torch.equal(dv2, dv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_dropout_mask_witness(cuda, dtype):
    """Sk = D = 128 and v the identity: out[q, j] = keep·e/l·(1/(1-p)),
    so out's zero pattern is the kernel's mask at (q, j). It must equal
    the plain version's exactly (offsets and GQA on, the query head's
    stream in dk/dv's loop too: dv = Pᵀ·dO is zero exactly where a key
    was dropped for every query row of a one-row dO; and in dq's)."""
    from apex1_tpu_torch.ops.attention import (_keep, flash_dkv, flash_dq,
                                               flash_fwd)
    dt = getattr(torch, dtype)
    B, Hq, Hkv, S, D, p = 2, 4, 2, 128, 128, 0.1
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = (0.1 * torch.randn(B, Hq, S, D, generator=gen, device=cuda)).to(dt)
    k = (0.1 * torch.randn(B, Hkv, S, D, generator=gen, device=cuda)).to(dt)
    v = torch.eye(S, D, device=cuda, dtype=dt).expand(B, Hkv, S, D)
    v = v.contiguous()
    args = (None, None, 1.0 / D ** 0.5, False, 64, 192, p, 77)
    out, lse = flash_fwd(q, k, v, *args)
    with force_impl("torch"):
        wout, _ = flash_fwd(q, k, v, *args)
    keep = _keep(q, S, 64, 192, p, 77)
    assert torch.equal(out != 0, keep)
    assert torch.equal(wout != 0, keep)
    rate = keep.float().mean().item()
    assert abs(rate - (1 - p)) < 3 * (p * (1 - p) / keep.numel()) ** 0.5
    # dk/dv: dO one-hot on query row 5 of every head: dv[b, hk, key, :]
    # sums P_av[b, h, 5, key] over the group, zero where every head of
    # the group dropped that key
    do = torch.zeros_like(q)
    do[:, :, 5, :] = 1
    delta = (do.float() * out.float()).sum(-1)
    _, dv = flash_dkv(q, k, v, do, lse, delta, None, *args)
    g = Hq // Hkv
    kept_any = keep[:, :, 5, :].reshape(B, Hkv, g, S).any(dim=2)
    assert torch.equal(dv[..., 0] != 0, kept_any)
    # dq: k and v the identity, dO all ones and δ 0: dq[q, j] = dS[q, j]
    # = P·inv·scale where (q, j) was kept and exactly 0 where dropped
    eye = v
    _, lse_e = flash_fwd(q, eye, eye, *args)
    ones = torch.ones_like(q)
    zero = torch.zeros(B, Hq, S, device=cuda)
    dq = flash_dq(q, eye, eye, ones, lse_e, zero, None, *args)
    assert torch.equal(dq != 0, keep)


# ---- the T5 slice: flash's bias operand and dbias ------------------------

#: name -> (the `_FLASH` case, bias (Bb, Hb): "B"/"H" for the full
#: dimension, dropout p)
_FLASH_BIAS = {
    "causal_heads": ("causal", (1, "H"), 0.0),
    "gqa_full": ("gqa", ("B", "H"), 0.0),
    "odd_batch": ("odd", ("B", 1), 0.0),
    "segments_shared": ("segments", (1, 1), 0.0),
    "offsets_lse_heads": ("offsets_lse", (1, "H"), 0.0),
    "d128_heads": ("d128", (1, "H"), 0.0),
    "causal_heads_dropout": ("causal", (1, "H"), 0.1),
    "d32_pair_dropout": ("d32_pair", ("B", 1), 0.1),
}


def _bias_for(name, cuda):
    case, (bb, hb), p = _FLASH_BIAS[name]
    B, Hq, _, Sq, Sk = _FLASH[case][:5]
    rng = np.random.default_rng(21)
    shape = (B if bb == "B" else 1, Hq if hb == "H" else 1, Sq, Sk)
    bias = rng.standard_normal(shape).astype(np.float32)
    # an additive mask's entries: whole keys at NEG_INF, one at -10000
    bias[..., :, 3] = -1e30
    bias[..., :, 5] = -10000.0
    return case, torch.from_numpy(bias).to(cuda), p


@pytest.mark.parametrize("name", list(_FLASH_BIAS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_flash_bias_kernels_match_plain(cuda, dtype, name):
    """Forward, dq, dk/dv with a bias and dbias each against its plain
    version on the same inputs; dq, dk/dv and dbias give the same bits
    on a second launch."""
    from apex1_tpu_torch.ops.attention import (flash_dbias, flash_dkv,
                                               flash_dq, flash_fwd)
    dt = getattr(torch, dtype)
    case, bias, p = _bias_for(name, cuda)
    q, k, v, do, dlse, qseg, kseg, args = _flash_inputs(case, dt, cuda)
    args = args + ((p, 99) if p else ())
    (out, lse), (wout, wlse) = _both(
        lambda: flash_fwd(q, k, v, qseg, kseg, *args, bias=bias))
    _close(out, wout, dt)
    empty = wlse <= -1e29
    assert torch.equal(lse <= -1e29, empty)
    _close(torch.where(empty, 0.0, lse), torch.where(empty, 0.0, wlse),
           torch.float32)
    delta = (do.float() * wout.float()).sum(-1)
    bwd = (q, k, v, do, wlse, delta, dlse, qseg, kseg, *args)
    dq, wdq = _both(lambda: flash_dq(*bwd, bias=bias))
    _close(dq, wdq, dt)
    (dk, dv), (wdk, wdv) = _both(lambda: flash_dkv(*bwd, bias=bias))
    _close(dk, wdk, dt)
    _close(dv, wdv, dt)
    db, wdb = _both(lambda: flash_dbias(*bwd, bias=bias))
    assert db.shape == bias.shape and db.dtype == torch.float32
    _close(db, wdb, torch.float32)
    assert torch.equal(flash_dbias(*bwd, bias=bias), db)
    assert torch.equal(flash_dq(*bwd, bias=bias), dq)
    dk2, dv2 = flash_dkv(*bwd, bias=bias)
    assert torch.equal(dk2, dk) and torch.equal(dv2, dv)


#: dbias at the wgmma kernel's edges: name -> `_FLASH`'s fields, then
#: the bias's (Bb, Hb) ("B"/"H" the full dimension) and the dropout p.
#: Sq, Sk off the 64-row tiles; every broadcast form, so sweeps of
#: B·Hq (1, 1) down to 1 (B, Hq); causal with offsets; segments; dlse; D
#: 32 (no 16-byte copies), 64 and 128; a sweep of 16
_DBIAS = {
    "ragged_shared": (2, 4, 2, 300, 333, 64, False, None, 0, 0, False,
                      (1, 1), 0.0),
    "ragged_heads_offsets": (2, 4, 2, 300, 333, 64, True, None, 16, 48,
                             True, (1, "H"), 0.0),
    "ragged_batch_segments": (2, 4, 4, 300, 333, 64, False, "pair", 0, 0,
                              False, ("B", 1), 0.0),
    "ragged_full_dropout": (2, 4, 2, 300, 333, 64, True, None, 0, 0, True,
                            ("B", "H"), 0.1),
    "d128_heads_causal": (2, 4, 4, 200, 200, 128, True, None, 0, 0, False,
                          (1, "H"), 0.0),
    "d128_full_segments_dropout": (1, 2, 2, 130, 190, 128, False, "pair",
                                   0, 0, True, ("B", "H"), 0.1),
    "d32_shared": (2, 2, 1, 70, 90, 32, False, None, 0, 0, False, (1, 1),
                   0.0),
    "sweep16_dropout_dlse": (4, 4, 4, 128, 128, 64, True, None, 0, 0, True,
                             (1, 1), 0.1),
}


@pytest.mark.parametrize("name", list(_DBIAS))
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_flash_dbias_wgmma_edges(cuda, dtype, name):
    """dbias (the bf16/fp16 wgmma kernel) against its plain version at
    its tiles' and sweep's edges, from the plain forward's lse; the same
    bits on a second launch."""
    from apex1_tpu_torch.ops.attention import flash_dbias, flash_fwd
    dt = getattr(torch, dtype)
    B, Hq, _, Sq, Sk = _DBIAS[name][:5]
    bb, hb = _DBIAS[name][11]
    p = _DBIAS[name][12]
    q, k, v, do, dlse, qseg, kseg, args = _flash_inputs(name, dt, cuda,
                                                        _DBIAS)
    args = args + ((p, 99) if p else ())
    rng = np.random.default_rng(22)
    bias = rng.standard_normal((B if bb == "B" else 1, Hq if hb == "H" else 1,
                                Sq, Sk)).astype(np.float32)
    bias[..., :, 3] = -1e30
    bias[..., :, 5] = -10000.0
    bias = torch.from_numpy(bias).to(cuda)
    with force_impl("torch"):
        out, lse = flash_fwd(q, k, v, qseg, kseg, *args, bias=bias)
    delta = (do.float() * out.float()).sum(-1)
    bwd = (q, k, v, do, lse, delta, dlse, qseg, kseg, *args)
    db, wdb = _both(lambda: flash_dbias(*bwd, bias=bias))
    assert db.shape == bias.shape and db.dtype == torch.float32
    _close(db, wdb, torch.float32)
    assert torch.equal(flash_dbias(*bwd, bias=bias), db)


def test_flash_attention_launches_dbias_only_for_a_trained_bias(cuda):
    from apex1_tpu_torch.ops import KERNEL_WRAPPERS
    from apex1_tpu_torch.ops.attention import flash_attention
    names = ("flash_fwd", "flash_dq", "flash_dkv", "flash_dbias")

    def run(bias):
        before = {n: KERNEL_WRAPPERS[n].launches for n in names}
        q = torch.randn(2, 4, 64, 64, device=cuda, dtype=torch.bfloat16,
                        requires_grad=True)
        flash_attention(q, q, q, causal=True, bias=bias).float().sum() \
            .backward()
        return {n: KERNEL_WRAPPERS[n].launches - before[n] for n in names}

    mask = torch.zeros(2, 1, 64, 64, device=cuda)
    assert run(mask) == dict(flash_fwd=1, flash_dq=1, flash_dkv=1,
                             flash_dbias=0)
    table = torch.randn(1, 4, 64, 64, device=cuda, dtype=torch.bfloat16,
                        requires_grad=True)
    assert run(table) == dict(flash_fwd=1, flash_dq=1, flash_dkv=1,
                              flash_dbias=1)
    assert table.grad.dtype == torch.bfloat16



#: int8_mm cases: (T, N, K) — the decode model's projections at decode's
#: 8 rows and the prefill's 1024, the head, and odd shapes (ragged N and
#: T, T between the kernel's 8- and 64-row tiles, K % 16 != 0)
_INT8 = {"decode": (8, 5632, 2048), "head": (8, 32000, 2048),
         "wk_wv": (8, 256, 2048), "w_down": (8, 2048, 5632),
         "prefill": (1024, 256, 2048), "ragged": (5, 200, 72),
         "one": (1, 1, 16), "t9": (9, 130, 48), "t33_k1000": (33, 64, 1000),
         "k8": (3, 70, 8)}


def _int8_bound(got, want, absprod):
    """|got - want| <= 3u|want| + 1e-5 Σ|x||w|s: the same exact products
    summed in fp32 in another order (u = 2^-24)."""
    allow = 3 * 2.0 ** -24 * want.abs() + 1e-5 * absprod + 1e-30
    return ((got - want).abs() / allow).max().item()


@pytest.mark.parametrize("name", list(_INT8))
def test_int8_mm_kernel_matches_plain(cuda, name):
    from apex1_tpu_torch.ops.quantized import int8_mm, quantize_int8
    T, N, K = _INT8[name]
    g = torch.Generator(device=cuda).manual_seed(T * 7 + K)
    x = torch.randn(T, K, generator=g, device=cuda).to(torch.bfloat16)
    wq, s = quantize_int8(torch.randn(N, K, generator=g, device=cuda))
    got, want = _both(lambda: int8_mm(x, wq, s))
    with force_impl("torch"):
        absprod = int8_mm(x.abs(), wq.abs(), s)
    assert got.dtype == torch.float32 and got.shape == (T, N)
    assert _int8_bound(got, want, absprod) <= 1
    assert torch.equal(int8_mm(x, wq, s), got)


def test_int8_mm_unaligned_and_leading_dims(cuda):
    """An x that starts 2 bytes past a 16-byte boundary takes the scalar
    loads; fp32 x is rounded to bf16 first; leading dims are kept and dx
    is the fp32 product."""
    from apex1_tpu_torch.ops.quantized import (int8_matmul, int8_mm,
                                               quantize_int8)
    g = torch.Generator(device=cuda).manual_seed(3)
    wq, s = quantize_int8(torch.randn(96, 128, generator=g, device=cuda))
    buf = torch.randn(5 * 128 + 1, generator=g, device=cuda).to(
        torch.bfloat16)
    x = buf[1:].view(5, 128)
    assert x.data_ptr() % 16 != 0
    got, want = _both(lambda: int8_mm(x, wq, s))
    with force_impl("torch"):
        absprod = int8_mm(x.abs(), wq.abs(), s)
    assert _int8_bound(got, want, absprod) <= 1
    xf = torch.randn(2, 3, 128, generator=g, device=cuda,
                     requires_grad=True)
    y = int8_matmul(xf, wq, s)
    assert y.shape == (2, 3, 96)
    torch.testing.assert_close(y, int8_mm(xf.detach().to(torch.bfloat16)
                                          .reshape(6, 128), wq, s)
                               .reshape(2, 3, 96), rtol=0, atol=0)
    dy = torch.randn(2, 3, 96, generator=g, device=cuda)
    y.backward(dy)
    torch.testing.assert_close(xf.grad, (dy * s) @ wq.float(), rtol=1e-6,
                               atol=1e-6)


#: the wgmma int8_mm's tile edges: name -> (T, N, K). T across the token
#: tiles (8, 16, 32, 64, 128 rows), N ragged around the 64- and 128-row
#: weight tiles, K around the 64-deep step (K % 16 != 0: plain loads,
#: else TMA); "split" shapes cut K inside the launch, "whole" ones do
#: not, and "wide" ones run the two-warpgroup tiles (128 weight rows x 128,
#: 192 or 256 tokens, each with and without TMA)
_INT8_EDGES = {
    "t1_split": (1, 65, 2048),
    "t8_split": (8, 127, 640),
    "t9_split": (9, 129, 136),
    "t63_split": (63, 200, 1000),
    "t64_whole": (64, 17000, 192),
    "t65_split": (65, 300, 272),
    "t129_split": (129, 1000, 1000),
    "t257_whole": (257, 1000, 48),
    "t1024_whole": (1024, 1100, 320),
    "t1000_whole": (1000, 2000, 64),
    "wide_t257_whole": (257, 9000, 200),
    "wide_t1024_whole": (1024, 4500, 256),
    "wide_t1024_ragged_k_whole": (1024, 4500, 200),
    "wide_one_wave_whole": (1024, 4224, 128),
    "wide_ragged_k_whole": (1000, 4200, 200),
    "wide_t200_whole": (200, 12800, 192),
    "wide_t200_ragged_k_whole": (200, 12750, 200),
    "wide_t200_bt128_whole": (200, 8448, 192),
}


@pytest.mark.parametrize("name", list(_INT8_EDGES))
def test_int8_mm_wgmma_tile_edges(cuda, name):
    """The wgmma ``int8_mm`` at its tiles' edges: the fp32 rounding
    bound against the plain version, the same bits on a second launch
    (a K split is summed in split order inside the launch), the split
    plan as the name says, one launch counted a call."""
    from apex1_tpu_torch.ops.quantized import (_split_k, _tile, int8_mm,
                                               quantize_int8)
    T, N, K = _INT8_EDGES[name]
    splits, _ = _split_k(T, N, K)
    assert (splits > 1) == name.endswith("split")
    assert (_tile(T, N)[0] == 128) == name.startswith("wide")
    g = torch.Generator(device=cuda).manual_seed(T * 7 + K)
    x = torch.randn(T, K, generator=g, device=cuda).to(torch.bfloat16)
    wq, s = quantize_int8(torch.randn(N, K, generator=g, device=cuda))
    before = int8_mm.launches
    got, want = _both(lambda: int8_mm(x, wq, s))
    assert int8_mm.launches == before + 1
    with force_impl("torch"):
        absprod = int8_mm(x.abs(), wq.abs(), s)
    assert got.shape == (T, N)
    assert _int8_bound(got, want, absprod) <= 1
    for _ in range(2):
        assert torch.equal(int8_mm(x, wq, s), got)


@pytest.mark.parametrize("shape", [(8, 5632, 2048), (1024, 5632, 2048)],
                         ids=["decode_split", "prefill_whole"])
def test_int8_mm_is_one_kernel_launch(cuda, shape):
    """One device kernel a call, a K split included (the profiler's
    CUDA-side events of one warm call)."""
    from torch.profiler import ProfilerActivity, profile

    from apex1_tpu_torch.ops.quantized import int8_mm, quantize_int8
    T, N, K = shape
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(T, K, generator=g, device=cuda).to(torch.bfloat16)
    wq, s = quantize_int8(torch.randn(N, K, generator=g, device=cuda))
    int8_mm(x, wq, s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        int8_mm(x, wq, s)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "int8_mm" in kernels[0], kernels


#: lora_delta cases: (slots, rows a slot, rank, hidden, vocab, h dtype):
#: `serve-lora`'s decode, verify and prefill row, every rank the stream
#: kernel instantiates (8, 16, 32, 64) and one it loops over (17), hidden
#: widths off 8 (the coefficients' scalar path) and vocabs off 4 (the
#: stream's), one of them at the prefill row; 80 rows, which the stream
#: kernel takes two a block (`lora_rows`), at ranks it loads in chunks
_LORA = {"decode": (8, 1, 16, 2048, 32000, "bfloat16"),
         "verify": (8, 5, 16, 2048, 32000, "bfloat16"),
         "prefill": (1, 1, 16, 2048, 32000, "bfloat16"),
         "f32_ragged": (3, 2, 3, 100, 1001, "float32"),
         "f16_rank1": (4, 1, 1, 64, 130, "float16"),
         "wide_rank": (2, 3, 64, 256, 4096, "bfloat16"),
         "rank8": (8, 1, 8, 2048, 32000, "bfloat16"),
         "rank32": (8, 5, 32, 2048, 32000, "bfloat16"),
         "rank17": (4, 2, 17, 512, 4096, "bfloat16"),
         "rank17_f32_ragged": (3, 1, 17, 100, 1001, "float32"),
         "prefill_odd_vocab": (1, 1, 16, 2048, 31999, "bfloat16"),
         "rank17_grouped": (16, 5, 17, 256, 8192, "bfloat16"),
         "rank64_grouped": (16, 5, 64, 256, 8190, "float16")}


@pytest.mark.parametrize("name", list(_LORA))
def test_lora_delta_kernel_matches_plain(cuda, name):
    """fp32 rounding bound against the plain version; page-0 rows
    exactly 0.0; the same bits twice; each row equal to itself computed
    alone."""
    from apex1_tpu_torch.ops.lora_epilogue import lora_delta
    slots, width, R, H, V, dts = _LORA[name]
    g = torch.Generator(device=cuda).manual_seed(R * 31 + V)
    P = 1 + 3 * R
    a = torch.randn(P, H, generator=g, device=cuda) * H ** -0.5
    b = torch.randn(P, V, generator=g, device=cuda)
    a[0], b[0] = 0.0, 0.0
    rows = torch.zeros(slots, R, dtype=torch.int32)
    for n in range(max(slots - 1, 1)):
        rows[n] = 1 + (n % 3) * R + torch.arange(R)
    bt = rows.repeat_interleave(width, dim=0).to(cuda)
    h = torch.randn(slots * width, H, generator=g, device=cuda).to(
        getattr(torch, dts))
    got, want = _both(lambda: lora_delta(h, a, b, bt))
    with force_impl("torch"):
        absprod = lora_delta(h.abs(), a.abs(), b.abs(), bt)
    assert got.dtype == torch.float32 and got.shape == (slots * width, V)
    assert _int8_bound(got, want, absprod) <= 1
    zero = (bt == 0).all(dim=1)
    assert (got[zero] == 0).all()
    assert torch.equal(lora_delta(h, a, b, bt), got)
    for n in range(h.shape[0]):
        assert torch.equal(lora_delta(h[n:n + 1], a, b, bt[n:n + 1])[0],
                           got[n]), n


# ---- the multi-GPU slice's kernels --------------------------------------

#: chunk_matmul cases: (leading dims of rows, K, N): the tensor-parallel
#: rank's chunk, an (S, mb, hid) operand, ragged M, N and K, one element;
#: the edges of the bf16/fp16 kernel's 128-row tiles (M 127/129), of its
#: 128- and 256-column tiles (N 127/129/255/257, and 128 x 256 tiles,
#: which it takes from 132 of them on, at ragged and aligned shapes) and
#: of its 64-deep K steps (63/65), and the empty sum K = 0
_CHUNK = {"aligned": ((256,), 96, 128), "tp_chunk": ((1024,), 2048, 1024),
          "rank3": ((64, 3), 64, 72), "ragged": ((37,), 29, 50),
          "one": ((1,), 1, 1), "m127": ((127,), 64, 136),
          "m129": ((129,), 64, 136), "n127": ((64,), 64, 127),
          "n129": ((64,), 64, 129), "n255": ((130,), 72, 255),
          "n257": ((130,), 72, 257), "k63": ((200,), 63, 136),
          "k65": ((200,), 65, 136), "k0": ((70,), 0, 72),
          "wide_ragged": ((1537,), 65, 2561),
          "wide_aligned": ((1409,), 136, 2824)}


@pytest.mark.parametrize("name", list(_CHUNK))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_chunk_matmul_kernel_matches_plain(cuda, dtype, name):
    """The fp32 rounding bound against ``torch.matmul`` of the widened
    operands; the same bits twice; with an accumulator, equal to
    ``acc + chunk_matmul(rows, w)`` bit for bit."""
    from apex1_tpu_torch.ops.fused_collective import chunk_matmul
    lead, K, N = _CHUNK[name]
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(K * 31 + N)
    rows = torch.randn(*lead, K, generator=g, device=cuda).to(dt)
    w = torch.randn(K, N, generator=g, device=cuda).to(dt)
    acc = torch.randn(*lead, N, generator=g, device=cuda)
    got, want = _both(lambda: chunk_matmul(rows, w))
    with force_impl("torch"):
        absprod = chunk_matmul(rows.abs(), w.abs())
    assert got.dtype == torch.float32 and got.shape == tuple(lead) + (N,)
    assert _int8_bound(got, want, absprod) <= 1
    assert torch.equal(chunk_matmul(rows, w), got)
    assert torch.equal(chunk_matmul(rows, w, acc), acc + got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_chunk_matmul_tile_choice(cuda, dtype):
    """The tile the kernel takes: bf16/fp16 128 x 256 from 132 tiles of
    it on (the world-1 products), else 128 x 128 (a tp = 8 chunk); fp32
    128 x 128, 128 x 64 or 64 x 64 as before."""
    from apex1_tpu_torch.ops.fused_collective import chunk_tile
    dt = getattr(torch, dtype)
    half = dt != torch.float32
    assert chunk_tile(8192, 8192, dt) == (128, 256 if half else 128)
    assert chunk_tile(8192, 2048, dt) == (128, 256 if half else 128)
    assert chunk_tile(1024, 1024, dt) == ((128, 128) if half else (64, 64))
    assert chunk_tile(1537, 2561, dt) == (128, 256 if half else 128)


#: flash_fwd_merge cases: (B, Hq, Hkv, Sq, Sk, D, causal, segments,
#: q_off, k_off): a ring step off the diagonal, on it, segments, GQA
_MERGE = {"offdiag": (1, 4, 4, 128, 128, 64, True, False, 256, 0),
          "diag": (1, 8, 2, 160, 160, 64, True, False, 160, 160),
          "segments": (2, 4, 4, 96, 96, 64, False, True, 0, 0),
          "d128_gqa": (1, 4, 1, 64, 100, 128, True, False, 100, 64)}


@pytest.mark.parametrize("name", list(_MERGE))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_flash_fwd_merge_kernel_matches_plain(cuda, dtype, name):
    """The merge epilogue against `flash_fwd`'s plain version followed by
    `merge_partials`, with a carried (out, lse) (NEG_INF in some rows);
    out at the operand type's tolerance (its shard part is rounded to
    it), lse at f32's; the same bits twice."""
    from apex1_tpu_torch.ops.attention import flash_fwd_merge
    B, Hq, Hkv, Sq, Sk, D, causal, seg, q_off, k_off = _MERGE[name]
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(Sq + Sk)

    def t(*shape):
        return torch.randn(*shape, generator=g, device=cuda)

    q, k, v = t(B, Hq, Sq, D).to(dt), t(B, Hkv, Sk, D).to(dt), \
        t(B, Hkv, Sk, D).to(dt)
    po, plse = t(B, Hq, Sq, D), t(B, Hq, Sq) * 3
    plse[..., :5] = -1e30
    qseg = kseg = None
    if seg:
        qseg = torch.sort(torch.randint(0, 3, (B, Sq), generator=g,
                                        device=cuda), dim=1)[0].int()
        kseg = qseg
    args = (q, k, v, qseg, kseg, D ** -0.5, causal, q_off, k_off, po, plse)
    (out, lse), (wout, wlse) = _both(lambda: flash_fwd_merge(*args))
    assert out.dtype == lse.dtype == torch.float32
    _close(out, wout, dt)
    _close(lse, wlse, torch.float32)
    out2, lse2 = flash_fwd_merge(*args)
    assert torch.equal(out2, out) and torch.equal(lse2, lse)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_flash_dkv_fp32_output(cuda, dtype):
    """dk/dv stored in fp32 (the ring backward's partials): the plain
    version's at the operand type's tolerance, and rounded to the
    operand type equal to the default output bit for bit."""
    from apex1_tpu_torch.ops.attention import flash_dkv, flash_fwd
    dt = getattr(torch, dtype)
    q, k, v, do, dlse, qseg, kseg, args = _flash_inputs("gqa", dt, cuda)
    with force_impl("torch"):
        out, lse = flash_fwd(q, k, v, qseg, kseg, *args)
    delta = (do.float() * out.float()).sum(-1)
    bwd = (q, k, v, do, lse, delta, dlse, qseg, kseg, *args)
    (dk, dv), (wdk, wdv) = _both(
        lambda: flash_dkv(*bwd, out_dtype=torch.float32))
    assert dk.dtype == dv.dtype == torch.float32
    _close(dk, wdk, dt)
    _close(dv, wdv, dt)
    dk_t, dv_t = flash_dkv(*bwd)
    assert torch.equal(dk.to(dt), dk_t) and torch.equal(dv.to(dt), dv_t)


# ---- the flash forward and dk/dv on wgmma: the tiles' edges -------------

#: name -> (B, Hq, Hkv, Sq, Sk, D, causal, segments, q_off, k_off, dlse,
#: bias (Bb, Hb) or None, dropout p): Sq and Sk one below and above
#: multiples of 64 and 128 (the forward's and dq's 64-row blocks and
#: 64-key tiles, dk/dv's 64-key blocks and 64-row q tiles) and on them,
#: causal diagonals that cross a tile mid-way, GQA 4/1 and 32/8 at D 128,
#: D 40 (padded to 64, plain loads), a -1 segment tail, (B, Hq), (1, Hq)
#: and (B, 1) biases and dropout with offsets
_EDGES = {
    "sq63_sk65": (2, 4, 4, 63, 65, 64, False, None, 0, 0, False, None, 0.0),
    "sq65_sk127_causal": (1, 4, 2, 65, 127, 64, True, None, 62, 0, False,
                          None, 0.0),
    "sq129_sk63_d128": (1, 2, 2, 129, 63, 128, False, None, 0, 0, True,
                        None, 0.0),
    "sq127_sk129_d128_causal": (1, 4, 4, 127, 129, 128, True, None, 2, 0,
                                False, None, 0.0),
    "diagonal_mid_tile": (2, 4, 4, 192, 230, 64, True, None, 37, 5, False,
                          None, 0.0),
    "keys_ahead_empty_rows": (1, 4, 4, 150, 250, 64, True, None, 0, 100,
                              True, None, 0.0),
    "gqa41_d128": (2, 4, 1, 130, 130, 128, True, None, 0, 0, False, None,
                   0.0),
    "segments_tail": (2, 4, 4, 193, 193, 64, True, "array", 0, 0, False,
                      None, 0.0),
    "bias_b_hq": (2, 4, 2, 100, 129, 64, False, None, 0, 0, True, ("B", "H"),
                  0.0),
    "bias_d128_causal_offsets": (1, 4, 4, 96, 160, 128, True, None, 64, 0,
                                 False, (1, "H"), 0.0),
    "dropout_offsets": (1, 4, 2, 130, 130, 128, True, None, 71, 3, True,
                        None, 0.1),
    "dropout_bias_segments": (2, 4, 4, 129, 129, 64, False, "array", 0, 0,
                              False, (1, 1), 0.1),
    "sq64_sk64": (1, 2, 2, 64, 64, 64, True, None, 0, 0, False, None, 0.0),
    "sq128_sk192_d128": (1, 2, 1, 128, 192, 128, False, None, 0, 0, True,
                         None, 0.0),
    "bias_b_1_causal": (2, 4, 2, 129, 129, 64, True, None, 0, 0, False,
                        ("B", 1), 0.0),
    "gqa328_d128": (1, 32, 8, 129, 129, 128, True, None, 0, 0, True, None,
                    0.0),
    "d40": (2, 4, 2, 65, 127, 40, True, None, 3, 0, True, None, 0.0),
    "d40_bias_dropout": (1, 4, 4, 130, 70, 40, False, None, 0, 0, False,
                         (1, "H"), 0.1),
}


def _edge_inputs(name, dt, cuda):
    """q, k, v, dout, dlse, qseg, kseg, the positional arguments after
    the segments, the bias (fp32) or None."""
    (B, Hq, Hkv, Sq, Sk, D, causal, seg, q_off, k_off, dl, bias,
     p) = _EDGES[name]
    rng = np.random.default_rng(Sq * 1000 + Sk)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(cuda, dt)

    q, k, v, do = t(B, Hq, Sq, D), t(B, Hkv, Sk, D), t(B, Hkv, Sk, D), \
        t(B, Hq, Sq, D)
    dlse = (torch.from_numpy(rng.standard_normal((B, Hq, Sq))).float()
            .to(cuda) if dl else None)
    qseg = kseg = None
    if seg:
        ids = np.sort(rng.integers(0, 3, (B, Sq)), axis=1)
        ids[:, -11:] = -1
        qseg = kseg = torch.from_numpy(ids).to(cuda, torch.int32)
    b = None
    if bias is not None:
        shape = (B if bias[0] == "B" else 1, Hq if bias[1] == "H" else 1,
                 Sq, Sk)
        b = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        b = b.to(cuda)
    args = (1.0 / np.sqrt(D), causal, q_off, k_off) + (
        (p, 1234) if p else ())
    return q, k, v, do, dlse, qseg, kseg, args, b


@pytest.mark.parametrize("name", list(_EDGES))
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_flash_wgmma_edges_match_plain(cuda, dtype, name):
    """The wgmma forward, dq and dk/dv against their plain versions at
    the tiles' edges: out and lse, dq, dk, dv at the operand type's
    tolerance, rows without keys equal; dq and dk/dv the same bits on a
    second launch, and with fp32 output the plain version's
    fp32 output, equal to the default output once rounded."""
    from apex1_tpu_torch.ops.attention import flash_dkv, flash_dq, flash_fwd
    dt = getattr(torch, dtype)
    q, k, v, do, dlse, qseg, kseg, args, bias = _edge_inputs(name, dt, cuda)
    kw = {} if bias is None else dict(bias=bias)
    (out, lse), (wout, wlse) = _both(
        lambda: flash_fwd(q, k, v, qseg, kseg, *args, **kw))
    _close(out, wout, dt)
    empty = wlse <= -1e29
    assert torch.equal(lse <= -1e29, empty)
    _close(torch.where(empty, 0.0, lse), torch.where(empty, 0.0, wlse),
           torch.float32)
    delta = (do.float() * wout.float()).sum(-1)
    bwd = (q, k, v, do, wlse, delta, dlse, qseg, kseg, *args)
    dq, wdq = _both(lambda: flash_dq(*bwd, **kw))
    _close(dq, wdq, dt)
    assert torch.equal(flash_dq(*bwd, **kw), dq)
    (dk, dv), (wdk, wdv) = _both(lambda: flash_dkv(*bwd, **kw))
    _close(dk, wdk, dt)
    _close(dv, wdv, dt)
    dk2, dv2 = flash_dkv(*bwd, **kw)
    assert torch.equal(dk2, dk) and torch.equal(dv2, dv)
    (fk, fv), (wfk, wfv) = _both(
        lambda: flash_dkv(*bwd, **kw, out_dtype=torch.float32))
    assert fk.dtype == fv.dtype == torch.float32
    _close(fk, wfk, dt)
    _close(fv, wfv, dt)
    assert torch.equal(fk.to(dt), dk) and torch.equal(fv.to(dt), dv)


@pytest.mark.parametrize("name", [n for n, c in _EDGES.items()
                                  if c[11] is None and not c[12]])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_flash_wgmma_merge_edges(cuda, dtype, name):
    """The merge epilogue at the same edges: against `flash_fwd`'s plain
    version and `merge_partials`, the same bits twice, and with nothing
    carried (lse NEG_INF) equal to the plain-mode kernel's output, widened,
    bit for bit (one main loop)."""
    from apex1_tpu_torch.ops.attention import flash_fwd, flash_fwd_merge
    dt = getattr(torch, dtype)
    q, k, v, _, _, qseg, kseg, args, _ = _edge_inputs(name, dt, cuda)
    g = torch.Generator(device=cuda).manual_seed(5)
    po = torch.randn(q.shape, generator=g, device=cuda)
    plse = torch.randn(q.shape[:3], generator=g, device=cuda) * 3
    plse[..., :7] = -1e30
    margs = (q, k, v, qseg, kseg, *args, po, plse)
    (out, lse), (wout, wlse) = _both(lambda: flash_fwd_merge(*margs))
    _close(out, wout, dt)
    _close(lse, wlse, torch.float32)
    out2, lse2 = flash_fwd_merge(*margs)
    assert torch.equal(out2, out) and torch.equal(lse2, lse)
    none = torch.full_like(plse, -1e30)
    mout, mlse = flash_fwd_merge(q, k, v, qseg, kseg, *args,
                                 torch.zeros_like(po), none)
    fout, flse = flash_fwd(q, k, v, qseg, kseg, *args)
    assert torch.equal(mout, fout.float())
    assert torch.equal(mlse, flse)


@pytest.mark.parametrize("offs", [(37, 5), (0, 100), (71, 3)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_flash_wgmma_dropout_witness_edges(cuda, dtype, offs):
    """The dropout mask at offsets that put it mid-tile, Sq = 65: v the
    identity (Sk = D = 128), so out's zero pattern is the kernel's mask;
    it equals the plain version's and `_keep`'s exactly."""
    from apex1_tpu_torch.ops.attention import _keep, flash_fwd
    dt = getattr(torch, dtype)
    B, Hq, Hkv, Sq, S, p = 2, 4, 2, 65, 128, 0.1
    gen = torch.Generator(device=cuda).manual_seed(11)
    q = (0.1 * torch.randn(B, Hq, Sq, S, generator=gen, device=cuda)).to(dt)
    k = (0.1 * torch.randn(B, Hkv, S, S, generator=gen, device=cuda)).to(dt)
    v = torch.eye(S, device=cuda, dtype=dt).expand(B, Hkv, S, S).contiguous()
    args = (None, None, S ** -0.5, False, *offs, p, 2024)
    out, _ = flash_fwd(q, k, v, *args)
    with force_impl("torch"):
        wout, _ = flash_fwd(q, k, v, *args)
    keep = _keep(q, S, *offs, p, 2024)
    assert torch.equal(out != 0, keep)
    assert torch.equal(wout != 0, keep)


@pytest.fixture()
def nccl_world(cuda, tmp_path):
    """A one-rank NCCL process group and the mesh over it."""
    import torch.distributed as dist
    from apex1_tpu_torch.parallel import init_distributed
    from apex1_tpu_torch.transformer import parallel_state as ps
    init_distributed("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                     world_size=1)
    try:
        yield ps.initialize_model_parallel(1)
    finally:
        ps.destroy_model_parallel()
        dist.destroy_process_group()


def test_one_rank_nccl_fused_paths(nccl_world):
    """`fused_all_gather_matmul` and `all_gather_flash_attention` on a
    one-rank NCCL group: forward and backward through the kernels
    (chunk_matmul twice, the merge flash once, dq and dk/dv once), equal
    to their plain versions within the kernels' tolerances; the dW
    re-gather goes through NCCL."""
    from apex1_tpu_torch.ops import KERNEL_WRAPPERS
    from apex1_tpu_torch.ops import fused_collective as fc
    from apex1_tpu_torch.transformer import parallel_state as ps
    from apex1_tpu_torch.transformer.tensor_parallel import mappings
    group = ps.get_tensor_model_parallel_group()
    g = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn(256, 128, generator=g, device="cuda").to(torch.bfloat16)
    w = torch.randn(128, 192, generator=g, device="cuda").to(torch.bfloat16)
    names = ("chunk_matmul", "flash_fwd_merge", "flash_dq", "flash_dkv")

    def run():
        before = {n: KERNEL_WRAPPERS[n].launches for n in names}
        mappings.reset_collectives()
        xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = fc.fused_all_gather_matmul(xs, ws, group)
        y.backward(torch.ones_like(y))
        q = x.view(1, 4, 64, 128)[..., :64].contiguous().requires_grad_()
        o = fc.all_gather_flash_attention(q, q, q, group, causal=True)
        o.float().sum().backward()
        torch.cuda.synchronize()
        counts = {n: KERNEL_WRAPPERS[n].launches - before[n] for n in names}
        return (y, xs.grad, ws.grad, o, q.grad), counts, \
            mappings.collective_counts()

    got, counts, coll = run()
    with force_impl("torch"):
        want, _, _ = run()
    assert counts == dict(chunk_matmul=2, flash_fwd_merge=1, flash_dq=1,
                          flash_dkv=1)
    assert coll["all_gather"] == 1
    for a, b in zip(got, want):
        _close(a, b, torch.bfloat16)


# ---- the bench's llama_3d shapes ------------------------------------------

#: llama_3d's attention (`chip_smoke.py`'s train-llama-3d: hidden 2048,
#: 32 query and 4 KV heads of 64, S 2048, one sequence a microbatch)
_FLASH_L3D = {"llama_3d": (1, 32, 4, 2048, 2048, 64, True, None, 0, 0,
                           False)}


def test_flash_kernels_at_llama_3d_shape(cuda):
    """Causal GQA 32/4, D 64, S 2048, bf16: the forward, dq and dk/dv
    against their plain versions (the tolerances above), dq and dk/dv
    the same bits on a second run."""
    from apex1_tpu_torch.ops.attention import flash_dkv, flash_dq, flash_fwd
    dt = torch.bfloat16
    q, k, v, do, dlse, qseg, kseg, args = _flash_inputs(
        "llama_3d", dt, cuda, cases=_FLASH_L3D)
    (out, lse), (wout, wlse) = _both(
        lambda: flash_fwd(q, k, v, qseg, kseg, *args))
    _close(out, wout, dt)
    _close(lse, wlse, torch.float32)
    delta = (do.float() * wout.float()).sum(-1)
    bwd = (q, k, v, do, wlse, delta, dlse, qseg, kseg, *args)
    dq, wdq = _both(lambda: flash_dq(*bwd))
    _close(dq, wdq, dt)
    (dk, dv), (wdk, wdv) = _both(lambda: flash_dkv(*bwd))
    _close(dk, wdk, dt)
    _close(dv, wdv, dt)
    assert torch.equal(flash_dq(*bwd), dq)
    dk2, dv2 = flash_dkv(*bwd)
    assert torch.equal(dk2, dk) and torch.equal(dv2, dv)


def test_linear_xent_shard_kernels_at_llama_3d_head(cuda):
    """`shard_stats` (row 8) and `shard_grads` (rows 10-11) at llama_3d's
    head: 8192 tokens x 2048 against the whole 32000-row vocab (tp 1),
    bf16, the labels the tokens rolled by one, against their plain
    versions (fp32 tolerance for the statistics, bf16's for dx and dW);
    dx and dW the same bits on a second run."""
    from apex1_tpu_torch.ops.linear_xent import shard_grads, shard_stats
    T, H, V = 8192, 2048, 32000
    dt = torch.bfloat16
    gen = torch.Generator(device=cuda).manual_seed(20)
    x = torch.randn(T, H, generator=gen, device=cuda).to(dt)
    w = (torch.randn(V, H, generator=gen, device=cuda) * 0.02).to(dt)
    t = torch.roll(torch.randint(0, V, (T,), generator=gen, device=cuda),
                   -1).to(torch.int32)
    stats, wstats = _both(lambda: shard_stats(x, w, t, num_classes=V))
    for g, wv in zip(stats, wstats):
        _close(g, wv, torch.float32)
    lse = wstats[0] + torch.log(wstats[1])
    dloss = torch.full((T,), 1.0 / T, device=cuda)
    (dx, dw), (wdx, wdw) = _both(lambda: shard_grads(x, w, t, lse, dloss,
                                                     num_classes=V))
    _close(dx, wdx, dt)
    _close(dw, wdw, dt)
    dx2, dw2 = shard_grads(x, w, t, lse, dloss, num_classes=V)
    assert torch.equal(dx2, dx) and torch.equal(dw2, dw)


# ---- the T5 generation and contrib slice ----------------------------------


@pytest.mark.parametrize("sk", [512, 77])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_flash_one_query_row_with_key_padding(cuda, dtype, sk):
    """T5's cross-attention at a decode step: one query row (Sq = 1, one
    row of the kernel's 64-row tile) against Sk keys, key padding as the
    segment pair (zeros, where(keep, 0, 1)), a row with every key kept
    and one with its last keys padded; forward, dq and dk/dv against the
    plain versions, the same bits twice."""
    from apex1_tpu_torch.ops.attention import flash_dkv, flash_dq, flash_fwd
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(21)
    B, H, D = 3, 4, 64

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(cuda, dt)

    q, k, v, do = t(B, H, 1, D), t(B, H, sk, D), t(B, H, sk, D), \
        t(B, H, 1, D)
    keep = np.ones((B, sk), bool)
    keep[1, -sk // 4:] = False
    keep[2, ::3] = False
    qseg = torch.zeros(B, 1, dtype=torch.int32, device=cuda)
    kseg = torch.from_numpy(np.where(keep, 0, 1)).to(cuda, torch.int32)
    args = (qseg, kseg, 1.0, False, 0, 0)
    (out, lse), (wout, wlse) = _both(lambda: flash_fwd(q, k, v, *args))
    _close(out, wout, dt)
    _close(lse, wlse, torch.float32)
    again, _ = flash_fwd(q, k, v, *args)
    assert torch.equal(again, out)
    delta = (do.float() * wout.float()).sum(-1)
    bwd = (q, k, v, do, wlse, delta, None, *args)
    dq, wdq = _both(lambda: flash_dq(*bwd))
    _close(dq, wdq, dt)
    (dk, dv), (wdk, wdv) = _both(lambda: flash_dkv(*bwd))
    _close(dk, wdk, dt)
    _close(dv, wdv, dt)
    # the padded keys get no gradient
    pad = torch.from_numpy(~keep).to(cuda)[:, None, :, None]
    assert not torch.where(pad, dv.float(), 0.0).any()


@pytest.mark.parametrize("h", [128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_openfold_widths(cuda, dtype, h):
    """OpenFold's c_z 128 and c_m 256 rows (fp32 γ/β), forward and
    backward against the plain versions."""
    from apex1_tpu_torch.contrib import openfold
    dt = getattr(torch, dtype)
    x, g, b = _norm_inputs(4099, h, dt, cuda, 22)
    dy = torch.randn(x.shape, device=cuda).to(dt)

    def run():
        xx, gg, bb = (a.detach().requires_grad_() for a in (x, g, b))
        y = openfold.layer_norm(xx, gg, bb)
        return (y, *torch.autograd.grad(y, (xx, gg, bb), dy))

    got, want = _both(run)
    for a, w, d in zip(got, want, (dt, dt, torch.float32, torch.float32)):
        _close(a, w, d)


#: the Evoformer attention's folded masks over (N, H, S, S) scores:
#: bias1 (N, 1, 1, S), the pair bias (1, H, S, S), both, and the mask
_OPENFOLD_MASKS = ("bias1", "bias2", "both", "mask")


@pytest.mark.parametrize("kind", _OPENFOLD_MASKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_openfold_mask_shapes(cuda, dtype, kind):
    """`openfold.attention_core` on (1, N, H, S, D) inputs: the softmax
    kernels at the folded mask's broadcast shapes, the output and the
    grads of q, k and v against the plain versions."""
    from apex1_tpu_torch.contrib import openfold
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(23)
    N, H, S, D = 6, 4, 160, 32

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(cuda, dt)

    q, k, v, do = (t(1, N, H, S, D) for _ in range(4))
    kw = {}
    if kind in ("bias1", "both"):
        kw["bias1"] = t(1, N, 1, 1, S).float()
    if kind in ("bias2", "both"):
        kw["bias2"] = t(1, 1, H, S, S).float()
    if kind == "mask":
        kw["mask"] = torch.from_numpy(rng.random((1, N, 1, 1, S)) > 0.2).to(
            cuda)

    def run():
        qq, kk, vv = (a.detach().requires_grad_() for a in (q, k, v))
        out = openfold.attention_core(qq, kk, vv, **kw)
        return (out, *torch.autograd.grad(out, (qq, kk, vv), do))

    got, want = _both(run)
    for a, w in zip(got, want):
        _close(a, w, dt)


def test_t5_generate_kernels_match_plain(cuda):
    """`t5_generate` on T5-large widths at depth 2, O0, 2 x 64 encoder
    tokens (one row with 16 padded keys), 8 new tokens: greedy and
    ``num_beams=2`` equal through the kernels and the plain versions
    (an fp32 path: a near-tie below 1e-4 would be the only excuse, and
    none is expected at these seeds), the exact launches of a call."""
    from apex1_tpu_torch import T5, T5Config, get_policy
    from apex1_tpu_torch.models.generate import t5_generate
    from apex1_tpu_torch.models.t5 import init_weights
    from apex1_tpu_torch.ops import launch_counts, reset_launches
    cfg = T5Config.t5_large(policy=get_policy("O0"), num_encoder_layers=2,
                            num_decoder_layers=2)
    model = init_weights(T5(cfg, device=cuda), 3)
    rng = np.random.default_rng(24)
    enc = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64))).to(
        cuda)
    keep = torch.ones(2, 64, dtype=torch.bool, device=cuda)
    keep[1, -16:] = False
    N = 8
    for beams in (1, 2):
        reset_launches()
        got, want = _both(lambda: t5_generate(
            model, enc, max_new_tokens=N, enc_pad_mask=keep,
            num_beams=beams))
        assert torch.equal(got, want), (got, want)
        counts = {n: c for n, c in launch_counts().items() if c}
        # encoder: 2 norms a layer + the final one, 1 flash a layer;
        # each decoder step: 3 norms a layer + the final one, the
        # cross-attention's flash a layer (self-attention is the
        # cache_attend composite)
        assert counts == {"layer_norm_fwd": 5 + N * 7,
                          "flash_fwd": 2 + N * 2}


@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_per_row_cache_index_equals_scalar_rows(cuda, dtype, s):
    """The dense `cached_attention` with a (B,) device index (the dense
    engine's decode and verify, `speculative_generate`'s rounds) equals
    the scalar form row by row, bit for bit: the same composite on each
    row, the writes in place into a `DenseCache`, the last row's window
    clamped as ``dynamic_update_slice`` clamps it."""
    from apex1_tpu_torch.models.generate import DenseCache, cached_attention
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(9)
    B, Hq, Hkv, L, D = 4, 12, 4, 64, 64

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=cuda).to(dt)

    q, kn, vn = rnd(B, Hq, s, D), rnd(B, Hkv, s, D), rnd(B, Hkv, s, D)
    k0, v0 = rnd(B, Hkv, L, D), rnd(B, Hkv, L, D)
    idx = torch.tensor([0, 17, 40, L - 1], device=cuda)
    cache = DenseCache(k0.clone(), v0.clone())
    out, entry = cached_attention(q, kn, vn, cache, idx, chunk_decode=True)
    assert entry is cache
    for b in range(B):
        o, e = cached_attention(q[b:b + 1], kn[b:b + 1], vn[b:b + 1],
                                {"k": k0[b:b + 1], "v": v0[b:b + 1]},
                                int(idx[b]), chunk_decode=True)
        assert torch.equal(out[b:b + 1], o), b
        assert torch.equal(cache.k[b:b + 1], e["k"]), b
        assert torch.equal(cache.v[b:b + 1], e["v"]), b


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_dense_engine_equals_paged_engine(cuda, temperature):
    """A tiny GPT-2 at O0 through the dense pool (the `cache_attend`
    composite, `fused_sample`) and the paged pool (`paged_attend`,
    `fused_sample`): the same streams, the dense run launching no paged
    attention and one sampler a forward."""
    from apex1_tpu_torch import (Engine, EngineConfig, GPT2Config,
                                 get_policy, gpt2_decoder,
                                 gpt2_params_from_jax)
    from apex1_tpu_torch.models.gpt2 import init_params
    from apex1_tpu_torch.ops import launch_counts, reset_launches
    cfg = GPT2Config.tiny(policy=get_policy("O0"), max_seq_len=128)
    model = gpt2_params_from_jax(init_params(cfg, 0), cfg, cuda)
    apply_fn, make_cache = gpt2_decoder(model)
    rng = np.random.default_rng(10)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in
               (3, 17, 9, 33, 5, 12)]
    streams = {}
    for paged in (False, True):
        eng = Engine(apply_fn, make_cache, EngineConfig(
            max_slots=4, max_len=96, prefill_chunk=8, paged=paged,
            temperature=temperature, vocab_size=cfg.vocab_size),
            device=cuda)
        reset_launches()
        ids = [eng.submit(p, max_new_tokens=12, seed=i)
               for i, p in enumerate(prompts)]
        eng.run(max_steps=200)
        counts = launch_counts()
        n_fwd = (eng.metrics.get_counter("prefill_chunks")
                 + eng.metrics.get_counter("decode_steps"))
        assert counts["fused_sample"] == n_fwd
        assert counts["paged_attend"] == (n_fwd * cfg.num_layers
                                          if paged else 0)
        streams[paged] = [eng.results[r].tokens.tolist() for r in ids]
    assert streams[False] == streams[True]


# ---- the tuning table and the budget model (card) -----------------------

TUNABLE = ("int8_matmul", "fused_sample", "paged_decode", "lora_epilogue",
           "fused_swiglu", "fused_collective_matmul", "chunked_loss")


@pytest.mark.parametrize("name", TUNABLE)
def test_table_driven_launches_equal_plain(cuda, name, tmp_path,
                                           monkeypatch):
    """Each swept candidate banked as a measured table entry is what the
    op then launches (its plan), and the launch equals the plain version
    within the sweep's tolerance (ids exactly)."""
    from apex1_tpu_torch import tuning
    from apex1_tpu_torch.tuning import sweep
    monkeypatch.setenv("APEX1_TUNING_DIR", str(tmp_path))
    tuning.clear_cache()
    case = sweep.CASES[name](torch, "cuda", False)
    assert case.plan() == case.heuristic()
    want = case.plain()
    try:
        for p in case.candidates:
            tuning.clear_cache()
            tuning.record(case.kernel, case.dims, case.dtype, p,
                          time_ms=1.0)
            assert tuning.lookup(case.kernel, case.dims, case.dtype) == p
            assert case.plan() == p
            ok, worst = sweep.compare(torch, case.make(None)(), want,
                                      case.tol)
            torch.cuda.synchronize()
            assert ok, (p, worst)
    finally:
        tuning.clear_cache()


def test_launch_records_within_budget_frames(cuda):
    """``cudaFuncGetAttributes`` and the launchers' dynamic shared memory
    at small shapes, each launch within a frame of its `vmem_model`
    check, which fits the h100 row."""
    from apex1_tpu_torch.core.capability import smem_budget
    from apex1_tpu_torch.ops import _build
    from apex1_tpu_torch.ops import fused_collective as fc
    from apex1_tpu_torch.ops import fused_dense as fd
    from apex1_tpu_torch.ops import lora_epilogue as le
    from apex1_tpu_torch.ops import quantized as q
    from apex1_tpu_torch.tuning.registry import SPECS
    g = torch.Generator(device="cuda").manual_seed(0)

    def rn(*s, dtype=torch.bfloat16):
        return torch.randn(*s, generator=g, device="cuda").to(dtype)

    wq, s = q.quantize_int8(rn(256, 512, dtype=torch.float32))
    pages = 1 + 3 * 4
    cases = [
        ("int8_matmul", dict(zip(("bm", "bt", "splits", "kc"),
                                 q.int8_plan(8, 256, 512))),
         {"N": 256, "K": 512, "Tb": 8}, 1,
         lambda: q.int8_mm(rn(8, 512), wq, s)),
        ("fused_swiglu", {"tile_n": fd.glu_tile(300, 1000,
                                                torch.bfloat16)[1]},
         {"Hp": 256, "Tb": 512}, 2,
         lambda: fd.glu_fwd(rn(300, 256), rn(256, 1000), rn(256, 1000))),
        ("fused_collective_matmul",
         dict(zip(("block_m", "block_n"),
                  fc.chunk_tile(512, 1024, torch.bfloat16))),
         {"Kp": 256}, 2, lambda: fc.chunk_matmul(rn(512, 256),
                                                 rn(256, 1024))),
        ("lora_epilogue", {"rows": le.lora_rows(8, 1000, 4, 132)},
         {"Hp": 128, "Vp": 1000, "R": 4}, 2,
         lambda: le.lora_delta(rn(8, 128), rn(pages, 128,
                                                dtype=torch.float32),
                               rn(pages, 1000, dtype=torch.float32),
                               torch.ones(8, 4, dtype=torch.int32,
                                          device="cuda"))),
    ]
    for check, blocks, dims, es, fn in cases:
        fits, est = SPECS[check].check(blocks, dims, es,
                                       smem_budget("h100"))
        with _build.launch_records() as rec:
            fn()
        torch.cuda.synchronize()
        assert fits and rec, check
        for r in rec:
            assert any(f.bounds(r) for f in est), (check, r, list(est))
