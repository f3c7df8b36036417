"""`apex1_tpu_torch.ops.paged_decode` against `apex1_tpu.ops.paged_decode`.

The threefry stream, the key derivation and the sampled token ids must
equal the JAX package's bit for bit (the per-request counter-PRNG
contract); page plumbing exactly; the paged attention within 1e-5 (f32)
and 1e-2 (bf16). Inputs are made with numpy from a seed and handed to
both packages. The CUDA kernels are held against the plain versions on
the card (tests/test_torch_kernels_gpu.py and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex1_tpu.ops import _common as jax_common
from apex1_tpu.ops import paged_decode as jpd
from apex1_tpu_torch.ops import force_impl
from apex1_tpu_torch.core.random import threefry2x32
from apex1_tpu_torch.ops import paged_decode as tpd


def _threefry_mode(partitionable):
    prev = bool(jax.config.jax_threefry_partitionable)
    jax.config.update("jax_threefry_partitionable", partitionable)
    return prev


# ---------------------------------------------------------------------------
# the threefry stream
# ---------------------------------------------------------------------------


def test_threefry_block_bitwise():
    rng = np.random.default_rng(0)
    k1, k2, x0, x1 = (rng.integers(0, 2**32, 64, dtype=np.uint64)
                      .astype(np.uint32) for _ in range(4))
    want = jpd._threefry2x32(*(jnp.asarray(a) for a in (k1, k2, x0, x1)))
    got = threefry2x32(*(torch.from_numpy(a.astype(np.int64))
                              for a in (k1, k2, x0, x1)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w, np.int64))


@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("n", [7, 257])
def test_uniform_bits_bitwise_vs_jax_random(n, partitionable):
    """Both streams, odd counts included (the original stream's
    zero-padded pair partner)."""
    key = jax.random.fold_in(jax.random.key(123), 7)
    k1, k2 = (int(x) for x in jax.random.key_data(key))
    got = tpd._uniform_bits(k1, k2, torch.arange(n), n,
                            partitionable=partitionable)
    prev = _threefry_mode(partitionable)
    try:
        want = np.asarray(jax.random.bits(key, (n,), jnp.uint32))
        mine_jax = np.asarray(jpd._uniform_bits(
            jnp.uint32(k1), jnp.uint32(k2), jnp.arange(n), n,
            partitionable=partitionable))
    finally:
        jax.config.update("jax_threefry_partitionable", prev)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(mine_jax, want)


def test_row_keys_bitwise_vs_fold_in():
    """fold_in(key(seed), pos) derived in integer ops, seeds at both
    ends of the int31 range."""
    seeds = np.asarray([0, 0, 1, 123, 2**31 - 1, 2**31 - 1], np.int32)
    pos = np.asarray([0, 5, 1, 4096, 0, 77], np.int32)
    k1, k2 = tpd._row_keys(torch.from_numpy(seeds), torch.from_numpy(pos))
    for i, (s, p) in enumerate(zip(seeds, pos)):
        want = np.asarray(jax.random.key_data(
            jax.random.fold_in(jax.random.key(int(s)), int(p))))
        assert (int(k1[i]), int(k2[i])) == (int(want[0]), int(want[1]))


def test_gumbel_matches_jax_random():
    """The gumbel transform of the shared bits. The two frameworks' log
    implementations may differ in the last ulp, hence rtol 1e-6; the
    sampled ids are pinned exactly below."""
    key = jax.random.fold_in(jax.random.key(9), 3)
    k1, k2 = (int(x) for x in jax.random.key_data(key))
    got = tpd._bits_to_gumbel(tpd._uniform_bits(k1, k2, torch.arange(129),
                                                129))
    want = np.asarray(jax.random.gumbel(key, (129,), jnp.float32))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.3])
@pytest.mark.parametrize("top_k", [None, 5])
def test_fused_sample_token_ids_bitwise(temperature, top_k):
    rng = np.random.default_rng(4)
    lg = rng.standard_normal((6, 200)).astype(np.float32)
    seeds = np.asarray([1, 2, 3, 2, 0, 2**31 - 1], np.int32)
    pos = np.asarray([5, 0, 1, 7, 0, 300], np.int32)
    kw = dict(temperature=temperature, top_k=top_k, vocab_size=180)
    with jax_common.force_impl("xla"):
        want = np.asarray(jpd.fused_sample(jnp.asarray(lg), seeds, pos,
                                           **kw))
    got = tpd.fused_sample(torch.from_numpy(lg), torch.from_numpy(seeds),
                           torch.from_numpy(pos), **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_sample_token_bitwise_vs_categorical():
    """sample_token over a (B, V) block with ONE key draws over the flat
    B*V counter, as jax.random.categorical does."""
    rng = np.random.default_rng(7)
    lg = rng.standard_normal((3, 64)).astype(np.float32)
    key = jax.random.fold_in(jax.random.key(5), 11)
    want = np.asarray(jpd.sample_token(jnp.asarray(lg), key,
                                       temperature=0.9, vocab_size=60))
    kd = [int(x) for x in jax.random.key_data(key)]
    got = tpd.sample_token(torch.from_numpy(lg), kd, temperature=0.9,
                           vocab_size=60)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# page plumbing and attention
# ---------------------------------------------------------------------------


def test_scatter_gather_pages_exact():
    """A write window that straddles page boundaries at unaligned
    starts, against the JAX scatter/gather."""
    rng = np.random.default_rng(1)
    pages = rng.standard_normal((9, 2, 4, 8)).astype(np.float32)
    bt = np.asarray([[3, 1, 7], [2, 8, 5]], np.int32)
    vals = rng.standard_normal((2, 2, 6, 8)).astype(np.float32)
    start = np.asarray([3, 1], np.int32)
    want = jpd.scatter_pages(jnp.asarray(pages), jnp.asarray(bt),
                             jnp.asarray(vals), jnp.asarray(start))
    got = tpd.scatter_pages(torch.from_numpy(pages.copy()),
                            torch.from_numpy(bt), torch.from_numpy(vals),
                            torch.from_numpy(start))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tpd.gather_pages(got, torch.from_numpy(bt), 11).numpy(),
        np.asarray(jpd.gather_pages(want, jnp.asarray(bt), 11)))


def _attend_case(page_dtype, s, seed=2):
    """N=3 ragged rows, Hq=4 over Hkv=2 (GQA group 2), D=16, pages of 8
    through a permuted block table."""
    rng = np.random.default_rng(seed)
    n_pages, hkv, P, D = 10, 2, 8, 16
    raw = rng.standard_normal((2, n_pages, hkv, P, D))
    if page_dtype == "int8":
        kv = np.clip(np.round(raw * 30.0), -127, 127).astype(np.int8)
    else:
        kv = raw.astype(np.float32)
    q = rng.standard_normal((3, 4, s, D)).astype(np.float32)
    bt = np.asarray([[5, 2, 6], [1, 4, 3], [9, 7, 8]], np.int32)
    lengths = np.asarray([17, 6, 0], np.int32)
    return q, kv[0], kv[1], bt, lengths


@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("page_dtype", ["float32", "bfloat16", "int8"])
def test_paged_attend_matches_jax(page_dtype, s):
    q, kp, vp, bt, lengths = _attend_case(page_dtype, s)
    q_dt = "bfloat16" if page_dtype == "bfloat16" else "float32"
    jq = jnp.asarray(q).astype(getattr(jnp, q_dt))
    jk = jnp.asarray(kp).astype(getattr(jnp, page_dtype))
    jv = jnp.asarray(vp).astype(getattr(jnp, page_dtype))
    with jax_common.force_impl("xla"):
        want = jpd.paged_attend(jq, jk, jv, jnp.asarray(bt),
                                jnp.asarray(lengths), total_len=24)
    want = np.asarray(want.astype(jnp.float32))
    tq = torch.from_numpy(q).to(getattr(torch, q_dt))
    tk = torch.from_numpy(kp).to(getattr(torch, page_dtype))
    tv = torch.from_numpy(vp).to(getattr(torch, page_dtype))
    got = tpd.paged_attend(tq, tk, tv, torch.from_numpy(bt),
                           torch.from_numpy(lengths), total_len=24)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    got = got.float().numpy()
    if page_dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)
    else:
        # int8 pages reach |v| ~ 127: the tolerance scales with the
        # output's magnitude, as the JAX suite's int8 case does
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(want).max()))


def test_paged_update_attend_writes_then_attends():
    """Scatter + attend through a PagedCache (updated in place) equals
    the JAX functional update."""
    q, kp, vp, bt, _ = _attend_case("float32", 1, seed=8)
    rng = np.random.default_rng(9)
    k_new = rng.standard_normal((3, 2, 1, 16)).astype(np.float32)
    v_new = rng.standard_normal((3, 2, 1, 16)).astype(np.float32)
    idx = np.asarray([7, 2, 20], np.int32)
    want, new_pc = jpd.paged_update_attend(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
        jpd.PagedCache(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
                       24), jnp.asarray(idx))
    pc = tpd.PagedCache(torch.from_numpy(kp.copy()),
                        torch.from_numpy(vp.copy()), torch.from_numpy(bt),
                        24)
    got, pc2 = tpd.paged_update_attend(
        torch.from_numpy(q), torch.from_numpy(k_new),
        torch.from_numpy(v_new), pc, torch.from_numpy(idx))
    assert pc2 is pc
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(pc.k_pages.numpy(),
                                  np.asarray(new_pc.k_pages))


def test_kernel_impl_refuses_cpu_tensors():
    q, kp, vp, bt, lengths = _attend_case("float32", 1)
    with force_impl("kernel"), pytest.raises(RuntimeError, match="CUDA"):
        tpd.paged_attend(torch.from_numpy(q), torch.from_numpy(kp),
                         torch.from_numpy(vp), torch.from_numpy(bt),
                         torch.from_numpy(lengths))
