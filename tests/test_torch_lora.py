"""Multi-tenant LoRA pages (`serving.lora`, `ops.lora_epilogue`, TPU row
23) against the JAX package on the CPU.

- the adapter-page store: the cases of tests/test_lora_serving.py's
  store suite (refcounts through register, acquire, unregister and
  release; a duplicate register; A and B shapes; the zero row of an
  unknown or absent tenant; a slot acquired twice; pool exhaustion and
  the sizing invariant; an unknown unregister), and the pages (the
  scale folded into B) equal to JAX's store's bit for bit;
- `lora_delta` against JAX's ``_lora_delta_ref`` and its Pallas kernel
  in interpret mode within 1e-5, with rows naming only page 0 exactly
  0.0, in fp32 and bf16 hidden rows; each row equal to the same row
  computed alone, bit for bit; the geometry check raising on rank < 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex1_tpu.ops import _common as jax_common
from apex1_tpu.ops.lora_epilogue import _lora_delta_ref as jax_lora_ref
from apex1_tpu.ops.lora_epilogue import lora_delta as jax_lora_delta
from apex1_tpu.serving.lora import LoraAdapterStore as JaxStore
from apex1_tpu_torch.ops.lora_epilogue import check_lora_geometry, lora_delta
from apex1_tpu_torch.serving.lora import LoraAdapterStore


def _store(**kw):
    kws = dict(hidden=8, vocab=16, rank=2, max_adapters=2)
    kws.update(kw)
    return LoraAdapterStore(device="cpu", **kws)


def _ab(st, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(st.hidden, st.rank)),
            rng.normal(size=(st.rank, st.vocab)))


# ---- the store -------------------------------------------------------------


def test_register_acquire_release_refcounts():
    st = _store()
    pages = st.register("acme", *_ab(st))
    assert len(pages) == st.rank and 0 not in pages
    assert all(st.page_refcount(p) == 1 for p in pages)
    row, on = st.acquire("acme", slot=0)
    assert on and list(row) == list(pages) and row.dtype == np.int32
    _, on2 = st.acquire("acme", slot=1)
    assert on2 and all(st.page_refcount(p) == 3 for p in pages)
    st.unregister("acme")
    assert all(st.page_refcount(p) == 2 for p in pages)
    assert st.n_free == st.num_pages - 1 - st.rank
    st.release(0)
    st.release(1)
    assert all(st.page_refcount(p) == 0 for p in pages)
    assert st.n_free == st.num_pages - 1      # the zero page never frees


def test_duplicate_register_raises():
    st = _store()
    st.register("acme", *_ab(st))
    with pytest.raises(ValueError, match="already registered"):
        st.register("acme", *_ab(st))


def test_shape_validation():
    st = _store()
    A, B = _ab(st)
    with pytest.raises(ValueError, match="A shape"):
        st.register("x", A.T, B)
    with pytest.raises(ValueError, match="B shape"):
        st.register("x", A, B.T)


def test_unknown_or_none_adapter_is_zero_row():
    st = _store()
    for who in (None, "ghost"):
        row, on = st.acquire(who, slot=3)
        assert not on and not row.any()
    st.release(3)


def test_slot_double_acquire_raises():
    st = _store()
    st.register("acme", *_ab(st))
    st.acquire("acme", slot=0)
    with pytest.raises(ValueError, match="already holds"):
        st.acquire("acme", slot=0)


def test_pool_exhaustion_is_loud():
    st = _store(max_adapters=1)
    st.register("acme", *_ab(st))
    with pytest.raises(RuntimeError, match="out of pages"):
        st.register("zeta", *_ab(st))
    st.unregister("acme")
    st.register("zeta", *_ab(st))


def test_unregister_unknown_raises():
    with pytest.raises(KeyError, match="ghost"):
        _store().unregister("ghost")


def test_bad_sizes_raise():
    with pytest.raises(ValueError, match="rank"):
        _store(rank=0)
    with pytest.raises(ValueError, match="max_adapters"):
        _store(max_adapters=0)


@pytest.mark.parametrize("scale", [1.0, 4.0, 0.3])
def test_pages_equal_jax_store_bitwise(scale):
    """The scale / rank fold into B and the A rows: the same fp32 pages
    as JAX's store, page 0 zero."""
    kws = dict(hidden=8, vocab=16, rank=2, max_adapters=3)
    jst, st = JaxStore(**kws), _store(**kws)
    for name, seed in (("acme", 0), ("zeta", 5)):
        A, B = _ab(st, seed)
        assert jst.register(name, A, B, scale=scale) == \
            st.register(name, A, B, scale=scale)
    np.testing.assert_array_equal(st.a_pages.numpy(),
                                  np.asarray(jst.a_pages))
    np.testing.assert_array_equal(st.b_pages.numpy(),
                                  np.asarray(jst.b_pages))
    assert not st.a_pages[0].any() and not st.b_pages[0].any()


# ---- the delta ---------------------------------------------------------------


def _delta_operands(N, H, V, R, n_adapters, seed):
    rng = np.random.default_rng(seed)
    P = 1 + n_adapters * R
    a = rng.normal(size=(P, H)).astype(np.float32)
    b = rng.normal(size=(P, V)).astype(np.float32)
    a[0] = 0.0
    b[0] = 0.0
    h = rng.normal(size=(N, H)).astype(np.float32)
    bt = np.zeros((N, R), np.int32)
    for n in range(N - 1):               # the last row is adapterless
        j = n % n_adapters
        bt[n] = 1 + j * R + np.arange(R)
    return h, a, b, bt


@pytest.mark.parametrize("shape", [(4, 64, 384, 2), (5, 40, 300, 3),
                                   (3, 128, 1024, 8)])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_lora_delta_matches_jax(shape, impl):
    N, H, V, R = shape
    h, a, b, bt = _delta_operands(N, H, V, R, 2, seed=N + V)
    args = [jnp.asarray(t) for t in (h, a, b, bt)]
    with jax_common.force_impl(impl):
        want = np.asarray(jax_lora_delta(*args))
    got = lora_delta(*(torch.from_numpy(t) for t in (h, a, b, bt)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (N, V)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * scale)
    assert (got[-1] == 0).all() and (want[-1] == 0).all()


def test_lora_delta_bf16_rows_and_solo_rows():
    """bf16 hidden rows are read as fp32, as JAX's reference reads them;
    every row equals itself computed in a batch of its own."""
    h, a, b, bt = _delta_operands(6, 32, 256, 4, 3, seed=7)
    hb = torch.from_numpy(h).to(torch.bfloat16)
    pages = (torch.from_numpy(a), torch.from_numpy(b))
    got = lora_delta(hb, *pages, torch.from_numpy(bt))
    want = np.asarray(jax_lora_ref(jnp.asarray(hb.float().numpy(),
                                               jnp.bfloat16),
                                   jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(bt)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    for n in range(6):
        solo = lora_delta(hb[n:n + 1], *pages, torch.from_numpy(bt[n:n + 1]))
        assert torch.equal(solo[0], got[n]), n


def test_lora_geometry_is_loud():
    with pytest.raises(ValueError, match="rank=0"):
        check_lora_geometry(0, 64, 128)
    with pytest.raises(ValueError, match="shared memory"):
        check_lora_geometry(10 ** 6, 64, 128)
    assert check_lora_geometry(16, 2048, 32000) == 128
    h, a, b, _ = _delta_operands(2, 8, 16, 1, 1, seed=1)
    with pytest.raises(ValueError, match="rank=0"):
        lora_delta(torch.from_numpy(h), torch.from_numpy(a),
                   torch.from_numpy(b), torch.zeros(2, 0, dtype=torch.int32))


def test_store_defaults_to_cuda():
    """Without device=, the store asks for CUDA and raises where there
    is none (never a silent CPU run)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        LoraAdapterStore(hidden=8, vocab=16, rank=2, max_adapters=2)
