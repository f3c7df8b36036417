"""The port's host runtime (`apex1_tpu_torch.runtime`) against the JAX
package's (`apex1_tpu.runtime`) on the same numpy inputs, on the port's
native library and on its NumPy fallback (the library handle replaced
by None, as tests/test_runtime.py does for the JAX package): `flatten`
bytes (0-d arrays too, which the JAX package's fallback cannot view as
bytes), `unflatten`, `normalize_images` (native bits equal to JAX's
native, the fallback's to JAX's fallback, 1e-6 against NumPy's formula),
the bf16 bit casts (equal to JAX's, NaN payloads included, and to
``Tensor.to(torch.bfloat16)`` at every value but NaN, where torch picks
its own NaN bits), `TokenDataset` and
`ShardedTokenDataset` batches over two epochs, `pack_documents`; the
library's lazy build, its readable build error and its ABI gate; and
`PrefetchLoader` on the CPU (order, transform, errors, early stop, trees
of tensors, numpy with ``device_put=False``)."""

import subprocess
import threading
import time

import numpy as np
import pytest
import torch

import apex1_tpu.runtime as jrt
import apex1_tpu_torch.runtime as rt

MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


@pytest.fixture(params=["native", "native-threaded", "numpy"])
def mode(request, monkeypatch):
    """The port's native library (small calls on the calling thread, or
    every call on its host threads), or its NumPy fallback."""
    assert jrt.native_available()
    if request.param == "numpy":
        monkeypatch.setattr(rt, "_lib", lambda: None)
        return "numpy"
    assert rt.native_available(), rt.build_log()
    if request.param == "native-threaded":
        monkeypatch.setattr(rt, "_SERIAL_BYTES", 0)
    return "native"


def _arrays(rng):
    return [rng.normal(size=(4, 5)).astype(np.float32),
            rng.integers(0, 100, (7,)).astype(np.int32),
            rng.normal(size=(2, 3, 8)).astype(np.float64),
            np.asarray(3.5, np.float32),
            rng.normal(size=(6, 4)).astype(np.float32)[:, 1:3]]


def test_flatten_bytes_equal_jax_and_unflatten_round_trips(rng, mode):
    arrays = _arrays(rng)
    flat = rt.flatten(arrays)
    assert flat.dtype == np.uint8
    np.testing.assert_array_equal(flat, jrt.flatten(arrays))
    outs = rt.unflatten(flat, [(a.shape, a.dtype) for a in arrays])
    for a, b in zip(arrays, outs):
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(a, b)
    assert rt.flatten([]).size == 0 and rt.unflatten(flat[:0], []) == []
    with pytest.raises(ValueError, match="bytes"):
        rt.unflatten(flat, [((5,), np.float32)])


def test_normalize_images_equal_jax_and_numpy(rng, mode, monkeypatch):
    imgs = rng.integers(0, 256, (3, 9, 7, 3)).astype(np.uint8)
    got = rt.normalize_images(imgs, MEAN, STD)
    if mode == "numpy":   # JAX's fallback computes the same formula
        monkeypatch.setattr(jrt, "_LIB", None)
    assert got.dtype == np.float32 and got.shape == imgs.shape
    np.testing.assert_array_equal(got, jrt.normalize_images(imgs, MEAN, STD))
    want = ((imgs.astype(np.float32) / 255.0 - np.asarray(MEAN, np.float32))
            / np.asarray(STD, np.float32))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="channels"):
        rt.normalize_images(imgs, MEAN[:2], STD[:2])


def _bf16_cases(rng):
    x = np.concatenate([rng.normal(size=4096).astype(np.float32) * 100,
                        np.asarray([0.0, -0.0, np.inf, -np.inf, 1e-40,
                                    3.3895314e38, np.nan], np.float32)])
    # the halfway points round to even; odd payload NaNs stay NaN
    ties = (np.arange(1, 64, dtype=np.uint32) << 16) | 0x8000
    nans = np.asarray([0x7FFFFFFF, 0xFFFFFFFF, 0x7F800001, 0xFFC00000,
                       0x7FBFFFFF], np.uint32)
    return np.concatenate([x, ties.view(np.float32), nans.view(np.float32)])


def test_bf16_bits_equal_jax_and_torch(rng, mode):
    x = _bf16_cases(rng)
    bits = rt.f32_to_bf16_bits(x)
    np.testing.assert_array_equal(bits, jrt.f32_to_bf16_bits(x))
    # torch writes a NaN of its own choosing (0x7FC0 or 0xFFFF, by code
    # path): equal bits at every other value, a NaN (never ±0 or ±inf)
    # at every NaN, as torch's
    nan = np.isnan(x)
    want = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_array_equal(
        bits[~nan], want.view(torch.int16).numpy().view(np.uint16)[~nan])
    back = rt.bf16_bits_to_f32(bits)
    np.testing.assert_array_equal(back, jrt.bf16_bits_to_f32(bits))
    np.testing.assert_array_equal(np.isnan(back), nan)
    np.testing.assert_array_equal(back[~nan], want.float().numpy()[~nan])


def _token_file(tmp_path, n, dtype, name="toks.bin"):
    rng = np.random.default_rng(7)
    toks = rng.integers(0, min(np.iinfo(dtype).max, 60000), n).astype(dtype)
    path = str(tmp_path / name)
    rt.write_token_file(path, toks)
    return path, toks


@pytest.mark.parametrize("dtype", [np.uint16, np.int32])
@pytest.mark.parametrize("shuffle,seed", [(True, 3), (False, 0),
                                          (True, -5)])
def test_token_dataset_equals_jax_over_two_epochs(tmp_path, mode, dtype,
                                                  shuffle, seed):
    path, toks = _token_file(tmp_path, 997, dtype)
    kw = dict(seq_len=17, batch_size=5, dtype=dtype, seed=seed,
              shuffle=shuffle)
    with rt.TokenDataset(path, **kw) as ds, jrt.TokenDataset(path, **kw) as js:
        assert ds.native == (mode == "native")
        assert ds.num_sequences == js.num_sequences == 997 // 17
        steps = 2 * ds.num_sequences // ds.batch_size + 1
        for step in range(steps):
            np.testing.assert_array_equal(ds.batch_at(step),
                                          js.batch_at(step))
        np.testing.assert_array_equal(ds.fetch(3), toks[51:68])
        it = ds.iter_from(4)
        np.testing.assert_array_equal(next(it), js.batch_at(4))
        with pytest.raises(ValueError):
            ds.batch_at(-1)
        with pytest.raises(IndexError):
            ds.fetch(ds.num_sequences)
    with pytest.raises(RuntimeError, match="closed"):
        ds.batch_at(0)
    with pytest.raises(ValueError, match="2 or 4 bytes"):
        rt.TokenDataset(path, seq_len=4, batch_size=1, dtype=np.int8)


def test_sharded_token_dataset_equals_jax(tmp_path, mode):
    paths = [_token_file(tmp_path, n, np.uint16, f"s{i}.bin")[0]
             for i, n in enumerate((301, 170, 455))]
    kw = dict(seq_len=16, batch_size=6, seed=11)
    ds, js = rt.ShardedTokenDataset(paths, **kw), jrt.ShardedTokenDataset(
        paths, **kw)
    try:
        assert ds.num_sequences == js.num_sequences
        assert ds.native == (mode == "native")
        for step in range(2 * ds.steps_per_epoch() + 1):
            np.testing.assert_array_equal(ds.batch_at(step),
                                          js.batch_at(step))
    finally:
        ds.close()
        js.close()
    with pytest.raises(ValueError, match="shard"):
        rt.ShardedTokenDataset([], **kw)


@pytest.mark.parametrize("restart", [False, True])
def test_pack_documents_native_equals_python_equals_jax(rng, monkeypatch,
                                                        restart):
    docs = [rng.integers(0, 500, int(n)) for n in rng.integers(1, 90, 40)]
    native = rt.pack_documents(docs, 32, pad_id=7,
                               restart_chunk_positions=restart)
    want = jrt.pack_documents(docs, 32, pad_id=7,
                              restart_chunk_positions=restart)
    monkeypatch.setattr(rt, "_lib", lambda: None)
    python = rt.pack_documents(docs, 32, pad_id=7,
                               restart_chunk_positions=restart)
    for a, b, c in zip(native, python, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
    with pytest.raises(ValueError, match="positive"):
        rt.pack_documents(docs, 0)


def test_library_builds_at_first_use_under_build(monkeypatch, tmp_path):
    """The library is built into a digest-named file under the given
    build directory on first use, not before; a failing g++ leaves the
    NumPy fallback and a readable log; a library of another ABI is not
    used."""
    monkeypatch.setitem(rt._STATE, "lib", rt._UNSET)
    monkeypatch.setattr(rt, "_BUILD", tmp_path / "build")
    assert not (tmp_path / "build").exists()
    assert rt.native_available()
    built = list((tmp_path / "build").iterdir())
    assert [p.name for p in built] == [rt._library_path().name]
    assert built[0].name.startswith("libapex1_runtime_")

    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setitem(rt._STATE, "lib", rt._UNSET)
    monkeypatch.setattr(rt, "_SRC", bad)
    assert not rt.native_available()
    assert "error" in rt.build_log()
    assert not [p for p in (tmp_path / "build").iterdir()
                if p.name.endswith(".tmp")]
    x = np.linspace(-2, 2, 9, dtype=np.float32)
    np.testing.assert_array_equal(rt.f32_to_bf16_bits(x),
                                  jrt.f32_to_bf16_bits(x))

    old = tmp_path / "old.cpp"
    old.write_text('extern "C" int apex1_runtime_abi_version() '
                   '{ return 3; }\n')
    lib = tmp_path / "libold.so"
    subprocess.run(["g++", "-shared", "-fPIC", str(old), "-o", str(lib)],
                   check=True)
    assert rt._load(lib) is None
    assert "ABI" in rt.build_log()


def test_prefetch_loader_order_transform_and_cpu_trees(rng):
    batches = [{"x": rng.normal(size=(2, 3)).astype(np.float32),
                "y": (np.arange(4), 7), "name": "b"} for _ in range(5)]
    loader = rt.PrefetchLoader(
        iter(batches), transform=lambda b: {**b, "x": b["x"] * 2},
        prefetch=2, device="cpu")
    got = list(loader)
    assert len(got) == 5
    for g, b in zip(got, batches):
        assert isinstance(g["x"], torch.Tensor) and g["x"].device.type == \
            "cpu"
        np.testing.assert_array_equal(g["x"].numpy(), b["x"] * 2)
        assert isinstance(g["y"], tuple) and g["y"][1] == 7
        np.testing.assert_array_equal(g["y"][0].numpy(), b["y"][0])
        assert g["name"] == "b"
    bare = list(rt.PrefetchLoader(iter([np.ones(3), np.zeros(2)]),
                                  device="cpu"))
    assert [t.tolist() for t in bare] == [[1.0] * 3, [0.0] * 2]
    raw = list(rt.PrefetchLoader(iter(batches), device_put=False,
                                 transform=lambda b: b["x"]))
    assert all(isinstance(r, np.ndarray) for r in raw)
    np.testing.assert_array_equal(raw[3], batches[3]["x"])


def test_prefetch_loader_propagates_errors():
    def gen():
        yield np.zeros(2)
        raise RuntimeError("source broke")

    with pytest.raises(RuntimeError, match="source broke"):
        list(rt.PrefetchLoader(gen(), device="cpu"))
    with pytest.raises(ZeroDivisionError):
        list(rt.PrefetchLoader(iter([np.ones(1)]), device_put=False,
                               transform=lambda b: 1 / 0))


def test_prefetch_loader_early_stop_leaves_no_worker(tmp_path):
    path, _ = _token_file(tmp_path, 4000, np.uint16)
    n_before = threading.active_count()
    with rt.TokenDataset(path, seq_len=9, batch_size=4) as ds:
        it = iter(rt.PrefetchLoader(ds.iter_from(0), prefetch=1,
                                    device="cpu"))
        first = next(it)
        it.close()   # stops the worker before the mmap goes away
        np.testing.assert_array_equal(first.numpy(), ds.batch_at(0))
    deadline = time.time() + 5
    while threading.active_count() > n_before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= n_before


def test_prefetch_loader_needs_cuda_by_default():
    if torch.cuda.is_available():
        assert rt.PrefetchLoader(iter([])).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            rt.PrefetchLoader(iter([]))
    assert rt.PrefetchLoader(iter([]), device_put=False).device is None
