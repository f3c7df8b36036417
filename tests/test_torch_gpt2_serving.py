"""The port's serving slice as a whole: GPT-2 through the paged engine.

Tiny GPT-2 at O0 with the JAX package's parameters (converted by
`apex1_tpu_torch.interop`): the cached forward's logits within 1e-5 of
JAX ``gpt2_decoder``, and the port's ``Engine(device="cpu")`` emitting
token streams identical to the JAX ``Engine(paged=True)`` on the same
params and workload, greedy and sampled, with and without radix prefix
hits. Plus the package rules: entry points default to CUDA, and the
port never imports JAX or the JAX package.
"""

import ast
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex1_tpu.core.policy import get_policy as jax_get_policy
from apex1_tpu.models.generate import gpt2_decoder as jax_gpt2_decoder
from apex1_tpu.models.gpt2 import GPT2 as JaxGPT2
from apex1_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from apex1_tpu.serving import Engine as JaxEngine
from apex1_tpu.serving import EngineConfig as JaxEngineConfig
from apex1_tpu.serving import PagedKVPool as JaxPagedKVPool
from apex1_tpu_torch import (GPT2, Engine, EngineConfig, GPT2Config,
                             get_policy, gpt2_decoder, gpt2_params_from_jax,
                             ops)
from apex1_tpu_torch.interop import gpt2_params_to_numpy
from apex1_tpu_torch.ops.paged_decode import PagedCache
from apex1_tpu_torch.serving import PagedKVPool

_REPO = pathlib.Path(__file__).resolve().parent.parent
_PORT = _REPO / "apex1_tpu_torch"


@pytest.fixture(scope="module")
def tiny():
    """The JAX paged-parity suite's tiny GPT-2, in both packages."""
    jcfg = JaxGPT2Config.tiny(policy=jax_get_policy("O0"), max_seq_len=64)
    rng = np.random.default_rng(11)
    base = rng.integers(1, jcfg.vocab_size, size=(12,)).astype(np.int32)
    jparams = JaxGPT2(jcfg).init(jax.random.key(0),
                                 jnp.asarray(base[None]))["params"]
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tcfg = GPT2Config.tiny(policy=get_policy("O0"), max_seq_len=64)
    model = gpt2_params_from_jax(np_params, tcfg, device="cpu")
    return dict(jcfg=jcfg, jparams=jparams, np_params=np_params, tcfg=tcfg,
                model=model, base=base)


def test_params_round_trip(tiny):
    back = gpt2_params_to_numpy(tiny["model"])
    flat_in = jax.tree_util.tree_leaves_with_path(tiny["np_params"])
    flat_out = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_in) == len(flat_out)
    for path, leaf in flat_in:
        np.testing.assert_array_equal(flat_out[path], leaf)


def test_cached_forward_logits_match_jax(tiny):
    """A prefill chunk at index 0 then a decode step, dense cache."""
    japply, jmake = jax_gpt2_decoder(JaxGPT2(tiny["jcfg"]))
    tapply, tmake = gpt2_decoder(tiny["model"])
    toks = tiny["base"][None, :6]
    jl0, jc = japply(tiny["jparams"], jnp.asarray(toks), jmake(1, 16), 0,
                     chunk_decode=True)
    tl0, tc = tapply(torch.from_numpy(toks), tmake(1, 16), 0,
                     chunk_decode=True)
    np.testing.assert_allclose(tl0.numpy(), np.asarray(jl0), rtol=1e-5,
                               atol=1e-5)
    nxt = tiny["base"][None, 6:7]
    jl1, _ = japply(tiny["jparams"], jnp.asarray(nxt), jc, 6)
    tl1, _ = tapply(torch.from_numpy(nxt), tc, 6)
    assert tl1.dtype == torch.float32
    assert tl1.shape == (1, 1, tiny["tcfg"].padded_vocab)
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), rtol=1e-5,
                               atol=1e-5)


def test_hidden_and_last_real_logits_match_jax(tiny):
    """``return_hidden`` (the pre-head states) and `last_real_logits`
    (the right-padded chunk's per-row gather)."""
    from apex1_tpu.models.generate import \
        last_real_logits as jax_last_real_logits
    from apex1_tpu_torch.models.generate import last_real_logits
    japply, jmake = jax_gpt2_decoder(JaxGPT2(tiny["jcfg"]))
    tapply, tmake = gpt2_decoder(tiny["model"])
    toks = np.stack([tiny["base"][:5], tiny["base"][3:8]])
    jh, _ = japply(tiny["jparams"], jnp.asarray(toks), jmake(2, 8), 0,
                   chunk_decode=True, return_hidden=True)
    th, _ = tapply(torch.from_numpy(toks), tmake(2, 8), 0,
                   chunk_decode=True, return_hidden=True)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)
    lens = np.asarray([5, 2], np.int32)
    np.testing.assert_array_equal(
        last_real_logits(th, torch.from_numpy(lens)).numpy(),
        np.asarray(jax_last_real_logits(jnp.asarray(th.numpy()), lens)))


def test_paged_cache_forward_matches_dense(tiny):
    """The same chunk through PagedCache entries (permuted pages) gives
    the dense cache's logits."""
    tapply, tmake = gpt2_decoder(tiny["model"])
    toks = torch.from_numpy(tiny["base"][None, :6])
    dense, _ = tapply(toks, tmake(1, 16), 0, chunk_decode=True)
    pool = tmake(5, 8)
    bt = torch.tensor([[3, 1]], dtype=torch.int32)
    cache = {k: PagedCache(e["k"], e["v"], bt, 16) for k, e in pool.items()}
    paged, _ = tapply(toks, cache, 0, chunk_decode=True)
    np.testing.assert_allclose(paged.numpy(), dense.numpy(), rtol=1e-6,
                               atol=1e-6)


def _pool_script(pool):
    """Alloc, register, share, free and evict through a 2-slot pool of
    4-page lanes; returns the observable state after each operation."""
    states = []

    def snap():
        states.append((
            [list(r) for r in pool.block_tables],
            [pool.page_refcount(p) for p in range(pool.num_pages)],
            pool.n_free_pages, sorted(pool.prefix_stats().items())))

    a = pool.alloc()
    snap()
    pool.register_prefix(a, (101, 102), 9)        # floors to 2 pages
    pool.acquire_prefix((101, 102), a)            # donor: no-op rewire
    snap()
    b = pool.alloc()
    pool.acquire_prefix((101, 102), b)            # sharer: by page id
    snap()
    pool.free(a)
    snap()
    pool.free(b)
    snap()
    assert pool.evict_prefix((101, 102))
    snap()
    return states


def test_paged_pool_matches_jax():
    """The port's page allocator and prefix store walk the same states
    as the JAX package's on the same operations."""
    def jax_cache(n, s, dtype=None):
        z = jnp.zeros((n, 2, s, 4), jnp.float32)
        return {"layer0": {"k": z, "v": z}}

    def torch_cache(n, s, dtype=None):
        z = torch.zeros((n, 2, s, 4))
        return {"layer0": {"k": z, "v": z.clone()}}

    kw = dict(max_slots=2, lane_len=16, page_size=4)
    want = _pool_script(JaxPagedKVPool(jax_cache, **kw))
    assert _pool_script(PagedKVPool(torch_cache, **kw)) == want


def _jax_engine(tiny, **kw):
    jcfg = tiny["jcfg"]
    apply_fn, make_cache = jax_gpt2_decoder(JaxGPT2(jcfg))
    ekw = dict(max_slots=3, max_len=48, prefill_chunk=4,
               vocab_size=jcfg.vocab_size, paged=True)
    ekw.update(kw)
    return JaxEngine(apply_fn, make_cache, tiny["jparams"],
                     JaxEngineConfig(**ekw))


def _port_engine(tiny, **kw):
    apply_fn, make_cache = gpt2_decoder(tiny["model"])
    ekw = dict(max_slots=3, max_len=48, prefill_chunk=4,
               vocab_size=tiny["tcfg"].vocab_size, paged=True)
    ekw.update(kw)
    return Engine(apply_fn, make_cache, EngineConfig(**ekw), device="cpu")


def _run_workload(eng, base):
    """More requests than slots, prompts crossing chunk boundaries,
    staggered joins: the JAX paged suite's acceptance workload."""
    lens, news, seeds = [3, 7, 5, 9], (6, 5, 7, 4), (5, 9, 2, 7)
    ids = [eng.submit(base[:lens[i]], max_new_tokens=news[i],
                      seed=seeds[i]) for i in range(3)]
    eng.step()
    ids.append(eng.submit(base[:lens[3]], max_new_tokens=news[3],
                          seed=seeds[3]))
    eng.run(max_steps=200)
    return [[int(t) for t in eng.results[r].tokens] for r in ids]


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_engine_tokens_identical_to_jax(tiny, temperature):
    want = _run_workload(_jax_engine(tiny, temperature=temperature),
                         tiny["base"])
    eng = _port_engine(tiny, temperature=temperature)
    got = _run_workload(eng, tiny["base"])
    assert got == want
    assert all(r.status == "done" for r in eng.results.values())
    assert eng.metrics.summary()["done"] == 4


def test_radix_prefix_hits_identical_to_jax(tiny):
    """Three requests sharing a 10-token prefix through two slots: the
    port registers page-aligned shared pages, serves hits by page id,
    and matches the JAX engine token for token."""
    base = tiny["base"]

    def run(eng):
        rids = [eng.submit(np.concatenate([base[:10],
                                           np.asarray([3 + i], np.int32)]),
                           max_new_tokens=6, seed=50 + i) for i in range(3)]
        eng.run(max_steps=300)
        return [[int(t) for t in eng.results[r].tokens] for r in rids]

    want = run(_jax_engine(tiny, max_slots=2, temperature=0.7))
    eng = _port_engine(tiny, max_slots=2, temperature=0.7)
    assert run(eng) == want
    stats = eng.kv.prefix_stats()
    assert any(v["hits"] >= 2 and v["pages"] for v in stats.values()), stats
    assert eng.metrics.summary()["prefix_hit_rate"] > 0


def test_launch_counters_count_only_kernel_launches(tiny):
    """Every kernel wrapper keeps a plain-int launch count; the plain
    versions the CPU runs never bump it."""
    ops.reset_launches()
    assert ops.launch_counts() == {name: 0 for name in ops.KERNEL_WRAPPERS}
    _run_workload(_port_engine(tiny, temperature=0.7), tiny["base"])
    assert ops.launch_counts() == {name: 0 for name in ops.KERNEL_WRAPPERS}


def test_eos_readback_path_matches_deferred(tiny):
    """With an eos_id the engine reads each step's tokens back; with
    an eos_id no token ever equals, the streams equal the deferred
    log's."""
    deferred = _run_workload(_port_engine(tiny, temperature=0.7),
                             tiny["base"])
    eager = _run_workload(_port_engine(tiny, temperature=0.7, eos_id=10**6),
                          tiny["base"])
    assert eager == deferred


@pytest.mark.parametrize("kw", [dict(paged=False), dict(num_draft=2),
                                dict(lora_rank=4)],
                         ids=["dense", "spec", "lora"])
def test_unported_options_raise(tiny, kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _port_engine(tiny, **kw)


@pytest.mark.parametrize("make", ["engine", "model", "converter"])
def test_entry_points_default_to_cuda(tiny, make):
    """Without device=, the entry points ask for CUDA, and raise where
    there is none (never a silent CPU run)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        if make == "engine":
            apply_fn, make_cache = gpt2_decoder(tiny["model"])
            Engine(apply_fn, make_cache, EngineConfig(paged=True))
        elif make == "model":
            GPT2(tiny["tcfg"])
        else:
            gpt2_params_from_jax(tiny["np_params"], tiny["tcfg"])


def test_import_pulls_in_no_jax():
    code = ("import sys, apex1_tpu_torch, apex1_tpu_torch.serving, "
            "apex1_tpu_torch.interop\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'flax', 'apex1_tpu.')) or "
            "m == 'apex1_tpu']\n"
            "print(bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_port_module_imports_jax():
    """AST scan of every module of the port and of chip_smoke.py."""
    files = sorted(_PORT.rglob("*.py")) + [_REPO / "chip_smoke.py"]
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "apex1_tpu"), (
                    f"{path.relative_to(_REPO)} imports {name}")
