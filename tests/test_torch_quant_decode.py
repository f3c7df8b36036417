"""Int8 weight-only decode (`models.quant_decode`) against the JAX package
on the CPU, on the tiny Llama (vocab 97, GQA 4/2) and GPT-2 from JAX's
params (`interop.llama_params_from_jax` / `gpt2_params_from_jax`):

- the quantized trees equal JAX's bit for bit (O0 and O2), and
  `interop.quant_params_from_jax` carries JAX's tree into the port's
  own quantization bit for bit;
- the prefill and chunk-decode logits against JAX's
  ``llama_quant_decoder`` / ``gpt2_quant_decoder`` within 1e-5 at O0
  and the bf16 rule (2e-2) at O2;
- with weights made exactly representable (q · 2^-9, each channel
  reaching |q| = 127), `generate` streams equal JAX's int8 streams and
  the full-precision model's, greedy; the paged engine over the int8
  decoder equals JAX's paged engine over JAX's;
- an MoE config asks for the MoE weights (its decode is held against
  JAX in tests/test_torch_moe.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex1_tpu.core.policy import get_policy as jax_get_policy
from apex1_tpu.models.generate import generate as jax_generate
from apex1_tpu.models.generate import llama_decoder as jax_llama_decoder
from apex1_tpu.models.gpt2 import GPT2 as JaxGPT2
from apex1_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from apex1_tpu.models.llama import Llama as JaxLlama
from apex1_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from apex1_tpu.models.quant_decode import \
    gpt2_quant_decoder as jax_gpt2_quant_decoder
from apex1_tpu.models.quant_decode import \
    llama_quant_decoder as jax_llama_quant_decoder
from apex1_tpu.ops import _common as jax_common
from apex1_tpu.serving import Engine as JaxEngine
from apex1_tpu.serving import EngineConfig as JaxEngineConfig
from apex1_tpu_torch import (Engine, EngineConfig, GPT2Config, LlamaConfig,
                             get_policy, gpt2_decoder, gpt2_params_from_jax,
                             llama_decoder, llama_params_from_jax,
                             quant_params_from_jax)
from apex1_tpu_torch.models.generate import generate
from apex1_tpu_torch.models.llama import Llama
from apex1_tpu_torch.models.quant_decode import (gpt2_quant_decoder,
                                                 llama_quant_decoder,
                                                 quantize_llama_params)

VOCAB = 97
_PROJ = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "output")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _representable(tree, names, out_axis, seed):
    """Every matmul weight replaced by q · 2^-9 (int8 and bf16 hold it
    exactly) with each output channel reaching |q| = 127, so
    quantization is lossless."""
    rng = np.random.default_rng(seed)

    def fix(path, p):
        name = path[-1].key
        if name not in names:
            return p
        q = rng.integers(-127, 128, size=p.shape)
        axis = out_axis(name)
        idx = [slice(None)] * q.ndim
        idx[1 - axis] = 0
        q[tuple(idx)] = 127
        return jnp.asarray(q * 2.0 ** -9, jnp.float32)

    return jax.tree_util.tree_map_with_path(fix, tree)


@pytest.fixture(scope="module")
def llama():
    jcfg = JaxLlamaConfig.tiny(vocab_size=VOCAB, max_seq_len=64,
                               policy=jax_get_policy("O0"))
    prompt = np.random.default_rng(5).integers(0, VOCAB, (2, 5)).astype(
        np.int32)
    params = JaxLlama(jcfg).init(jax.random.key(0),
                                 jnp.asarray(prompt))["params"]
    exact = _representable(params, _PROJ,
                           lambda n: 0 if n == "output" else 1, seed=7)
    return dict(params=params, exact=exact, prompt=prompt)


def _llama_pair(llama, level, key="params"):
    jcfg = JaxLlamaConfig.tiny(vocab_size=VOCAB, max_seq_len=64,
                               policy=jax_get_policy(level))
    tcfg = LlamaConfig.tiny(vocab_size=VOCAB, max_seq_len=64,
                            policy=get_policy(level))
    params = llama[key]
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return (JaxLlama(jcfg), params,
            llama_params_from_jax(np_params, tcfg, "cpu"))


@pytest.mark.parametrize("level", ["O0", "O2"])
def test_llama_quantized_tree_bitwise(llama, level):
    jmodel, params, model = _llama_pair(llama, level)
    _, _, jq = jax_llama_quant_decoder(jmodel, params)
    _, _, tq = llama_quant_decoder(model)
    want, got = _flat(jax.tree_util.tree_map(np.asarray, jq)), _flat(tq)
    assert sorted(want) == sorted(got)
    for k in want:
        assert str(got[k].dtype).split(".")[-1] == want[k].dtype.name, k
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]), err_msg=k)
    # JAX's tree carried across reproduces the port's own quantization
    carried = _flat(quant_params_from_jax(jq, device="cpu"))
    for k in got:
        assert carried[k].dtype == got[k].dtype, k
        assert torch.equal(carried[k], got[k]), k


@pytest.mark.parametrize("level,tol", [("O0", 1e-5), ("O2", 2e-2)])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_llama_quant_logits_match_jax(llama, level, tol, impl):
    """The flash prefill of 5 tokens at index 0, then a 3-token chunk
    decode at index 5."""
    jmodel, params, model = _llama_pair(llama, level)
    prompt = llama["prompt"]
    chunk = np.asarray([[3, 1, 4], [1, 5, 9]], np.int32)
    with jax_common.force_impl(impl):
        japply, jmake, jq = jax_llama_quant_decoder(jmodel, params)
        jcache = jmake(2, 16)
        want0, jcache = japply(jq, jnp.asarray(prompt), jcache, 0)
        want1, _ = japply(jq, jnp.asarray(chunk), jcache, 5,
                          chunk_decode=True)
    apply_fn, make_cache, _ = llama_quant_decoder(model)
    cache = make_cache(2, 16)
    got0, cache = apply_fn(torch.from_numpy(prompt), cache, 0)
    got1, _ = apply_fn(torch.from_numpy(chunk), cache, 5, chunk_decode=True)
    for got, want in ((got0, want0), (got1, want1)):
        want = np.asarray(want)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=tol,
                                   atol=tol * np.abs(want).max())


def test_llama_generate_streams_equal_jax_and_full_precision(llama):
    jmodel, exact, model = _llama_pair(llama, "O0", key="exact")
    prompt = llama["prompt"]
    japply, jmake, jq = jax_llama_quant_decoder(jmodel, exact)
    want = np.asarray(jax_generate(japply, jq, jnp.asarray(prompt),
                                   max_new_tokens=8, cache=jmake(2, 13)))
    apply_fn, make_cache, _ = llama_quant_decoder(model)
    got = generate(apply_fn, torch.from_numpy(prompt), max_new_tokens=8,
                   cache=make_cache(2, 13)).numpy()
    np.testing.assert_array_equal(got, want)
    fapply, fmake = llama_decoder(model)
    full = generate(fapply, torch.from_numpy(prompt), max_new_tokens=8,
                    cache=fmake(2, 13)).numpy()
    np.testing.assert_array_equal(got, full)
    fjapply, fjmake = jax_llama_decoder(jmodel)
    np.testing.assert_array_equal(full, np.asarray(jax_generate(
        fjapply, exact, jnp.asarray(prompt), max_new_tokens=8,
        cache=fjmake(2, 13))))


def test_llama_quant_engine_matches_jax(llama):
    """The paged engine over the int8 decoder: prefill chunks and the
    batch-N decode through `PagedCache`, token for token JAX's."""
    jmodel, params, model = _llama_pair(llama, "O0")
    ekw = dict(max_slots=3, max_len=32, prefill_chunk=4, vocab_size=VOCAB,
               paged=True, temperature=0.7)
    base = np.random.default_rng(8).integers(1, VOCAB, 11).astype(np.int32)

    def run(eng):
        ids = [eng.submit(base[:n], max_new_tokens=m, seed=s)
               for n, m, s in ((3, 6, 1), (9, 5, 2), (6, 7, 3), (11, 4, 4))]
        eng.run(max_steps=100)
        return [[int(t) for t in eng.results[r].tokens] for r in ids]

    japply, jmake, jq = jax_llama_quant_decoder(jmodel, params)
    want = run(JaxEngine(japply, jmake, jq, JaxEngineConfig(**ekw)))
    apply_fn, make_cache, _ = llama_quant_decoder(model)
    assert run(Engine(apply_fn, make_cache, EngineConfig(**ekw),
                      device="cpu")) == want


@pytest.fixture(scope="module")
def gpt2():
    jcfg = JaxGPT2Config.tiny(policy=jax_get_policy("O0"), max_seq_len=32)
    prompt = np.random.default_rng(13).integers(0, jcfg.vocab_size,
                                                (2, 5)).astype(np.int32)
    params = JaxGPT2(jcfg).init(jax.random.key(0),
                                jnp.asarray(prompt))["params"]
    exact = _representable(params, ("kernel", "wte"),
                           lambda n: 1 if n == "kernel" else 0, seed=17)
    return dict(params=params, exact=exact, prompt=prompt)


def _gpt2_pair(gpt2, level, key="params"):
    jcfg = JaxGPT2Config.tiny(policy=jax_get_policy(level), max_seq_len=32)
    tcfg = GPT2Config.tiny(policy=get_policy(level), max_seq_len=32)
    params = gpt2[key]
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return (JaxGPT2(jcfg), params,
            gpt2_params_from_jax(np_params, tcfg, "cpu"))


@pytest.mark.parametrize("level,tol", [("O0", 1e-5), ("O2", 2e-2)])
def test_gpt2_quant_tree_and_logits_match_jax(gpt2, level, tol):
    jmodel, params, model = _gpt2_pair(gpt2, level)
    japply, jmake, jq = jax_gpt2_quant_decoder(jmodel, params)
    apply_fn, make_cache, tq = gpt2_quant_decoder(model)
    want_t, got_t = _flat(jax.tree_util.tree_map(np.asarray, jq)), _flat(tq)
    assert sorted(want_t) == sorted(got_t)
    for k in want_t:
        np.testing.assert_array_equal(_np(got_t[k]), _np(want_t[k]),
                                      err_msg=k)
    prompt = gpt2["prompt"]
    want, _ = japply(jq, jnp.asarray(prompt), jmake(2, 16), 0)
    got, _ = apply_fn(torch.from_numpy(prompt), make_cache(2, 16), 0)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol,
                               atol=tol * np.abs(want).max())


def test_gpt2_generate_streams_equal_jax_and_full_precision(gpt2):
    jmodel, exact, model = _gpt2_pair(gpt2, "O0", key="exact")
    prompt = gpt2["prompt"]
    vocab = model.cfg.vocab_size
    japply, jmake, jq = jax_gpt2_quant_decoder(jmodel, exact)
    want = np.asarray(jax_generate(japply, jq, jnp.asarray(prompt),
                                   max_new_tokens=6, cache=jmake(2, 11),
                                   vocab_size=vocab))
    apply_fn, make_cache, _ = gpt2_quant_decoder(model)
    got = generate(apply_fn, torch.from_numpy(prompt), max_new_tokens=6,
                   cache=make_cache(2, 11), vocab_size=vocab).numpy()
    np.testing.assert_array_equal(got, want)
    fapply, fmake = gpt2_decoder(model)
    full = generate(fapply, torch.from_numpy(prompt), max_new_tokens=6,
                    cache=fmake(2, 11), vocab_size=vocab).numpy()
    np.testing.assert_array_equal(got, full)


def test_gpt2_out_of_range_positions_read_nan(gpt2):
    _, _, model = _gpt2_pair(gpt2, "O0")
    apply_fn, make_cache, _ = gpt2_quant_decoder(model)
    logits, _ = apply_fn(torch.tensor([[1]]), make_cache(1, 40), 31)
    assert torch.isfinite(logits).all()
    logits, _ = apply_fn(torch.tensor([[1]]), make_cache(1, 40), 32)
    assert torch.isnan(logits).all()


def test_moe_raises():
    """A dense tree under an MoE config raises: its MoE layers need the
    router and expert weights."""
    cfg = LlamaConfig.tiny(vocab_size=VOCAB, moe_every=2)
    dense = LlamaConfig.tiny(vocab_size=VOCAB)
    params = {k: torch.zeros(v.shape) for k, v in Llama(
        dense, device="cpu").named_parameters()}
    with pytest.raises(KeyError, match="moe"):
        quantize_llama_params(params, cfg)


def test_quant_params_from_jax_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        quant_params_from_jax({"output": {"q": np.zeros((2, 2), np.int8),
                                          "s": np.ones(2, np.float32)}})
