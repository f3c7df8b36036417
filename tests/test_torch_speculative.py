"""`counter_sample` and `speculative_generate` of the port against the
JAX package on the CPU (the cases of tests/test_speculative.py).

- `counter_sample` ids bit for bit at T 0 and 0.7 and with top_k; the
  accept/resample rule's accepted count and correction token for
  random p, q, drafts and keys;
- `speculative_generate` tokens and ``target_forwards`` equal JAX's on
  the tiny GPT-2 and Llama of tests/test_speculative.py (JAX's params),
  greedy at K 1, 3, 4 and sampled at T 0.7, a self draft (every draft
  accepted, ceil((N - 1) / (K + 1)) rounds), ragged ``prompt_lens``
  rows equal to each row decoded alone, ``eos_id`` padding, an int8
  draft (`llama_quant_decoder`);
- the error cases: ``num_draft < 1`` and a cache shorter than S0 + N +
  K + 1;
- the per-row dense ``cached_attention`` index against the scalar form
  row by row, the `DenseCache` entry written in place.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex1_tpu.core.policy import get_policy as jax_get_policy
from apex1_tpu.models.gpt2 import GPT2 as JaxGPT2
from apex1_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from apex1_tpu.models.llama import Llama as JaxLlama
from apex1_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from apex1_tpu.models.quant_decode import \
    llama_quant_decoder as jax_llama_quant_decoder
from apex1_tpu_torch import (GPT2Config, LlamaConfig, get_policy,
                             gpt2_decoder, gpt2_params_from_jax,
                             llama_decoder, llama_params_from_jax)
from apex1_tpu_torch.models.generate import (DenseCache, _speculative_accept,
                                             cached_attention,
                                             counter_sample, generate,
                                             speculative_generate)
from apex1_tpu_torch.models.quant_decode import llama_quant_decoder

# the module (``apex1_tpu.models.generate`` is also a function name there)
jgen = importlib.import_module("apex1_tpu.models.generate")
N = 10


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _pair(family, rng_seed=17, draft_kw=None):
    """(JAX target, JAX draft, port target, port draft, prompt, vocab):
    tests/test_speculative.py's tiny models from JAX's params."""
    rng = np.random.default_rng(rng_seed)
    if family == "llama":
        jt = JaxLlamaConfig.tiny(policy=jax_get_policy("O0"),
                                 max_seq_len=64)
        jd = JaxLlamaConfig.tiny(policy=jax_get_policy("O0"),
                                 max_seq_len=64, num_layers=1,
                                 hidden_size=32, ffn_size=64,
                                 **(draft_kw or {}))
        jm, jdm = JaxLlama(jt), JaxLlama(jd)
        mkj, mkp, conv, PC = (jgen.llama_decoder, llama_decoder,
                              llama_params_from_jax, LlamaConfig)
    else:
        jt = JaxGPT2Config.tiny(policy=jax_get_policy("O0"),
                                max_seq_len=64)
        jd = JaxGPT2Config.tiny(policy=jax_get_policy("O0"),
                                max_seq_len=64, num_layers=1,
                                hidden_size=64)
        jm, jdm = JaxGPT2(jt), JaxGPT2(jd)
        mkj, mkp, conv, PC = (jgen.gpt2_decoder, gpt2_decoder,
                              gpt2_params_from_jax, GPT2Config)
    prompt = rng.integers(1, jt.vocab_size, (2, 5)).astype(np.int32)
    pt = jm.init(jax.random.key(0), jnp.asarray(prompt))["params"]
    pd = jdm.init(jax.random.key(1), jnp.asarray(prompt))["params"]
    kw_t = dict(policy=get_policy("O0"), max_seq_len=64)
    kw_d = dict(kw_t, num_layers=1, hidden_size=jd.hidden_size)
    if family == "llama":
        kw_d.update(ffn_size=64, **(draft_kw or {}))
    tm = conv(_np_tree(pt), PC.tiny(**kw_t), "cpu")
    dm = conv(_np_tree(pd), PC.tiny(**kw_d), "cpu")
    return dict(jt=(*mkj(jm), pt), jd=(*mkj(jdm), pd), tt=mkp(tm),
                td=mkp(dm), prompt=prompt, vocab=jt.vocab_size, tm=tm)


@pytest.fixture(scope="module")
def models():
    return {f: _pair(f) for f in ("gpt2", "llama")}


def _jax_spec(m, K, n=N, target=None, draft=None, lens=None, **kw):
    t_fn, mk_t, pt = target or m["jt"]
    d_fn, mk_d, pd = draft or m["jd"]
    p = jnp.asarray(m["prompt"] if lens is None else m["rprompt"])
    B, S0 = p.shape
    toks, rounds = jgen.speculative_generate(
        t_fn, pt, d_fn, pd, p, max_new_tokens=n,
        target_cache=mk_t(B, S0 + n + K + 1),
        draft_cache=mk_d(B, S0 + n + K + 1), num_draft=K,
        vocab_size=m["vocab"], prompt_lens=lens, **kw)
    return np.asarray(toks), np.asarray(rounds)


def _port_spec(m, K, n=N, target=None, draft=None, lens=None, **kw):
    t_fn, mk_t = target or m["tt"]
    d_fn, mk_d = draft or m["td"]
    p = torch.from_numpy(m["prompt"] if lens is None else m["rprompt"])
    B, S0 = p.shape
    toks, rounds = speculative_generate(
        t_fn, d_fn, p, max_new_tokens=n,
        target_cache=mk_t(B, S0 + n + K + 1),
        draft_cache=mk_d(B, S0 + n + K + 1), num_draft=K,
        vocab_size=m["vocab"], prompt_lens=lens, **kw)
    return toks.numpy(), rounds.numpy()


def _key_data(key):
    return tuple(int(x) for x in np.asarray(jax.random.key_data(key)))


# ---- counter_sample and the accept rule ---------------------------------


@pytest.mark.parametrize("temperature,top_k", [(0.0, None), (0.7, None),
                                               (0.7, 5)])
def test_counter_sample_bitwise(temperature, top_k):
    rng = np.random.default_rng(5)
    lg = rng.standard_normal((6, 97)).astype(np.float32) * 3
    pos = np.asarray([0, 1, 2, 7, 40, 1000], np.int32)
    want = np.asarray(jgen.counter_sample(
        jnp.asarray(lg), 12345, jnp.asarray(pos), temperature=temperature,
        top_k=top_k, vocab_size=90))
    got = counter_sample(torch.from_numpy(lg), 12345, torch.from_numpy(pos),
                         temperature=temperature, top_k=top_k,
                         vocab_size=90)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(6))
def test_speculative_accept_matches_jax(seed):
    rng = np.random.default_rng(seed)
    K, V = 4, 23
    p = rng.dirichlet(np.ones(V) * 0.3, K + 1).astype(np.float32)
    # the draft close to the target for some seeds (long accepts), far
    # for others (early rejections)
    mix = 0.9 if seed % 2 else 0.2
    q = (mix * p[:K] + (1 - mix) * rng.dirichlet(np.ones(V), K)).astype(
        np.float32)
    drafts = np.asarray([int(np.argmax(p[j])) if seed % 3 else
                         int(rng.integers(V)) for j in range(K)], np.int32)
    key = jax.random.key(100 + seed)
    a, corr = jgen._speculative_accept(jnp.asarray(p), jnp.asarray(q),
                                       jnp.asarray(drafts), key)
    ga, gc = _speculative_accept(torch.from_numpy(p), torch.from_numpy(q),
                                 torch.from_numpy(drafts), _key_data(key))
    assert (int(ga), int(gc)) == (int(a), int(corr))


# ---- speculative_generate ------------------------------------------------


@pytest.mark.parametrize("family,K", [("gpt2", 1), ("gpt2", 4),
                                      ("llama", 3)])
def test_greedy_matches_jax_and_target_greedy(models, family, K):
    m = models[family]
    got, rounds = _port_spec(m, K)
    want, jrounds = _jax_spec(m, K)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(rounds, jrounds)
    assert rounds.dtype == np.int32 and (rounds >= 1).all()
    t_fn, mk_t = m["tt"]
    plain = generate(t_fn, torch.from_numpy(m["prompt"]), max_new_tokens=N,
                     cache=mk_t(2, 5 + N), vocab_size=m["vocab"])
    np.testing.assert_array_equal(got, plain.numpy())


@pytest.mark.parametrize("n", [13])
def test_self_draft_accepts_everything(models, n):
    m = models["llama"]
    K = 3
    got, rounds = _port_spec(m, K, n=n, draft=m["tt"])
    want, jrounds = _jax_spec(m, K, n=n, draft=m["jt"])
    np.testing.assert_array_equal(got, want)
    assert (rounds == -(-(n - 1) // (K + 1))).all(), rounds
    np.testing.assert_array_equal(rounds, jrounds)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_sampled_matches_jax(models, family):
    m = models[family]
    kw = dict(temperature=0.7, rng=jax.random.key(7))
    want, jrounds = _jax_spec(m, 3, **kw)
    kw["rng"] = _key_data(kw["rng"])
    got, rounds = _port_spec(m, 3, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(rounds, jrounds)
    again, _ = _port_spec(m, 3, **kw)
    np.testing.assert_array_equal(again, got)


def test_sampled_self_draft_top_k_matches_jax(models):
    m = models["gpt2"]
    kw = dict(temperature=0.7, top_k=8, rng=jax.random.key(3))
    want, jrounds = _jax_spec(m, 2, draft=m["jt"], **kw)
    kw["rng"] = _key_data(kw["rng"])
    got, rounds = _port_spec(m, 2, draft=m["tt"], **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(rounds, jrounds)


def test_eos_stops_and_pads(models):
    m = models["gpt2"]
    ref, _ = _port_spec(m, 3)
    eos = int(ref[0, 3])
    got, rounds = _port_spec(m, 3, eos_id=eos, pad_id=0)
    want, jrounds = _jax_spec(m, 3, eos_id=eos, pad_id=0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(rounds, jrounds)
    stop = int(np.argmax(got[0] == eos))
    assert (got[0, stop + 1:] == 0).all()


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_ragged_rows_match_jax(models, temperature):
    m = dict(models["llama"])
    rng = np.random.default_rng(23)
    lens = [6, 3, 5]
    rp = np.zeros((3, 6), np.int32)
    for b, ln in enumerate(lens):
        rp[b, :ln] = rng.integers(1, m["vocab"], ln)
    m["rprompt"] = rp
    K, n = 3, 8
    kw = dict(temperature=temperature)
    jkw = dict(kw, rng=jax.random.key(11)) if temperature else kw
    pkw = dict(kw, rng=_key_data(jax.random.key(11))) if temperature else kw
    want, jrounds = _jax_spec(m, K, n=n, lens=np.asarray(lens), **jkw)
    got, rounds = _port_spec(m, K, n=n, lens=np.asarray(lens), **pkw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(rounds, jrounds)
    if temperature:
        return
    t_fn, mk_t = m["tt"]
    b, ln = 1, lens[1]                  # the shortest row, decoded alone
    solo = generate(t_fn, torch.from_numpy(rp[b:b + 1, :ln]),
                    max_new_tokens=n, cache=mk_t(1, ln + n),
                    vocab_size=m["vocab"])
    np.testing.assert_array_equal(got[b], solo[0].numpy())


def test_int8_draft_under_f32_target(models):
    m = models["llama"]
    jcfg = JaxLlamaConfig.tiny(policy=jax_get_policy("O2"), max_seq_len=64,
                               num_layers=1)
    jdm = JaxLlama(jcfg)
    pd = jdm.init(jax.random.key(1), jnp.asarray(m["prompt"]))["params"]
    jd_fn, jmk_d, qpd = jax_llama_quant_decoder(jdm, pd)
    dm = llama_params_from_jax(_np_tree(pd), LlamaConfig.tiny(
        policy=get_policy("O2"), max_seq_len=64, num_layers=1), "cpu")
    d_fn, mk_d, _ = llama_quant_decoder(dm)
    want, jrounds = _jax_spec(m, 3, n=8, draft=(jd_fn, jmk_d, qpd))
    got, rounds = _port_spec(m, 3, n=8, draft=(d_fn, mk_d))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(rounds, jrounds)


def test_error_cases(models):
    m = models["gpt2"]
    t_fn, mk_t = m["tt"]
    p = torch.from_numpy(m["prompt"])
    with pytest.raises(ValueError, match="num_draft"):
        speculative_generate(t_fn, t_fn, p, max_new_tokens=4,
                             target_cache=mk_t(2, 32),
                             draft_cache=mk_t(2, 32), num_draft=0)
    with pytest.raises(ValueError, match="draft_cache holds 12"):
        speculative_generate(t_fn, t_fn, p, max_new_tokens=4,
                             target_cache=mk_t(2, 32),
                             draft_cache=mk_t(2, 12), num_draft=3)
    with pytest.raises(ValueError, match="target_cache holds 12"):
        speculative_generate(t_fn, t_fn, p, max_new_tokens=4,
                             target_cache=mk_t(2, 12),
                             draft_cache=mk_t(2, 32), num_draft=3)


# ---- the per-row dense cache index --------------------------------------


@pytest.mark.parametrize("S,inplace", [(1, False), (1, True), (3, True)])
def test_per_row_index_equals_scalar_rows(S, inplace):
    gen = torch.Generator().manual_seed(0)
    B, Hq, Hkv, L, D = 3, 4, 2, 16, 8
    q = torch.randn(B, Hq, S, D, generator=gen)
    kn = torch.randn(B, Hkv, S, D, generator=gen)
    vn = torch.randn(B, Hkv, S, D, generator=gen)
    k0 = torch.randn(B, Hkv, L, D, generator=gen)
    v0 = torch.randn(B, Hkv, L, D, generator=gen)
    idx = torch.tensor([2, 9, 15 - S + 1 + 3])     # the last row clamps
    cache = (DenseCache(k0.clone(), v0.clone()) if inplace
             else {"k": k0.clone(), "v": v0.clone()})
    out, entry = cached_attention(q, kn, vn, cache, idx, chunk_decode=True)
    k_got = entry.k if inplace else entry["k"]
    if inplace:
        assert entry is cache
    else:
        assert torch.equal(cache["k"], k0), "the dict form copies"
    for b in range(B):
        o, e = cached_attention(q[b:b + 1], kn[b:b + 1], vn[b:b + 1],
                                {"k": k0[b:b + 1], "v": v0[b:b + 1]},
                                int(idx[b]), chunk_decode=True)
        assert torch.equal(out[b:b + 1], o)
        assert torch.equal(k_got[b:b + 1], e["k"])
