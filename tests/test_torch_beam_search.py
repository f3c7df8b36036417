"""`beam_search`: the port against the JAX package on the CPU.

On a tiny GPT-2 (``GPT2Config.tiny``, O0, vocab 256, ``vocab_size``
passed) carried across from the JAX package's params, through each
package's ``gpt2_decoder``: tokens equal to JAX's bit for bit and
scores within 1e-5, at
``length_penalty`` 0 and 0.6, with an ``eos_id`` (finished beams pad
with ``pad_id``), and beam 1 equal to `generate`'s greedy stream (JAX
``tests/test_generate.py:251-305``). On JAX's table-driven Markov
machine (``tests/test_generate.py:659-705``), where length-normalised
and pure-sum pruning pick different winners: the same tokens and
scores as JAX at penalty 3 and 0.
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
from apex1_tpu_torch import GPT2Config, get_policy, gpt2_params_from_jax

# the packages' ``models`` export a function named ``generate``
jgen = importlib.import_module("apex1_tpu.models.generate")
tgen = importlib.import_module("apex1_tpu_torch.models.generate")

N, S_MAX = 6, 11


@pytest.fixture(scope="module")
def gpt2():
    """(JAX model, JAX params, port model, prompt, vocab) of the tiny
    GPT-2 at O0."""
    jcfg = JaxGPT2Config.tiny(policy=jax_get_policy("O0"), max_seq_len=64)
    rng = np.random.default_rng(17)
    prompt = rng.integers(0, jcfg.vocab_size, (2, 5)).astype(np.int32)
    jmodel = JaxGPT2(jcfg)
    params = jmodel.init(jax.random.key(0), jnp.asarray(prompt))["params"]
    cfg = GPT2Config.tiny(policy=get_policy("O0"), max_seq_len=64)
    model = gpt2_params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                 cfg, "cpu")
    return jmodel, params, model, prompt, jcfg.vocab_size


def _both(gpt2, K, **kw):
    """(JAX tokens, scores), (port tokens, scores) of one beam search."""
    jmodel, params, model, prompt, vocab = gpt2
    B = prompt.shape[0]
    japply, jmake = jgen.gpt2_decoder(jmodel)
    tapply, tmake = tgen.gpt2_decoder(model)
    want = jgen.beam_search(japply, params, jnp.asarray(prompt),
                            max_new_tokens=N, cache=jmake(B * K, S_MAX),
                            num_beams=K, vocab_size=vocab, **kw)
    got = tgen.beam_search(tapply, torch.from_numpy(prompt),
                           max_new_tokens=N, cache=tmake(B * K, S_MAX),
                           num_beams=K, vocab_size=vocab, **kw)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("K", [2, 4])
@pytest.mark.parametrize("length_penalty", [0.0, 0.6])
def test_tokens_and_scores_match_jax(gpt2, K, length_penalty):
    (jt, js), (tt, ts) = _both(gpt2, K, length_penalty=length_penalty)
    assert tt.dtype == np.int32 and tt.shape == (2, N)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(ts, js, rtol=1e-5)


def test_eos_pads_finished_beams_like_jax(gpt2):
    (jt, _), _ = _both(gpt2, 1)
    eos = int(jt[0, 2])
    (jt, js), (tt, ts) = _both(gpt2, 3, eos_id=eos, pad_id=0,
                               length_penalty=0.6)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(ts, js, rtol=1e-5)
    (jt, _), (tt, _) = _both(gpt2, 1, eos_id=eos, pad_id=0)
    np.testing.assert_array_equal(tt, jt)
    row = list(tt[0])
    assert eos in row and all(t == 0 for t in row[row.index(eos) + 1:])


def test_beam1_equals_greedy(gpt2):
    _, _, model, prompt, vocab = gpt2
    apply_fn, make_cache = tgen.gpt2_decoder(model)
    greedy = tgen.generate(apply_fn, torch.from_numpy(prompt),
                           max_new_tokens=N, cache=make_cache(2, S_MAX),
                           vocab_size=vocab)
    beam, _ = tgen.beam_search(apply_fn, torch.from_numpy(prompt),
                               max_new_tokens=N, cache=make_cache(2, S_MAX),
                               num_beams=1, vocab_size=vocab)
    np.testing.assert_array_equal(beam.numpy(), greedy.numpy())


def _markov():
    """JAX's table: a finished short beam out-sums two longer live
    candidates at the critical step, both out-norm it at penalty 3."""
    V = 5
    P = np.full((V, V), 1e-3)
    P[3] = [.004, .62, .37, .002, .004]
    P[1] = [.132, .132, .132, .004, .6]
    P[2] = [.5, .17, .165, .155, .01]
    P[0] = [.003, .003, .002, .45, .497]
    P /= P.sum(axis=1, keepdims=True)
    return np.log(P).astype(np.float32)


@pytest.mark.parametrize("length_penalty", [3.0, 0.0])
def test_markov_machine_matches_jax(length_penalty):
    logp = _markov()
    jl, tl = jnp.asarray(logp), torch.from_numpy(logp)

    def japply(params, tokens, cache, cache_index):
        return jl[tokens[:, -1]][:, None, :], cache

    def tapply(tokens, cache, cache_index):
        return tl[tokens[:, -1].long()][:, None, :], cache

    kw = dict(max_new_tokens=4, num_beams=2, length_penalty=length_penalty,
              eos_id=4, pad_id=0)
    jt, js = jgen.beam_search(japply, None, jnp.full((1, 1), 3, jnp.int32),
                              cache={"x": jnp.zeros((2, 1))}, **kw)
    tt, ts = tgen.beam_search(
        tapply, torch.full((1, 1), 3, dtype=torch.int32),
        cache={"x": {"k": torch.zeros(2, 1)}}, **kw)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    if length_penalty:
        assert tt[0].tolist() == [2, 0, 3, 1]
