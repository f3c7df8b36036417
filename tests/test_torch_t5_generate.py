"""T5's cached decode, `t5_generate` and `cache_attend`'s bias: the port
against the JAX package on the CPU.

On a tiny T5 (``T5Config.tiny``, O0, fp32) carried across from the JAX
package's params (`interop.t5_params_from_jax`):

- two cached decoder steps (the start token at index 0, a token at
  index 1): logits and the new cache entries within 1e-5 of JAX's
  ``T5.decode(cache=...)`` (the same projections of the same inputs,
  fp32 sums in another order), the slots past the index still empty;
- `t5_generate` greedy: tokens equal to JAX's bit for bit, and to the
  port's own uncached greedy loop (a full ``T5.forward`` over the
  growing decoder context);
- with ``enc_pad_mask``: tokens equal to JAX's and unchanged when the
  padded encoder tokens change (JAX ``tests/test_generate.py:220``);
- sampled at T 0.7, top-k 5 from the same threefry key: equal to JAX's;
- ``num_beams=2``: tokens equal to JAX's, and `beam_search`'s scores
  within 1e-5; the ValueError for beams with a temperature raised before
  the encoder runs;
- `cache_attend` with a (1, Hq, S, S_max) bias under GQA and with a
  per-row bias: within 1e-5 of JAX's; a `PagedCache` with a bias raises
  the JAX ValueError.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex1_tpu.core.policy import get_policy as jax_get_policy
from apex1_tpu.models.t5 import T5 as JaxT5
from apex1_tpu.models.t5 import T5Config as JaxT5Config
from apex1_tpu.ops import paged_decode as jpd
from apex1_tpu_torch import T5Config, get_policy, t5_params_from_jax
from apex1_tpu_torch.ops import paged_decode as tpd

# the packages' ``models`` export a function named ``generate``
jgen = importlib.import_module("apex1_tpu.models.generate")
tgen = importlib.import_module("apex1_tpu_torch.models.generate")

B, S_ENC, N = 2, 10, 6


@pytest.fixture(scope="module")
def t5():
    """(JAX model, JAX params, port model, encoder tokens, key-padding
    mask) of the tiny T5 at O0."""
    jcfg = JaxT5Config.tiny(policy=jax_get_policy("O0"))
    rng = np.random.default_rng(11)
    enc = rng.integers(1, jcfg.vocab_size, (B, S_ENC)).astype(np.int32)
    jmodel = JaxT5(jcfg)
    params = jax.jit(jmodel.init)(jax.random.key(5), jnp.asarray(enc),
                                  jnp.zeros((B, 1), jnp.int32))["params"]
    cfg = T5Config.tiny(policy=get_policy("O0"))
    model = t5_params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                               cfg, "cpu")
    keep = np.ones((B, S_ENC), bool)
    keep[1, -4:] = False
    return jmodel, params, model, enc, keep


def test_cached_decode_steps_match_jax(t5):
    jmodel, params, model, enc, _ = t5
    cfg = model.cfg
    s_max = 1 + N
    jmem = jmodel.apply({"params": params}, jnp.asarray(enc),
                        method=jmodel.encode)
    jcache = jgen.init_cache(cfg.num_decoder_layers, B, cfg.num_heads,
                             s_max, cfg.head_dim, jnp.float32)
    tmem = model.encode(torch.from_numpy(enc))
    tcache = tgen.init_cache(cfg.num_decoder_layers, B, cfg.num_heads,
                             s_max, cfg.head_dim, torch.float32,
                             device="cpu")
    np.testing.assert_allclose(tmem.detach().numpy(), np.asarray(jmem),
                               rtol=1e-5, atol=1e-5)
    for idx, tok in ((0, np.zeros((B, 1), np.int32)),
                     (1, np.array([[7], [42]], np.int32))):
        jl, jcache = jmodel.apply({"params": params}, jnp.asarray(tok),
                                  jmem, cache=jcache, cache_index=idx,
                                  method=jmodel.decode)
        with torch.no_grad():
            tl, tcache = model.decode(torch.from_numpy(tok), tmem,
                                      cache=tcache, cache_index=idx)
        assert tl.shape == (B, 1, cfg.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-5)
        for name, entry in tcache.items():
            for kv in ("k", "v"):
                np.testing.assert_allclose(
                    entry[kv].numpy(), np.asarray(jcache[name][kv]),
                    rtol=1e-5, atol=1e-5)
        # the slots past the index stay empty
        assert not tcache["layer0"]["k"][:, :, idx + 1:].any()


def _uncached_greedy(model, enc, keep=None):
    """Greedy decoding by a full forward over the growing decoder
    context from the start token 0."""
    enc = torch.from_numpy(enc)
    keep = None if keep is None else torch.from_numpy(keep)
    dec = torch.zeros((B, 1), dtype=torch.int64)
    with torch.no_grad():
        for _ in range(N):
            logits = model(enc, dec, enc_pad_mask=keep)
            dec = torch.cat([dec, logits[:, -1].argmax(-1)[:, None]], 1)
    return dec[:, 1:].numpy()


@pytest.mark.parametrize("padded", [False, True], ids=["dense", "padded"])
def test_greedy_equals_jax_and_the_uncached_loop(t5, padded):
    jmodel, params, model, enc, keep = t5
    mask = keep if padded else None
    want = jgen.t5_generate(jmodel, params, jnp.asarray(enc),
                            max_new_tokens=N,
                            enc_pad_mask=None if mask is None
                            else jnp.asarray(mask))
    got = tgen.t5_generate(model, torch.from_numpy(enc), max_new_tokens=N,
                           enc_pad_mask=None if mask is None
                           else torch.from_numpy(mask))
    assert got.dtype == torch.int32 and got.shape == (B, N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(),
                                  _uncached_greedy(model, enc, mask))
    if padded:
        # the padded encoder tokens do not reach the decoder
        enc2 = enc.copy()
        enc2[1, -4:] = 3
        again = tgen.t5_generate(model, torch.from_numpy(enc2),
                                 max_new_tokens=N,
                                 enc_pad_mask=torch.from_numpy(mask))
        np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_sampled_equals_jax(t5):
    jmodel, params, model, enc, _ = t5
    key = jax.random.key(9)
    data = tuple(int(x) for x in jax.random.key_data(key))
    want = jgen.t5_generate(jmodel, params, jnp.asarray(enc),
                            max_new_tokens=N, temperature=0.7, top_k=5,
                            rng=key)
    got = tgen.t5_generate(model, torch.from_numpy(enc), max_new_tokens=N,
                           temperature=0.7, top_k=5, rng=data)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    again = tgen.t5_generate(model, torch.from_numpy(enc), max_new_tokens=N,
                             temperature=0.7, top_k=5, rng=data)
    np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_beams_equal_jax(t5):
    jmodel, params, model, enc, _ = t5
    cfg, K = model.cfg, 2
    want = jgen.t5_generate(jmodel, params, jnp.asarray(enc),
                            max_new_tokens=N, num_beams=K,
                            length_penalty=0.6)
    got = tgen.t5_generate(model, torch.from_numpy(enc), max_new_tokens=N,
                           num_beams=K, length_penalty=0.6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    # the scores, through beam_search over the same decode step
    jmem = jmodel.apply({"params": params}, jnp.asarray(enc),
                        method=jmodel.encode)
    jtiled = jnp.repeat(jmem, K, axis=0)

    def japply(p, tokens, cache, cache_index):
        mem = jmem if tokens.shape[0] == B else jtiled
        return jmodel.apply({"params": p}, tokens, mem, cache=cache,
                            cache_index=cache_index, method=jmodel.decode)

    tmem = model.encode(torch.from_numpy(enc)).detach()
    ttiled = tmem.repeat_interleave(K, dim=0)

    @torch.no_grad()
    def tapply(tokens, cache, cache_index):
        mem = tmem if tokens.shape[0] == B else ttiled
        return model.decode(tokens, mem, cache=cache,
                            cache_index=cache_index)

    jt, js = jgen.beam_search(
        japply, params, jnp.zeros((B, 1), jnp.int32), max_new_tokens=N,
        cache=jgen.init_cache(cfg.num_decoder_layers, B * K, cfg.num_heads,
                              1 + N, cfg.head_dim, jnp.float32),
        num_beams=K, length_penalty=0.6)
    tt, ts = tgen.beam_search(
        tapply, torch.zeros((B, 1), dtype=torch.int32), max_new_tokens=N,
        cache=tgen.init_cache(cfg.num_decoder_layers, B * K, cfg.num_heads,
                              1 + N, cfg.head_dim, torch.float32,
                              device="cpu"),
        num_beams=K, length_penalty=0.6)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)
    np.testing.assert_array_equal(tt.numpy(), got.numpy())


def test_beams_with_a_temperature_raise_before_the_encoder(t5):
    _, _, model, enc, _ = t5

    class NoEncode:
        cfg = model.cfg

        def encode(self, *a, **kw):
            raise AssertionError("the encoder ran")

    for kw in (dict(temperature=0.5), dict(top_k=3)):
        with pytest.raises(ValueError, match="deterministic"):
            tgen.t5_generate(NoEncode(), torch.from_numpy(enc),
                             max_new_tokens=N, num_beams=2, **kw)


@pytest.mark.parametrize("bias_rows", [1, 3], ids=["shared", "per-row"])
@pytest.mark.parametrize("S", [1, 3], ids=["decode", "chunk"])
def test_cache_attend_bias_matches_jax(bias_rows, S):
    rng = np.random.default_rng(4)
    Bb, Hq, Hkv, S_max, D = 3, 4, 2, 9, 8
    q = rng.standard_normal((Bb, Hq, S, D)).astype(np.float32)
    k = rng.standard_normal((Bb, Hkv, S_max, D)).astype(np.float32)
    v = rng.standard_normal((Bb, Hkv, S_max, D)).astype(np.float32)
    bias = rng.standard_normal((bias_rows, Hq, S, S_max)).astype(np.float32)
    for idx in (0, 4, S_max - S):
        want = jpd.cache_attend(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), idx, sm_scale=1.0,
                                bias=jnp.asarray(bias))
        got = tpd.cache_attend(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), idx, sm_scale=1.0,
                               bias=torch.from_numpy(bias))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_paged_cache_with_a_bias_raises():
    pc = tpd.PagedCache(torch.zeros(2, 1, 4, 8), torch.zeros(2, 1, 4, 8),
                        torch.zeros(1, 1, dtype=torch.int32), 4)
    q = torch.zeros(1, 1, 1, 8)
    with pytest.raises(ValueError, match="bias"):
        tgen.cached_attention(q, q, q, pc, 0, bias=torch.zeros(1, 1, 1, 4))
