"""Multi-tenant LoRA serving and speculative verify through the port's
paged engine, against the JAX engine on the CPU.

The tiny Llama of tests/test_lora_serving.py (vocab 97, hidden 32, 2
layers, GQA 4/2) from JAX's params, two rank-2 adapters and an
adapterless control sharing tenant-a's prompt, at T = 0.7:

- the port's ``Engine(device="cpu", lora_rank=2)`` token streams equal
  the JAX ``Engine(paged=True)``'s: the mixed batch, each request solo,
  and with ``num_draft=2`` (with LoRA and without);
- mixed equals solo in the port; the adapter changes tenant-a's stream;
- the adapterless request equals the same request on a ``lora_rank=0``
  engine;
- spec equals non-spec, with each request's ``n_drafted`` /
  ``n_accepted`` equal to JAX's;
- ``draft_propose=`` with oracle drafts (the stream's own next tokens):
  every draft accepted, the stream unchanged;
- adapter pages release at retirement (refcounts back to the registry's);
- ``lora_rank > 0`` without ``lora_head`` raises; ``paged=False``
  serves the paged engine's streams; `ngram_propose` equals JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from apex1_tpu.models.generate import llama_decoder as jax_llama_decoder
from apex1_tpu.models.llama import Llama as JaxLlama
from apex1_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from apex1_tpu.serving.engine import Engine as JaxEngine
from apex1_tpu.serving.engine import EngineConfig as JaxEngineConfig
from apex1_tpu.serving.spec import ngram_propose as jax_ngram_propose
from apex1_tpu_torch import (Engine, EngineConfig, LlamaConfig,
                             llama_decoder, llama_params_from_jax)
from apex1_tpu_torch.serving.spec import ngram_propose

RANK = 2
PROMPTS = {101: ([3, 1, 4, 1, 5], "tenant-a"),
           102: ([2, 7, 1, 8], "tenant-b"),
           103: ([3, 1, 4, 1, 5], None)}
EKW = dict(max_slots=4, max_len=32, prefill_chunk=4, temperature=0.7,
           seed=7, lora_rank=RANK, lora_max_adapters=4, paged=True)
_CFG = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
            num_kv_heads=2, ffn_size=64, max_seq_len=64)


@pytest.fixture(scope="module")
def tiny():
    jmodel = JaxLlama(JaxLlamaConfig(**_CFG))
    params = jmodel.init(jax.random.key(0),
                         jnp.zeros((1, 4), jnp.int32))["params"]
    k = jax.random.key(1)
    adapters = {}
    for name in ("tenant-a", "tenant-b"):
        k, ka, kb = jax.random.split(k, 3)
        adapters[name] = (
            np.asarray(jax.random.normal(ka, (_CFG["hidden_size"], RANK))
                       * 0.2),
            np.asarray(jax.random.normal(kb, (RANK, _CFG["vocab_size"]))
                       * 0.2))
    model = llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                  LlamaConfig(**_CFG), "cpu")
    return dict(jmodel=jmodel, params=params, adapters=adapters, model=model,
                jax_runs={})


def _submit_all(eng, active):
    for rid in sorted(active):
        toks, tenant = PROMPTS[rid]
        eng.submit(np.asarray(toks, np.int32), 8, req_id=rid,
                   tenant=tenant, seed=1000 + rid)
    eng.run(max_steps=100)
    out = {rid: [int(t) for t in eng.results[rid].tokens] for rid in active}
    spec = {rid: (eng.metrics.records[rid].n_drafted,
                  eng.metrics.records[rid].n_accepted) for rid in active}
    return out, spec


def _port(tiny, active, **kw):
    ekw = dict(EKW, **kw)
    apply_fn, make_cache = llama_decoder(tiny["model"])
    eng = Engine(apply_fn, make_cache, EngineConfig(**ekw), device="cpu",
                 lora_head=tiny["model"].output if ekw["lora_rank"] else None)
    if ekw["lora_rank"]:
        for name, (A, B) in tiny["adapters"].items():
            eng.register_adapter(name, A, B, scale=2.0)
    return _submit_all(eng, active) + (eng,)


def _jax(tiny, active, **kw):
    key = (tuple(sorted(active)), tuple(sorted(kw.items())))
    if key not in tiny["jax_runs"]:
        ekw = dict(EKW, **kw)
        apply_fn, make_cache = jax_llama_decoder(tiny["jmodel"])
        eng = JaxEngine(apply_fn, make_cache, tiny["params"],
                        JaxEngineConfig(**ekw),
                        lora_head=(tiny["params"]["output"]
                                   if ekw["lora_rank"] else None))
        if ekw["lora_rank"]:
            for name, (A, B) in tiny["adapters"].items():
                eng.register_adapter(name, A, B, scale=2.0)
        tiny["jax_runs"][key] = _submit_all(eng, active)
    return tiny["jax_runs"][key]


@pytest.mark.parametrize("num_draft", [0, 2])
def test_mixed_batch_equals_jax(tiny, num_draft):
    got, spec, _ = _port(tiny, set(PROMPTS), num_draft=num_draft)
    want, jspec = _jax(tiny, set(PROMPTS), num_draft=num_draft)
    assert got == want
    assert spec == jspec
    assert got[101] != got[103], "the adapter had no effect on the stream"


@pytest.mark.parametrize("num_draft", [0, 2])
@pytest.mark.parametrize("rid", sorted(PROMPTS))
def test_solo_equals_jax_and_mixed(tiny, rid, num_draft):
    got, _, _ = _port(tiny, {rid}, num_draft=num_draft)
    want, _ = _jax(tiny, {rid}, num_draft=num_draft)
    assert got == want
    mixed, _, _ = _port(tiny, set(PROMPTS), num_draft=num_draft)
    assert got[rid] == mixed[rid]


def test_spec_equals_non_spec_and_counts_drafts(tiny):
    plain, _, _ = _port(tiny, set(PROMPTS))
    spec, counts, eng = _port(tiny, set(PROMPTS), num_draft=2)
    assert spec == plain
    assert all(d > 0 and 0 <= a <= d for d, a in counts.values())
    assert eng.metrics.get_counter("spec_drafted") == sum(
        d for d, _ in counts.values())


def test_spec_without_lora_equals_jax(tiny):
    got, spec, _ = _port(tiny, set(PROMPTS), num_draft=3, lora_rank=0)
    want, jspec = _jax(tiny, set(PROMPTS), num_draft=3, lora_rank=0)
    assert got == want and spec == jspec
    assert got == _port(tiny, set(PROMPTS), lora_rank=0)[0]


def test_adapterless_equals_lora_rank_0(tiny):
    mixed, _, _ = _port(tiny, set(PROMPTS))
    base, _, _ = _port(tiny, {103}, lora_rank=0)
    assert mixed[103] == base[103]


def test_slots_reusable_after_retire(tiny):
    out, _, eng = _port(tiny, set(PROMPTS), max_slots=2)
    assert len(out) == 3
    st = eng._lora
    assert not st._slot_pages
    assert st.n_free == st.num_pages - 1 - 2 * RANK   # the registry's refs
    assert not eng._d_lora_bt.any() and not eng._d_lora_on.any()


def test_engine_lora_validation(tiny):
    apply_fn, make_cache = llama_decoder(tiny["model"])
    with pytest.raises(ValueError, match="lora_head"):
        Engine(apply_fn, make_cache, EngineConfig(**EKW), device="cpu")
    with pytest.raises(ValueError, match="lora_max_adapters"):
        EngineConfig(max_slots=2, max_len=32, lora_rank=2,
                     lora_max_adapters=0)
    with pytest.raises(ValueError, match="max_ngram"):
        EngineConfig(max_ngram=0)
    eng = Engine(apply_fn, make_cache, EngineConfig(max_slots=2, max_len=32),
                 device="cpu")
    with pytest.raises(RuntimeError, match="lora"):
        eng.register_adapter("acme", np.zeros((32, 2)), np.zeros((2, 97)))
    dense, _, _ = _port(tiny, set(PROMPTS), paged=False)
    paged, _, _ = _port(tiny, set(PROMPTS))
    assert dense == paged


def test_unregistered_tenant_serves_adapterless(tiny):
    """A tenant unregistered before its request is admitted decodes
    adapterless (the zero row), like a request with no tenant."""
    apply_fn, make_cache = llama_decoder(tiny["model"])
    eng = Engine(apply_fn, make_cache, EngineConfig(**EKW), device="cpu",
                 lora_head=tiny["model"].output)
    A, B = tiny["adapters"]["tenant-a"]
    eng.register_adapter("tenant-a", A, B, scale=2.0)
    eng.unregister_adapter("tenant-a")
    got, _ = _submit_all(eng, {101})
    base, _, _ = _port(tiny, {101}, lora_rank=0)
    assert got == base


@pytest.mark.parametrize("hist,k,n", [([1, 2, 3, 1, 2], 3, 3),
                                      ([5, 6, 7], 2, 3), ([9], 4, 3),
                                      ([1, 2, 1, 2, 1], 5, 1)])
def test_ngram_propose_equals_jax(hist, k, n):
    np.testing.assert_array_equal(ngram_propose(hist, k, max_ngram=n),
                                  jax_ngram_propose(hist, k, max_ngram=n))


def test_oracle_drafts_are_all_accepted(tiny):
    """``draft_propose=`` plugs in the draft source: drafts that are the
    non-spec stream's own next tokens are all accepted (within each
    request's emission window), and the stream is unchanged."""
    active = {101, 102}                  # distinct prompts key the oracle
    plain, _, _ = _port(tiny, active)
    by_prompt = {tuple(PROMPTS[r][0]): plain[r] for r in active}

    def oracle(history, k):
        prompt = next(p for p in by_prompt if tuple(history[:len(p)]) == p)
        done = len(history) - len(prompt)
        nxt = by_prompt[prompt][done:done + k]
        return nxt + [0] * (k - len(nxt))

    apply_fn, make_cache = llama_decoder(tiny["model"])
    eng = Engine(apply_fn, make_cache, EngineConfig(**dict(EKW, num_draft=3)),
                 device="cpu", lora_head=tiny["model"].output,
                 draft_propose=oracle)
    for name, (A, B) in tiny["adapters"].items():
        eng.register_adapter(name, A, B, scale=2.0)
    got, counts = _submit_all(eng, active)
    assert got == plain
    assert all(d == a > 0 for d, a in counts.values()), counts
