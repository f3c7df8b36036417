"""The Llama slice as a whole: the port against the JAX package on the
CPU.

A tiny Llama (vocab 97, 4 query and 2 KV heads, head_dim 16, 2 layers)
from the JAX package's params (`interop.llama_params_from_jax`):

- O0: the loss and every grad leaf of ``llama_loss_fn`` within 1e-5 of
  JAX's, on a dense and a packed batch (per-document positions), JAX
  through its XLA composites and its Pallas kernels in interpret mode;
  ``fused_mlp=True`` against JAX's Pallas glu;
- the port against itself: ``fuse_head`` True vs False, ``fused_mlp``
  True vs False, ``remat`` True vs False under each ported policy;
- O2: a 3-step loss, grad norm and param trajectory within 2e-2 of
  JAX's; O2_fp16 with an overflow forced at step 2 skipped like JAX's;
- serving: ``generate`` through `llama_decoder` (dense and ragged
  prompts, greedy and T = 0.7) and ``Engine(paged=True)`` token streams
  identical to JAX's;
- the amp state and params cross between the packages; the options
  not ported raise (MoE blocks construct, a sequence axis without a
  mesh raises ValueError); the entry points default to CUDA.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex1_tpu.amp import Amp as JaxAmp
from apex1_tpu.core.policy import get_policy as jax_get_policy
from apex1_tpu.models.generate import generate as jax_generate
from apex1_tpu.models.generate import llama_decoder as jax_llama_decoder
from apex1_tpu.models.llama import Llama as JaxLlama
from apex1_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from apex1_tpu.models.llama import llama_loss_fn as jax_llama_loss_fn
from apex1_tpu.ops import _common as jax_common
from apex1_tpu.optim.fused_adam import fused_adam as jax_fused_adam
from apex1_tpu.serving import Engine as JaxEngine
from apex1_tpu.serving import EngineConfig as JaxEngineConfig
from apex1_tpu_torch import (Amp, Engine, EngineConfig, Llama, LlamaConfig,
                             fused_adam, get_policy, llama_decoder,
                             llama_loss_fn, llama_params_from_jax)
from apex1_tpu_torch.interop import (amp_state_from_jax, amp_state_to_numpy,
                                     flax_from_named, llama_params_to_numpy)
from apex1_tpu_torch.models.generate import generate
from apex1_tpu_torch.models.llama import param_specs
from apex1_tpu_torch.runtime import pack_documents

B, S, VOCAB = 2, 24, 97


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def _jcfg(level="O0", **kw):
    return JaxLlamaConfig.tiny(vocab_size=VOCAB,
                               policy=jax_get_policy(level), **kw)


def _tcfg(level="O0", **kw):
    return LlamaConfig.tiny(vocab_size=VOCAB, policy=get_policy(level), **kw)


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.default_rng(30)
    tokens = rng.integers(0, VOCAB, (B, S)).astype(np.int32)
    jparams = jax.jit(JaxLlama(_jcfg()).init)(jax.random.key(4),
                                              jnp.asarray(tokens))["params"]
    docs = [rng.integers(0, VOCAB, int(n)).astype(np.int32)
            for n in rng.integers(3, 30, 5)]
    packed = pack_documents(docs, S)
    return dict(tokens=tokens, jparams=jparams, np_params=_np_tree(jparams),
                packed=packed)


def _batch(tiny, packed):
    return tiny["packed"] if packed else (tiny["tokens"],)


def _port_model(tiny, level="O0", **kw):
    return llama_params_from_jax(tiny["np_params"], _tcfg(level, **kw), "cpu")


def _port_loss_and_grads(tiny, batch, fuse_head=True, **kw):
    model = _port_model(tiny, **kw)
    params = dict(model.named_parameters())
    loss = llama_loss_fn(model, fuse_head=fuse_head)(
        params, *map(torch.from_numpy, batch))
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.item(), _leaves(flax_from_named(dict(zip(params, grads))))


def _jax_loss_and_grads(tiny, batch, impl, **kw):
    with jax_common.force_impl(impl):
        loss, grads = jax.jit(jax.value_and_grad(jax_llama_loss_fn(
            JaxLlama(_jcfg(**kw)))))(tiny["jparams"],
                                      *map(jnp.asarray, batch))
    return float(loss), _leaves(_np_tree(grads))


def _assert_same(got, want, tol=1e-5):
    (gl, gg), (wl, wg) = got, want
    np.testing.assert_allclose(gl, wl, rtol=tol)
    assert gg.keys() == wg.keys()
    for k, w in wg.items():
        np.testing.assert_allclose(gg[k], w, rtol=tol, atol=tol,
                                   err_msg=str(k))


def test_params_round_trip(tiny):
    back = _leaves(llama_params_to_numpy(_port_model(tiny)))
    want = _leaves(tiny["np_params"])
    assert back.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(back[k], w)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_o0_loss_and_every_grad_leaf_match_jax(tiny, packed, impl):
    batch = _batch(tiny, packed)
    _assert_same(_port_loss_and_grads(tiny, batch),
                 _jax_loss_and_grads(tiny, batch, impl))


def test_fused_mlp_matches_jax_glu_kernel(tiny):
    batch = _batch(tiny, False)
    _assert_same(_port_loss_and_grads(tiny, batch, fused_mlp=True),
                 _jax_loss_and_grads(tiny, batch, "pallas", fused_mlp=True))


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("variant", [
    dict(fuse_head=False), dict(fused_mlp=True),
    dict(remat=True), dict(remat=True, remat_policy="dots_saveable"),
    dict(remat=True, remat_policy="dots_with_no_batch_dims_saveable")],
    ids=["materialized-head", "fused-mlp", "remat-nothing",
         "remat-dots", "remat-dots-no-batch"])
def test_port_variants_equal_the_default_step(tiny, packed, variant):
    batch = _batch(tiny, packed)
    _assert_same(_port_loss_and_grads(tiny, batch, **variant),
                 _port_loss_and_grads(tiny, batch))


def _jax_run(tiny, level, steps, overflow_at=None):
    base = jax_llama_loss_fn(JaxLlama(_jcfg(level)))
    amp = JaxAmp(jax_fused_adam(1e-3, weight_decay=0.01), opt_level=level)
    state = amp.init(tiny["jparams"])
    step = jax.jit(amp.make_train_step(lambda p, f, t: base(p, t) * f))
    out = []
    for i in range(steps):
        f = jnp.float32(jnp.inf if i == overflow_at else 1.0)
        state, m = step(state, f, jnp.asarray(tiny["tokens"]))
        out.append((_np_tree(state), _np_tree(m)))
    return out


def _port_run(tiny, level, steps, overflow_at=None, state=None):
    model = _port_model(tiny, level)
    base = llama_loss_fn(model)
    amp = Amp(fused_adam(1e-3, weight_decay=0.01), opt_level=level)
    state = state or amp.init(dict(model.named_parameters()))
    step = amp.make_train_step(lambda p, f, t: base(p, t) * f)
    tokens = torch.from_numpy(tiny["tokens"])
    out = []
    for i in range(steps):
        f = torch.tensor(float("inf") if i == overflow_at else 1.0)
        state, m = step(state, f, tokens)
        out.append((state, {k: v.numpy() for k, v in m.items()}))
    return out


def test_o2_three_step_trajectory_matches_jax(tiny):
    want = _jax_run(tiny, "O2", 3)
    got = _port_run(tiny, "O2", 3)
    for (js, jm), (ts, tm) in zip(want, got):
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=2e-2)
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"],
                                   rtol=2e-2)
        got_l = jax.tree_util.tree_leaves(flax_from_named(ts.params))
        want_l = jax.tree_util.tree_leaves(js.params)
        dist = np.sqrt(sum(np.sum((g - w) ** 2)
                           for g, w in zip(got_l, want_l)))
        norm = np.sqrt(sum(np.sum(w ** 2) for w in want_l))
        assert dist <= 2e-2 * norm, dist / norm
    assert got[-1][1]["loss"] < got[0][1]["loss"]
    # the JAX state after step 1 crosses into the port and back, and the
    # port continues from it as JAX does
    js1 = want[0][0]
    back = amp_state_to_numpy(amp_state_from_jax(js1, "cpu"))
    for k, w in _leaves(js1.params).items():
        np.testing.assert_array_equal(_leaves(back["params"])[k], w)
    cont = _port_run(tiny, "O2", 2, state=amp_state_from_jax(js1, "cpu"))
    np.testing.assert_allclose(cont[0][1]["loss"], want[1][1]["loss"],
                               rtol=2e-2)


def test_o2_fp16_forced_overflow_skips_like_jax(tiny):
    want = _jax_run(tiny, "O2_fp16", 3, overflow_at=1)
    got = _port_run(tiny, "O2_fp16", 3, overflow_at=1)
    for (_, jm), (_, tm) in zip(want, got):
        for k in ("skipped_steps", "loss_scale", "grads_finite"):
            assert tm[k].item() == jm[k].item(), k
    assert [m["grads_finite"].item() for _, m in got] == [True, False, True]
    before, after = got[0][0], got[1][0]
    for k in before.params:
        assert torch.equal(after.params[k], before.params[k]), k


# ---- serving ---------------------------------------------------------------


def _decoders(tiny):
    japply, jmake = jax_llama_decoder(JaxLlama(_jcfg()))
    tapply, tmake = llama_decoder(_port_model(tiny))
    return japply, jmake, tapply, tmake


@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("ragged", [False, True], ids=["dense", "ragged"])
def test_generate_matches_jax(tiny, temperature, ragged):
    japply, jmake, tapply, tmake = _decoders(tiny)
    prompts = np.random.default_rng(31).integers(1, VOCAB, (3, 10)).astype(
        np.int32)
    kw = dict(temperature=temperature)
    if ragged:
        kw["prompt_lens"] = np.asarray([10, 4, 1], np.int32)
    want = jax_generate(japply, tiny["jparams"], jnp.asarray(prompts),
                        max_new_tokens=8, cache=jmake(3, 24),
                        **{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                               else v) for k, v in kw.items()})
    got = generate(tapply, torch.from_numpy(prompts), max_new_tokens=8,
                   cache=tmake(3, 24),
                   **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                          else v) for k, v in kw.items()})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _workload(eng, base):
    """More requests than slots, prompts crossing chunk boundaries,
    staggered joins (the GPT-2 serving test's workload)."""
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
    japply, jmake, tapply, tmake = _decoders(tiny)
    ekw = dict(max_slots=3, max_len=48, prefill_chunk=4, vocab_size=VOCAB,
               paged=True, temperature=temperature)
    base = np.random.default_rng(32).integers(1, VOCAB, 12).astype(np.int32)
    want = _workload(JaxEngine(japply, jmake, tiny["jparams"],
                               JaxEngineConfig(**ekw)), base)
    eng = Engine(tapply, tmake, EngineConfig(**ekw), device="cpu")
    assert _workload(eng, base) == want
    assert all(r.status == "done" for r in eng.results.values())


# ---- what this slice leaves out ------------------------------------------


def test_unported_options_raise():
    # MoE blocks and seq_shard_axis are ported (tests/test_torch_moe.py,
    # tests/test_torch_llama_cp.py); a sequence axis needs a mesh
    assert "layer1.moe.w1" in dict(
        Llama(_tcfg(moe_every=2), device="cpu").named_parameters())
    with pytest.raises(ValueError, match="initialize parallel_state"):
        Llama(_tcfg(), seq_shard_axis="sp", device="cpu")
    specs = param_specs(dict(Llama(_tcfg(moe_every=2),
                                   device="cpu").named_parameters()))
    assert specs["tok_embeddings"] == ("tp", None)
    assert specs["layer0.wq"] == (None, "tp") and specs["layer0.wo"] == (
        "tp", None)
    assert specs["layer1.moe.w1"] == ("ep", None, None)
    assert specs["norm"] == ()
    with pytest.raises(TypeError, match="factory"):
        _tcfg(remat_policy="save_only_these_names")
    with pytest.raises(ValueError, match="unknown checkpoint policy"):
        _tcfg(remat_policy="nothing_savable")
    with pytest.raises(ValueError, match="unknown checkpoint policy"):
        _jcfg(remat_policy="nothing_savable")
    with pytest.raises(ValueError, match="cp_impl"):
        _tcfg(cp_impl="tree")


FACTORY_POLICIES = ("save_only_these_names", "save_any_names_but_these",
                    "save_anything_except_these_names",
                    "save_from_both_policies",
                    "offload_dot_with_no_batch_dims",
                    "save_and_offload_only_these_names")


@pytest.mark.parametrize("name", FACTORY_POLICIES)
def test_factory_policies_fail_in_the_reference_and_are_refused(tiny, name):
    """The six factories of jax.checkpoint_policies build a reference
    config and then fail when its step is traced (jax.checkpoint calls
    the factory as the policy: a TypeError on its arguments or on what
    it returns); the port refuses them when the config is made."""
    with pytest.raises(TypeError, match="factory"):
        _tcfg(remat=True, remat_policy=name)
    model = JaxLlama(_jcfg(remat=True, remat_policy=name))
    with pytest.raises(TypeError, match=rf"{name}\(\)|dimension_numbers|"
                                        r"remat policy"):
        jax.jit(jax.value_and_grad(jax_llama_loss_fn(model)))(
            tiny["jparams"], jnp.asarray(tiny["tokens"]))


@pytest.mark.parametrize("make", ["model", "converter", "engine"])
def test_entry_points_default_to_cuda(tiny, make):
    """Without device=, the entry points ask for CUDA, and raise where
    there is none (never a silent CPU run)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        if make == "model":
            Llama(_tcfg())
        elif make == "converter":
            llama_params_from_jax(tiny["np_params"], _tcfg())
        else:
            apply_fn, make_cache = llama_decoder(_port_model(tiny))
            Engine(apply_fn, make_cache, EngineConfig(paged=True))
