"""The port's `examples.t5_seq2seq`, `rnnt_speech`, `dcgan_amp` and
`serving_llama` against the JAX package on the CPU, at O0 from the JAX
package's weights (through `interop`), on the same numpy draws.

- t5_seq2seq, rnnt_speech, dcgan_amp: 3 steps; each loss within 1e-5
  of JAX's ``Amp`` steps, every param leaf's elements within 1e-5 but
  for at most 1 % within half the learning rate (`_same_params`: Adam
  turns a gradient that is rounding noise into a step of up to about
  the learning rate), DCGAN's running statistics within 1e-5; the steps
  built from the JAX package's modules and the JAX
  scripts' own module-level ``make_batch``, ``RNNT``, ``Generator``,
  ``Discriminator``, ``bce_logits`` and ``greedy_decode`` (loaded by
  path, unedited); `t5_generate`'s tokens and the RNN-T greedy
  hypotheses equal JAX's bit for bit;
- serving_llama ``--tiny`` through an injected O0 model and draft: each
  section's tokens equal JAX's `generate` (greedy, ragged, the prefix
  turns), `beam_search` (its scores within 1e-5), the int8 decoder and
  `speculative_generate` (and its verify rounds) bit for bit;
- the DCGAN layers alone against flax: ``ConvTranspose`` (SAME and
  VALID), ``Conv`` and ``BatchNorm`` (the biased variance, momentum
  0.99: train, eval and the running statistics).
"""

import dataclasses
import importlib
import importlib.util
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex1_tpu.amp import Amp as JaxAmp
from apex1_tpu.contrib.transducer import transducer_loss as jax_tloss
from apex1_tpu.core.policy import get_policy as jax_get_policy
from apex1_tpu.models.llama import Llama as JaxLlama
from apex1_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from apex1_tpu.models.quant_decode import \
    llama_quant_decoder as jax_quant_decoder
from apex1_tpu.models.t5 import T5 as JaxT5
from apex1_tpu.models.t5 import T5Config as JaxT5Config
from apex1_tpu.models.t5 import t5_loss_fn as jax_t5_loss_fn
from apex1_tpu.ops import _common as jax_common
from apex1_tpu.optim.fused_adam import fused_adam as jax_fused_adam
from apex1_tpu_torch import LlamaConfig, get_policy, llama_params_from_jax
from apex1_tpu_torch.examples import (dcgan_amp, rnnt_speech, serving_llama,
                                      t5_seq2seq)
from apex1_tpu_torch.interop import (dcgan_params_from_jax,
                                     rnnt_params_from_jax,
                                     t5_params_from_jax)

jgen = importlib.import_module("apex1_tpu.models.generate")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
O0 = ["--device", "cpu", "--opt-level", "O0", "--steps", str(STEPS)]


def _script(name: str):
    """The JAX package's ``examples/<name>.py`` as a module (its
    ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _same_params(got: dict, want, lr: float = None):
    """Every leaf within 1e-5 of JAX's. With Adam's learning rate
    ``lr``: at least 99 % of each leaf's elements within 1e-5, every one
    within lr / 2. Adam's update of an element whose gradient is
    rounding noise (a square far below eps², e.g. 1e-19 against 1e-16)
    is lr · g / (|g| + eps), so the two frameworks' noise moves it by
    up to about lr, and the next steps carry that along."""
    want = _flat(want)
    got = {k: v.detach().float().numpy() for k, v in got.items()}
    assert got.keys() == want.keys()
    for k, w in want.items():
        if lr is None:
            np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
            continue
        close = np.isclose(got[k], w, rtol=1e-5, atol=1e-5)
        assert close.mean() >= 0.99, (k, close.mean())
        np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=lr / 2,
                                   err_msg=k)


def test_t5_seq2seq_matches_jax_steps_and_generate():
    jx = _script("t5_seq2seq")
    cfg = JaxT5Config.tiny(vocab_size=32, d_model=128, num_heads=4,
                           head_dim=32, d_ff=256, num_encoder_layers=2,
                           num_decoder_layers=2, policy=jax_get_policy("O0"))
    model = JaxT5(cfg)
    rng = np.random.default_rng(0)
    src, dec = jx.make_batch(rng, 32, 8, cfg.vocab_size)
    params = model.init(jax.random.key(0), src, dec)["params"]
    got = t5_seq2seq.main(O0, model=t5_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), t5_seq2seq.config("O0"),
        "cpu"))
    amp = JaxAmp(jax_fused_adam(1e-3, weight_decay=0.01), opt_level="O0")
    state = amp.init(params)
    want = []
    with jax_common.force_impl("xla"):
        step = jax.jit(amp.make_train_step(jax_t5_loss_fn(
            model, label_pad_id=0)))
        for _ in range(STEPS):
            state, m = step(state, *jx.make_batch(rng, 32, 8,
                                                  cfg.vocab_size))
            want.append(float(m["loss"]))
        src, _ = jx.make_batch(rng, 8, 8, cfg.vocab_size)
        toks = jgen.t5_generate(model, state.params, src, max_new_tokens=8,
                                dec_start_id=1)
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
    _same_params(got["state"].params, state.params, lr=1e-3)
    np.testing.assert_array_equal(got["src"], np.asarray(src))
    np.testing.assert_array_equal(got["tokens"], np.asarray(toks))
    assert got["accuracy"] == float(
        (np.asarray(toks) == np.sort(np.asarray(src), axis=1)).mean())


def test_rnnt_speech_matches_jax_steps_and_greedy_decode():
    jx = _script("rnnt_speech")
    model = jx.RNNT(vocab=8, feat=16)
    rng = np.random.default_rng(0)
    proj = rng.normal(0, 1.0, (8, 16))
    audio, labels, dec_in = jx.make_batch(rng, 16, 5, 3, 8, 16, proj)
    params = model.init(jax.random.key(0), audio, dec_in)["params"]
    got = rnnt_speech.main(O0, model=rnnt_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), 8, 16, device="cpu"))
    f_len = jnp.full((16,), 15, jnp.int32)
    y_len = jnp.full((16,), 5, jnp.int32)

    def loss_fn(p, audio, labels, dec_in):
        return jax_tloss(model.apply({"params": p}, audio, dec_in), labels,
                         f_len, y_len, blank_idx=0)

    amp = JaxAmp(jax_fused_adam(2e-3), opt_level="O0")
    state = amp.init(params)
    step = jax.jit(amp.make_train_step(loss_fn))
    want = []
    for _ in range(STEPS):
        state, m = step(state, *jx.make_batch(rng, 16, 5, 3, 8, 16, proj))
        want.append(float(m["loss"]))
    audio, labels, _ = jx.make_batch(rng, 4, 5, 3, 8, 16, proj)

    class Jitted:                     # the script's decoder, one program
        apply = staticmethod(jax.jit(model.apply))    # a hypothesis length

    hyps = jx.greedy_decode(Jitted, state.params, audio, max_symbols=2)
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
    _same_params(got["state"].params, state.params, lr=2e-3)
    assert got["labels"] == np.asarray(labels).tolist()
    assert got["hyps"] == hyps
    assert got["exact"] == sum(h == w for h, w in zip(hyps, got["labels"]))


def test_dcgan_amp_matches_jax_steps():
    jx = _script("dcgan_amp")
    B, Z = 16, 100
    gen, disc = jx.Generator(dtype=jnp.float32), \
        jx.Discriminator(dtype=jnp.float32)
    key_g, key_d = jax.random.split(jax.random.key(0))
    gvars = gen.init(key_g, jnp.zeros((B, 1, 1, Z), jnp.float32))
    dvars = disc.init(key_d, jnp.zeros((B, 32, 32, 3), jnp.float32))
    pg, pd, stats = dcgan_params_from_jax(
        jax.tree_util.tree_map(np.asarray, gvars),
        jax.tree_util.tree_map(np.asarray, dvars), dtype=torch.float32,
        device="cpu")
    got = dcgan_amp.main(O0, gen=pg, disc=pd, stats=stats)

    def d_loss_fn(d_params, batch):
        real, fake, d_bn = batch
        logits_r, upd = disc.apply({"params": d_params, "batch_stats": d_bn},
                                   real, mutable=["batch_stats"])
        logits_f, upd = disc.apply(
            {"params": d_params, "batch_stats": upd["batch_stats"]}, fake,
            mutable=["batch_stats"])
        loss = jx.bce_logits(logits_r, 1.0) + jx.bce_logits(logits_f, 0.0)
        return loss, upd["batch_stats"]

    def g_loss_fn(g_params, batch):
        z, g_bn, d_params, d_bn = batch
        fake, upd = gen.apply({"params": g_params, "batch_stats": g_bn}, z,
                              mutable=["batch_stats"])
        logits = disc.apply({"params": d_params, "batch_stats": d_bn}, fake,
                            train=False)
        return jx.bce_logits(logits, 1.0), upd["batch_stats"]

    amp_g = JaxAmp(jax_fused_adam(2e-4, b1=0.5, b2=0.999), opt_level="O0")
    amp_d = JaxAmp(jax_fused_adam(2e-4, b1=0.5, b2=0.999), opt_level="O0")
    gstate, dstate = amp_g.init(gvars["params"]), amp_d.init(dvars["params"])
    g_bn, d_bn = gvars["batch_stats"], dvars["batch_stats"]
    d_step = jax.jit(amp_d.make_train_step(d_loss_fn, has_aux=True))
    g_step = jax.jit(amp_g.make_train_step(g_loss_fn, has_aux=True))
    make_fake = jax.jit(lambda p, bn, z: gen.apply(
        {"params": p, "batch_stats": bn}, z, train=False))
    rng = np.random.default_rng(0)
    want_d, want_g = [], []
    for _ in range(STEPS):
        real = jnp.asarray(rng.normal(size=(B, 32, 32, 3)), jnp.float32)
        z = jnp.asarray(rng.normal(size=(B, 1, 1, Z)), jnp.float32)
        fake = make_fake(gstate.params, g_bn, z)
        dstate, dm = d_step(dstate, (real, fake, d_bn))
        d_bn = dm["aux"]
        gstate, gm = g_step(gstate, (z, g_bn, dstate.params, d_bn))
        g_bn = gm["aux"]
        want_d.append(float(dm["loss"]))
        want_g.append(float(gm["loss"]))
    np.testing.assert_allclose(got["losses_d"], want_d, rtol=1e-5)
    np.testing.assert_allclose(got["losses_g"], want_g, rtol=1e-5)
    _same_params(got["gstate"].params, gstate.params, lr=2e-4)
    _same_params(got["dstate"].params, dstate.params, lr=2e-4)
    _same_params(got["g_bn"], g_bn)
    _same_params(got["d_bn"], d_bn)
    assert got["scale_d"] == float(dstate.loss_scale.scale)


@pytest.mark.parametrize("pad,stride,hw", [("SAME", 2, 4), ("VALID", 4, 1),
                                           ("SAME", 2, 8)])
def test_dcgan_conv_transpose_is_flax(pad, stride, hw):
    rng = np.random.default_rng(stride + hw)
    x = rng.normal(size=(2, hw, hw, 5)).astype(np.float32)
    m = nn.ConvTranspose(3, (4, 4), (stride, stride), padding=pad,
                         use_bias=False)
    v = m.init(jax.random.key(1), x)
    want = np.asarray(m.apply(v, x))
    got = dcgan_amp.conv_transpose(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(np.asarray(v["params"]["kernel"])), stride, pad)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the same kernel as nn.ConvTranspose2d's (I, O, kH, kW) weight
    # without the flip is not flax's layer
    k = torch.from_numpy(np.asarray(v["params"]["kernel"]))
    a, _ = dcgan_amp.transpose_padding(4, stride, pad)
    naive = torch.nn.functional.conv_transpose2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), k.permute(2, 3, 0, 1),
        stride=stride, padding=3 - a).permute(0, 2, 3, 1).numpy()
    assert np.abs(naive - want).max() > 1e-3


@pytest.mark.parametrize("pad,stride", [("SAME", 2), ("VALID", 1)])
def test_dcgan_conv_is_flax(pad, stride):
    rng = np.random.default_rng(stride)
    x = rng.normal(size=(2, 8, 8, 5)).astype(np.float32)
    m = nn.Conv(3, (4, 4), (stride, stride), padding=pad, use_bias=False)
    v = m.init(jax.random.key(1), x)
    got = dcgan_amp.conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                         torch.from_numpy(np.asarray(v["params"]["kernel"])),
                         stride, pad).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(m.apply(v, x)), rtol=1e-5,
                               atol=1e-5)


def test_dcgan_batch_norm_is_flax_momentum_and_biased_variance():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(4, 6, 6, 3)) * 3 + 1).astype(np.float32)
    v = {"params": {"scale": rng.normal(size=3).astype(np.float32),
                    "bias": rng.normal(size=3).astype(np.float32)},
         "batch_stats": {"mean": rng.normal(size=3).astype(np.float32),
                         "var": rng.uniform(1, 2, 3).astype(np.float32)}}
    y, upd = nn.BatchNorm(use_running_average=False,
                          dtype=jnp.float32).apply(v, x,
                                                   mutable=["batch_stats"])
    y_eval = nn.BatchNorm(use_running_average=True,
                          dtype=jnp.float32).apply(v, x)
    t = {k: torch.from_numpy(a) for k, a in
         {**v["params"], **v["batch_stats"]}.items()}
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    gy, gm, gv = dcgan_amp.batch_norm(xt, t["scale"], t["bias"], t["mean"],
                                      t["var"], True)
    np.testing.assert_allclose(gy.permute(0, 2, 3, 1).numpy(), y, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(gm.numpy(), upd["batch_stats"]["mean"],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gv.numpy(), upd["batch_stats"]["var"],
                               rtol=1e-6, atol=1e-6)
    # flax's convention, not Apex's: the biased variance, 0.99 · running
    biased = x.reshape(-1, 3).var(0)
    np.testing.assert_allclose(gv.numpy(), 0.99 * v["batch_stats"]["var"]
                               + 0.01 * biased, rtol=1e-5)
    ge, m_e, v_e = dcgan_amp.batch_norm(xt, t["scale"], t["bias"],
                                        t["mean"], t["var"], False)
    np.testing.assert_allclose(ge.permute(0, 2, 3, 1).numpy(), y_eval,
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(m_e, t["mean"]) and torch.equal(v_e, t["var"])


@pytest.fixture(scope="module")
def serving():
    """The port's walkthrough on the JAX package's tiny O0 Llama and its
    one-layer draft (JAX's init keys 0 and 7), and JAX's sections."""
    cfg = JaxLlamaConfig.tiny(policy=jax_get_policy("O0"), max_seq_len=128)
    dcfg = dataclasses.replace(cfg, num_layers=max(1, cfg.num_layers // 4))
    model, draft = JaxLlama(cfg), JaxLlama(dcfg)
    B, S0, N, K, V = 2, 8, 16, 4, cfg.vocab_size
    prompt = jnp.asarray(np.random.default_rng(0).integers(1, V, (B, S0)),
                         jnp.int32)
    params = model.init(jax.random.key(0), prompt)["params"]
    pd = draft.init(jax.random.key(7), prompt)["params"]
    np_ = jax.tree_util.tree_map(np.asarray, (params, pd))
    pcfg = LlamaConfig.tiny(policy=get_policy("O0"), max_seq_len=128)
    got = serving_llama.main(
        ["--tiny", "--device", "cpu"],
        model=llama_params_from_jax(np_[0], pcfg, "cpu"),
        draft=llama_params_from_jax(np_[1], dataclasses.replace(
            pcfg, num_layers=dcfg.num_layers), "cpu"))
    apply_fn, make_cache = jgen.llama_decoder(model)
    d_fn, make_cache_d = jgen.llama_decoder(draft)
    want = {}
    with jax_common.force_impl("xla"):
        want["greedy"] = jgen.generate(apply_fn, params, prompt,
                                       max_new_tokens=N,
                                       cache=make_cache(B, S0 + N),
                                       vocab_size=V)
        want["ragged"] = jgen.generate(
            apply_fn, params, prompt, max_new_tokens=N,
            cache=make_cache(B, S0 + N), vocab_size=V,
            prompt_lens=jnp.asarray([S0, S0 // 2], jnp.int32))
        want["beams"], want["scores"] = jgen.beam_search(
            apply_fn, params, prompt, max_new_tokens=N,
            cache=make_cache(B * K, S0 + N), num_beams=K, length_penalty=1.0,
            vocab_size=V)
        apply_q, make_cache_q, qparams = jax_quant_decoder(model, params)
        want["int8"] = jgen.generate(apply_q, qparams, prompt,
                                     max_new_tokens=N,
                                     cache=make_cache_q(B, S0 + N),
                                     vocab_size=V)
        S = S0 + N + K + 1
        want["speculative"], want["rounds"] = jgen.speculative_generate(
            apply_fn, params, d_fn, pd, prompt, max_new_tokens=N,
            target_cache=make_cache(B, S), draft_cache=make_cache_d(B, S),
            num_draft=K, vocab_size=V)
        Ls = S0 // 2
        _, pre = jax.jit(apply_fn)(params, prompt,
                                   make_cache(B, S0 + Ls + N), 0)
        want["prefix"] = [jgen.generate(
            apply_fn, params, jnp.asarray(np.random.default_rng(
                100 + turn).integers(1, V, (B, Ls)), jnp.int32),
            max_new_tokens=N, cache=pre, cache_start=S0, vocab_size=V)
            for turn in range(2)]
    return got, jax.tree_util.tree_map(np.asarray, want)


@pytest.mark.parametrize("section", ["greedy", "ragged", "beams", "int8",
                                     "speculative", "rounds", "prefix"])
def test_serving_llama_sections_match_jax(serving, section):
    got, want = serving
    np.testing.assert_array_equal(np.asarray(got[section]), want[section])


def test_serving_llama_scores_and_rules(serving):
    got, want = serving
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5)
    # the ragged row against itself alone, speculative against greedy:
    # equal at O0 (the near-tie rule allows no flip)
    np.testing.assert_array_equal(got["ragged"][1], got["alone"][0])
    assert got["ragged_verdict"]["flips"] == []
    assert got["speculative_verdict"]["flips"] == []
    assert got["int8_agreement"] == float(
        (want["int8"] == want["greedy"]).mean())
