"""The port's flash slice as a whole, against the JAX package on the CPU.

- `pack_documents`: the port's NumPy first-fit packing gives the arrays
  of the JAX package's native packer, on several document sets, with
  and without ``restart_chunk_positions``;
- tiny GPT-2 with ``use_flash=True`` from the JAX package's params:
  - O0: the step-0 loss and every grad leaf within 1e-5, on a dense
    batch and on a packed batch (``segment_ids``, ``positions``), the
    JAX flash through its XLA composite and its Pallas kernels in
    interpret mode;
  - O2: a 3-step loss, grad norm and param trajectory within 2e-2;
  - O2_fp16 with an overflow forced at step 2: the step skipped like
    JAX's, its params bit for bit the step-1 params;
- `generate` on a dense cache with a flash prefill: token ids equal to
  JAX ``generate``'s at O0, greedy and at temperature 0.7 with top_k,
  ragged ``prompt_lens``, a ``cache_start`` continuation of a
  ``return_cache`` cache and ``eos_id``; and the same ValueErrors;
- `split` equal to ``jax.random.split`` bit for bit in both threefry
  streams; `cache_attend(valid_start=)` within 1e-6 of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex1_tpu.amp import Amp as JaxAmp
from apex1_tpu.core.policy import get_policy as jax_get_policy
from apex1_tpu.models.generate import generate as jax_generate
from apex1_tpu.models.generate import gpt2_decoder as jax_gpt2_decoder
from apex1_tpu.models.gpt2 import GPT2 as JaxGPT2
from apex1_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from apex1_tpu.models.gpt2 import gpt2_loss_fn as jax_gpt2_loss_fn
from apex1_tpu.ops import _common as jax_common
from apex1_tpu.ops.paged_decode import cache_attend as jax_cache_attend
from apex1_tpu.optim.fused_adam import fused_adam as jax_fused_adam
from apex1_tpu.runtime import pack_documents as jax_pack_documents
from apex1_tpu_torch import (Amp, GPT2Config, fused_adam, get_policy,
                             gpt2_decoder, gpt2_loss_fn, gpt2_params_from_jax)
from apex1_tpu_torch.interop import flax_from_named
from apex1_tpu_torch.models.generate import cached_attention, generate
from apex1_tpu_torch.core.random import split
from apex1_tpu_torch.ops.paged_decode import cache_attend
from apex1_tpu_torch.runtime import pack_documents

B, S = 2, 32


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---- pack_documents ------------------------------------------------------


def _doc_set(name):
    rng = np.random.default_rng({"mixed": 0, "long": 1, "window": 2}[name])
    if name == "mixed":
        lens = rng.integers(1, 40, 25)
    elif name == "long":
        lens = np.concatenate([rng.integers(60, 140, 4), [32, 0, 7, 1]])
    else:
        # more partial rows than the 256-row first-fit window holds
        lens = rng.integers(20, 31, 300)
    return [rng.integers(1, 1000, int(n)).astype(np.int32) for n in lens]


@pytest.mark.parametrize("restart", [False, True])
@pytest.mark.parametrize("docs", ["mixed", "long", "window"])
def test_pack_documents_matches_jax(docs, restart):
    d = _doc_set(docs)
    got = pack_documents(d, 32, pad_id=5, restart_chunk_positions=restart)
    want = jax_pack_documents(d, 32, pad_id=5,
                              restart_chunk_positions=restart)
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="seq_len"):
        pack_documents(d, 0)


# ---- the key stream and decode attention ---------------------------------


@pytest.mark.parametrize("partitionable", [True, False])
def test_split_matches_jax_random_split(partitionable):
    prev = bool(jax.config.jax_threefry_partitionable)
    jax.config.update("jax_threefry_partitionable", partitionable)
    try:
        for seed in (0, 1, 977, 2 ** 31 - 1):
            key = jax.random.key(seed)
            data = tuple(int(x) for x in jax.random.key_data(key))
            for num in (1, 2, 3, 8):
                want = np.asarray(jax.random.key_data(
                    jax.random.split(key, num)))
                got = np.asarray(split(data, num,
                                       partitionable=partitionable))
                np.testing.assert_array_equal(got, want)
            # the chain generate walks: key, sub = split(key)
            jk, tk = key, data
            for _ in range(4):
                jk, jsub = jax.random.split(jk)
                tk, tsub = split(tk, partitionable=partitionable)
                assert tsub == tuple(int(x)
                                     for x in jax.random.key_data(jsub))
    finally:
        jax.config.update("jax_threefry_partitionable", prev)


def test_cache_attend_valid_start_matches_jax():
    rng = np.random.default_rng(4)
    Bc, Hq, Hkv, Sc, Smax, D = 3, 4, 2, 2, 24, 16
    q = rng.standard_normal((Bc, Hq, Sc, D)).astype(np.float32)
    k = rng.standard_normal((Bc, Hkv, Smax, D)).astype(np.float32)
    v = rng.standard_normal((Bc, Hkv, Smax, D)).astype(np.float32)
    start = np.asarray([0, 5, 11], np.int32)
    want = jax_cache_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            14, valid_start=jnp.asarray(start))
    got = cache_attend(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), 14,
                       valid_start=torch.from_numpy(start))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# ---- training ------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    """Tiny GPT-2 (use_flash=True, vocab 250 padded to 256) with the JAX
    package's params, a dense batch and a packed batch."""
    kw = dict(vocab_size=250, use_flash=True)
    jcfg = JaxGPT2Config.tiny(policy=jax_get_policy("O0"), **kw)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 250, (B, S)).astype(np.int32)
    jparams = jax.jit(JaxGPT2(jcfg).init)(jax.random.key(0),
                                          jnp.asarray(tokens))["params"]
    docs = [rng.integers(0, 250, int(n)).astype(np.int32)
            for n in rng.integers(3, 45, 6)]
    packed = pack_documents(docs, S, restart_chunk_positions=True)
    return dict(kw=kw, tokens=tokens, jparams=jparams, packed=packed)


def _batch(tiny, packed):
    if not packed:
        return (tiny["tokens"],)
    return tiny["packed"]


def _port_model(tiny, level):
    cfg = GPT2Config.tiny(policy=get_policy(level), **tiny["kw"])
    return gpt2_params_from_jax(_np_tree(tiny["jparams"]), cfg, "cpu")


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_o0_loss_and_every_grad_leaf_match_jax(tiny, packed, impl):
    batch = _batch(tiny, packed)
    cfg = JaxGPT2Config.tiny(policy=jax_get_policy("O0"), **tiny["kw"])
    with jax_common.force_impl(impl):
        jloss, jgrads = jax.jit(jax.value_and_grad(
            jax_gpt2_loss_fn(JaxGPT2(cfg), fuse_head=False)))(
            tiny["jparams"], *map(jnp.asarray, batch))
    model = _port_model(tiny, "O0")
    params = dict(model.named_parameters())
    loss = gpt2_loss_fn(model, fuse_head=False)(
        params, *map(torch.from_numpy, batch))
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(_np_tree(jgrads)))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(
        flax_from_named(dict(zip(params, grads)))))
    assert flat_g.keys() == flat_w.keys()
    for k, w in flat_w.items():
        np.testing.assert_allclose(flat_g[k], w, rtol=1e-5, atol=1e-5,
                                   err_msg=str(k))


def _jax_run(tiny, level, steps, packed, overflow_at=None):
    cfg = JaxGPT2Config.tiny(policy=jax_get_policy(level), **tiny["kw"])
    base = jax_gpt2_loss_fn(JaxGPT2(cfg), fuse_head=False)
    amp = JaxAmp(jax_fused_adam(1e-3, weight_decay=0.01), opt_level=level)
    state = amp.init(tiny["jparams"])
    step = jax.jit(amp.make_train_step(
        lambda p, f, *b: base(p, *b) * f))
    batch = [jnp.asarray(a) for a in _batch(tiny, packed)]
    out = []
    for i in range(steps):
        f = jnp.float32(jnp.inf if i == overflow_at else 1.0)
        state, m = step(state, f, *batch)
        out.append((_np_tree(state), _np_tree(m)))
    return out


def _port_run(tiny, level, steps, packed, overflow_at=None):
    model = _port_model(tiny, level)
    base = gpt2_loss_fn(model, fuse_head=False)
    amp = Amp(fused_adam(1e-3, weight_decay=0.01), opt_level=level)
    state = amp.init(dict(model.named_parameters()))
    step = amp.make_train_step(lambda p, f, *b: base(p, *b) * f)
    batch = [torch.from_numpy(a) for a in _batch(tiny, packed)]
    out = []
    for i in range(steps):
        f = torch.tensor(float("inf") if i == overflow_at else 1.0)
        state, m = step(state, f, *batch)
        out.append((state, {k: v.numpy() for k, v in m.items()}))
    return out


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_o2_three_step_trajectory_matches_jax(tiny, packed):
    want = _jax_run(tiny, "O2", 3, packed)
    got = _port_run(tiny, "O2", 3, packed)
    for (js, jm), (ts, tm) in zip(want, got):
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=2e-2)
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"],
                                   rtol=2e-2)
        # distance over all params relative to their norm (see
        # test_torch_amp.py: bf16 noise can flip Adam's sign on grads
        # near 0)
        got_l = jax.tree_util.tree_leaves(flax_from_named(ts.params))
        want_l = jax.tree_util.tree_leaves(js.params)
        dist = np.sqrt(sum(np.sum((g - w) ** 2)
                           for g, w in zip(got_l, want_l)))
        norm = np.sqrt(sum(np.sum(w ** 2) for w in want_l))
        assert dist <= 2e-2 * norm, dist / norm
    assert got[-1][1]["loss"] < got[0][1]["loss"]


def test_o2_fp16_forced_overflow_skips_like_jax(tiny):
    want = _jax_run(tiny, "O2_fp16", 3, True, overflow_at=1)
    got = _port_run(tiny, "O2_fp16", 3, True, overflow_at=1)
    for (_, jm), (_, tm) in zip(want, got):
        for k in ("skipped_steps", "loss_scale", "grads_finite"):
            assert tm[k].item() == jm[k].item(), k
    assert [m["grads_finite"].item() for _, m in got] == [True, False, True]
    before, after = got[0][0], got[1][0]
    for k in before.params:
        assert torch.equal(after.params[k], before.params[k]), k
    assert after.opt_state.step.item() == 1


def test_packed_batch_needs_flash_and_dropout_key_rules(tiny):
    cfg = GPT2Config.tiny(policy=get_policy("O0"), vocab_size=250,
                          use_flash=False)
    model = gpt2_params_from_jax(_np_tree(tiny["jparams"]), cfg, "cpu")
    toks, segs, pos = map(torch.from_numpy, tiny["packed"])
    with pytest.raises(ValueError, match="use_flash=True"):
        model(toks, segment_ids=segs, positions=pos)
    loss_fn = gpt2_loss_fn(_port_model(tiny, "O0"), fuse_head=False)
    params = dict(_port_model(tiny, "O0").named_parameters())
    with pytest.raises(ValueError, match="dropout"):
        loss_fn(params, toks, dropout_rng=(0, 1))


# ---- generate ------------------------------------------------------------


@pytest.fixture(scope="module")
def gen():
    jcfg = JaxGPT2Config.tiny(policy=jax_get_policy("O0"))
    rng = np.random.default_rng(21)
    prompts = rng.integers(1, jcfg.vocab_size, (3, 12)).astype(np.int32)
    jmodel = JaxGPT2(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.key(1),
                                   jnp.asarray(prompts))["params"]
    model = gpt2_params_from_jax(_np_tree(jparams),
                                 GPT2Config.tiny(policy=get_policy("O0")),
                                 "cpu")
    japply, jmake = jax_gpt2_decoder(jmodel)
    tapply, tmake = gpt2_decoder(model)
    return dict(prompts=prompts, jparams=jparams, japply=japply,
                jmake=jmake, tapply=tapply, tmake=tmake,
                vocab=jcfg.vocab_size)


def _both_generate(gen, prompts, n_new, cache_len=32, **kw):
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    want = jax_generate(gen["japply"], gen["jparams"], jnp.asarray(prompts),
                        max_new_tokens=n_new,
                        cache=gen["jmake"](prompts.shape[0], cache_len),
                        **jkw)
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    got = generate(gen["tapply"], torch.from_numpy(prompts),
                   max_new_tokens=n_new,
                   cache=gen["tmake"](prompts.shape[0], cache_len), **tkw)
    return got, want


@pytest.mark.parametrize("sampling", [dict(), dict(temperature=0.7, top_k=20),
                                      dict(temperature=1.3)],
                         ids=["greedy", "t0.7_top20", "t1.3"])
@pytest.mark.parametrize("ragged", [False, True], ids=["dense", "ragged"])
def test_generate_matches_jax(gen, sampling, ragged):
    kw = dict(sampling)
    if ragged:
        kw["prompt_lens"] = np.asarray([12, 5, 1], np.int32)
    got, want = _both_generate(gen, gen["prompts"], 8, **kw)
    assert got.dtype == torch.int32 and got.shape == (3, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_continues_a_returned_cache_like_jax(gen):
    prompts = gen["prompts"]
    (t1, c1), (j1, jc1) = _both_generate(gen, prompts, 5, return_cache=True,
                                         temperature=0.7)
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1))
    cont = np.concatenate([t1.numpy()[:, -1:], prompts[:, :3]], axis=1)
    start = prompts.shape[1] + 5 - 1
    want = jax_generate(gen["japply"], gen["jparams"], jnp.asarray(cont),
                        max_new_tokens=6, cache=jc1, cache_start=start)
    got = generate(gen["tapply"], torch.from_numpy(cont), max_new_tokens=6,
                   cache=c1, cache_start=start)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_eos_pads_like_jax(gen):
    greedy, _ = _both_generate(gen, gen["prompts"], 8)
    eos = int(greedy[0, 2])
    got, want = _both_generate(gen, gen["prompts"], 8, eos_id=eos,
                               pad_id=255)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[0, 3:] == 255).all()


def test_generate_raises_like_jax(gen):
    p = torch.from_numpy(gen["prompts"])
    lens = torch.tensor([12, 5, 1])
    cases = [
        (dict(cache=gen["tmake"](3, 16), max_new_tokens=8), "cache holds"),
        (dict(cache=gen["tmake"](3, 32), max_new_tokens=4,
              return_cache=True, prompt_lens=lens), "return_cache"),
        (dict(cache=gen["tmake"](3, 32), max_new_tokens=4, cache_start=2,
              prompt_lens=lens), "cache_start"),
        (dict(cache=gen["tmake"](3, 32), max_new_tokens=4,
              prompt_lens=torch.tensor([12, 0, 3])), "prompt_lens"),
    ]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            generate(gen["tapply"], p, **kw)
    with pytest.raises(ValueError, match="empty cache at cache_index 0"):
        gen["tapply"](p, gen["tmake"](3, 32), 3)
    q = torch.zeros(3, 4, 12, 32)
    with pytest.raises(ValueError, match="cache_index 0"):
        cached_attention(q, q, q, gen["tmake"](3, 32)["layer0"], 2)
