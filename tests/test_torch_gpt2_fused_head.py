"""GPT-2 with the fused LM-head cross-entropy (``fuse_head=True``), the
port against the JAX package on the CPU.

Tiny GPT-2 (``use_flash=True``, vocab 250 padded to 256, so the head
masks padded vocab rows) from the JAX package's params:

- O0: the step-0 loss and every grad leaf of ``gpt2_loss_fn(fuse_head=
  True)`` within 1e-5 of JAX's, on a dense and a packed batch, the JAX
  side through its XLA composites and through its Pallas kernels in
  interpret mode;
- O0: ``fuse_head=True`` against ``fuse_head=False`` on the same
  weights (the same function): loss and grads within 1e-5;
- O2: a 3-step loss, grad norm and param trajectory within 2e-2 of
  JAX's (bf16 roundings of G, dx, dW and the activations);
- O2_fp16 with an overflow forced at step 2: the step skipped like
  JAX's, its params bit for bit the step-1 params.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex1_tpu.amp import Amp as JaxAmp
from apex1_tpu.core.policy import get_policy as jax_get_policy
from apex1_tpu.models.gpt2 import GPT2 as JaxGPT2
from apex1_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from apex1_tpu.models.gpt2 import gpt2_loss_fn as jax_gpt2_loss_fn
from apex1_tpu.ops import _common as jax_common
from apex1_tpu.optim.fused_adam import fused_adam as jax_fused_adam
from apex1_tpu_torch import (Amp, GPT2Config, fused_adam, get_policy,
                             gpt2_loss_fn, gpt2_params_from_jax)
from apex1_tpu_torch.interop import flax_from_named
from apex1_tpu_torch.runtime import pack_documents

B, S = 2, 32


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    kw = dict(vocab_size=250, use_flash=True)
    jcfg = JaxGPT2Config.tiny(policy=jax_get_policy("O0"), **kw)
    rng = np.random.default_rng(10)
    tokens = rng.integers(0, 250, (B, S)).astype(np.int32)
    jparams = jax.jit(JaxGPT2(jcfg).init)(jax.random.key(3),
                                          jnp.asarray(tokens))["params"]
    docs = [rng.integers(0, 250, int(n)).astype(np.int32)
            for n in rng.integers(3, 45, 6)]
    packed = pack_documents(docs, S, restart_chunk_positions=True)
    return dict(kw=kw, tokens=tokens, jparams=jparams, packed=packed)


def _batch(tiny, packed):
    return tiny["packed"] if packed else (tiny["tokens"],)


def _port_model(tiny, level):
    cfg = GPT2Config.tiny(policy=get_policy(level), **tiny["kw"])
    return gpt2_params_from_jax(_np_tree(tiny["jparams"]), cfg, "cpu")


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def _port_loss_and_grads(tiny, batch, fuse_head):
    model = _port_model(tiny, "O0")
    params = dict(model.named_parameters())
    loss = gpt2_loss_fn(model, fuse_head=fuse_head)(
        params, *map(torch.from_numpy, batch))
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.item(), _leaves(flax_from_named(dict(zip(params, grads))))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_o0_loss_and_every_grad_leaf_match_jax(tiny, packed, impl):
    batch = _batch(tiny, packed)
    cfg = JaxGPT2Config.tiny(policy=jax_get_policy("O0"), **tiny["kw"])
    with jax_common.force_impl(impl):
        jloss, jgrads = jax.jit(jax.value_and_grad(
            jax_gpt2_loss_fn(JaxGPT2(cfg), fuse_head=True)))(
            tiny["jparams"], *map(jnp.asarray, batch))
    loss, grads = _port_loss_and_grads(tiny, batch, fuse_head=True)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    want = _leaves(_np_tree(jgrads))
    assert grads.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(grads[k], w, rtol=1e-5, atol=1e-5,
                                   err_msg=str(k))


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_fused_head_equals_materialized_head(tiny, packed):
    batch = _batch(tiny, packed)
    lf, gf = _port_loss_and_grads(tiny, batch, fuse_head=True)
    lm, gm = _port_loss_and_grads(tiny, batch, fuse_head=False)
    np.testing.assert_allclose(lf, lm, rtol=1e-5)
    for k in gm:
        np.testing.assert_allclose(gf[k], gm[k], rtol=1e-5, atol=1e-5,
                                   err_msg=str(k))


def _jax_run(tiny, level, steps, overflow_at=None):
    cfg = JaxGPT2Config.tiny(policy=jax_get_policy(level), **tiny["kw"])
    base = jax_gpt2_loss_fn(JaxGPT2(cfg), fuse_head=True)
    amp = JaxAmp(jax_fused_adam(1e-3, weight_decay=0.01), opt_level=level)
    state = amp.init(tiny["jparams"])
    step = jax.jit(amp.make_train_step(lambda p, f, t: base(p, t) * f))
    out = []
    for i in range(steps):
        f = jnp.float32(jnp.inf if i == overflow_at else 1.0)
        state, m = step(state, f, jnp.asarray(tiny["tokens"]))
        out.append((_np_tree(state), _np_tree(m)))
    return out


def _port_run(tiny, level, steps, overflow_at=None):
    model = _port_model(tiny, level)
    base = gpt2_loss_fn(model)
    amp = Amp(fused_adam(1e-3, weight_decay=0.01), opt_level=level)
    state = amp.init(dict(model.named_parameters()))
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
    want = _jax_run(tiny, "O2_fp16", 3, overflow_at=1)
    got = _port_run(tiny, "O2_fp16", 3, overflow_at=1)
    for (_, jm), (_, tm) in zip(want, got):
        for k in ("skipped_steps", "loss_scale", "grads_finite"):
            assert tm[k].item() == jm[k].item(), k
    assert [m["grads_finite"].item() for _, m in got] == [True, False, True]
    before, after = got[0][0], got[1][0]
    for k in before.params:
        assert torch.equal(after.params[k], before.params[k]), k
