"""GPT-2's training dropout, the port against the JAX package on the CPU.

Tiny GPT-2 (``use_flash=True``, dropout 0.1, vocab 250 padded to 256)
from the JAX package's params: attention-probability dropout in the
flash path and both residual adds through ``fused_bias_dropout_add``.
JAX's per-block seeds (``seed_from_key`` of its ``dropout`` rng) are
recorded by wrapping the function with ``monkeypatch`` and handed to
the port as its per-layer ``dropout_rng``:

- O0: the loss and every grad leaf of ``gpt2_loss_fn`` within 1e-5 of
  JAX's, with the fused and the materialized head, on a dense and a
  packed batch, JAX through its XLA composites (and, for the fused
  head, its Pallas kernels in interpret mode);
- ``use_flash=False`` with dropout raises as in JAX; the forward needs
  seeds; an int base seed folds per layer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex1_tpu.models.gpt2 as jax_gpt2
from apex1_tpu.core.policy import get_policy as jax_get_policy
from apex1_tpu.models.gpt2 import GPT2 as JaxGPT2
from apex1_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from apex1_tpu.models.gpt2 import gpt2_loss_fn as jax_gpt2_loss_fn
from apex1_tpu.ops import _common as jax_common
from apex1_tpu_torch import (GPT2Config, get_policy, gpt2_loss_fn,
                             gpt2_params_from_jax)
from apex1_tpu_torch.interop import flax_from_named
from apex1_tpu_torch.ops.stochastic import fold_seed
from apex1_tpu_torch.runtime import pack_documents

B, S = 2, 32
KW = dict(vocab_size=250, use_flash=True, dropout=0.1)
KEY = 21


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def _jcfg(**kw):
    return JaxGPT2Config.tiny(policy=jax_get_policy("O0"), **dict(KW, **kw))


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.default_rng(12)
    tokens = rng.integers(0, 250, (B, S)).astype(np.int32)
    jparams = jax.jit(JaxGPT2(_jcfg()).init)(jax.random.key(3),
                                             jnp.asarray(tokens))["params"]
    docs = [rng.integers(0, 250, int(n)).astype(np.int32)
            for n in rng.integers(3, 45, 6)]
    packed = pack_documents(docs, S, restart_chunk_positions=True)
    seen = []
    orig = jax_gpt2.seed_from_key

    def recording(key):
        s = orig(key)
        seen.append(int(s))
        return s

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_gpt2, "seed_from_key", recording)
        jax_gpt2_loss_fn(JaxGPT2(_jcfg()))(jparams, jnp.asarray(tokens),
                                           dropout_rng=jax.random.key(KEY))
    assert len(seen) == _jcfg().num_layers
    return dict(tokens=tokens, jparams=jparams, packed=packed, seeds=seen)


def _batch(tiny, packed):
    return tiny["packed"] if packed else (tiny["tokens"],)


def _port_model(tiny, **kw):
    cfg = GPT2Config.tiny(policy=get_policy("O0"), **dict(KW, **kw))
    return gpt2_params_from_jax(_np_tree(tiny["jparams"]), cfg, "cpu")


@pytest.mark.parametrize("fuse_head,packed,impl", [
    (True, False, "xla"), (True, False, "pallas"), (True, True, "xla"),
    (True, True, "pallas"), (False, False, "xla"), (False, True, "xla")])
def test_o0_dropout_loss_and_every_grad_leaf_match_jax(tiny, fuse_head,
                                                        packed, impl):
    batch = _batch(tiny, packed)
    jb = list(map(jnp.asarray, batch)) + [None] * (3 - len(batch))
    with jax_common.force_impl(impl):
        wl, wg = jax.jit(jax.value_and_grad(
            lambda p, *b: jax_gpt2_loss_fn(JaxGPT2(_jcfg()),
                                           fuse_head=fuse_head)(
                p, *b, dropout_rng=jax.random.key(KEY))))(
            tiny["jparams"], *jb)
    model = _port_model(tiny)
    params = dict(model.named_parameters())
    tb = list(map(torch.from_numpy, batch)) + [None] * (3 - len(batch))
    loss = gpt2_loss_fn(model, fuse_head=fuse_head)(
        params, *tb, dropout_rng=torch.tensor(tiny["seeds"]))
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(loss.item(), float(wl), rtol=1e-5)
    got = _leaves(flax_from_named(dict(zip(params, grads))))
    want = _leaves(_np_tree(wg))
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-5,
                                   err_msg=str(k))


def test_dropout_rules(tiny):
    tokens = torch.from_numpy(tiny["tokens"])
    model = _port_model(tiny, use_flash=False)
    with pytest.raises(ValueError, match="use_flash=True"):
        model(tokens, deterministic=False, dropout_seeds=3)
    with pytest.raises(ValueError, match="use_flash=True"):
        jax_gpt2_loss_fn(JaxGPT2(_jcfg(use_flash=False)))(
            tiny["jparams"], jnp.asarray(tiny["tokens"]),
            dropout_rng=jax.random.key(KEY))
    model = _port_model(tiny)
    with pytest.raises(ValueError, match="dropout_seeds"):
        model(tokens, deterministic=False)
    params = dict(model.named_parameters())
    fn = gpt2_loss_fn(model)
    a = fn(params, tokens, dropout_rng=5)
    b = fn(params, tokens, dropout_rng=[fold_seed(5, i) for i in range(2)])
    assert a.item() == b.item() != fn(params, tokens).item()
