"""BERT's fused MLM head in 16-byte rows: the port appends the decoder
bias as a ones column and then zero columns up to a multiple of 8
(``bert_pretrain_loss_fn(fuse_head=True)``); the JAX package keeps width
H + 1. On the tiny config (hidden 64: 65 padded to 72) the port's loss
and every grad leaf, the word embeddings and ``mlm_bias`` included, must
match JAX's H + 1 head within 1e-5 (fp32, O0), with JAX through its XLA
composite and its Pallas kernels in interpret mode; and the head must
reach `linear_cross_entropy` padded, with the pad columns zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex1_tpu_torch.models.bert as port_bert
from apex1_tpu.core.policy import get_policy as jax_get_policy
from apex1_tpu.models.bert import BertConfig as JaxBertConfig
from apex1_tpu.models.bert import BertPretrain as JaxBertPretrain
from apex1_tpu.models.bert import bert_pretrain_loss_fn as jax_loss_fn
from apex1_tpu.ops import _common as jax_common
from apex1_tpu_torch import (BertConfig, bert_params_from_jax,
                             bert_pretrain_loss_fn, get_policy)
from apex1_tpu_torch.interop import flax_from_named

B, S = 2, 24


@pytest.fixture(scope="module")
def tiny():
    cfg = JaxBertConfig.tiny(policy=jax_get_policy("O0"))
    rng = np.random.default_rng(41)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {
        "tokens": tokens,
        "token_types": (np.arange(S)[None] >= S // 2).repeat(B, 0).astype(
            np.int32),
        "attention_mask": np.ones((B, S), np.int32),
        # a few more masked tokens than the 15 % draw, so that most vocab
        # rows of W see a gradient from more than one token
        "mlm_labels": np.where(rng.random((B, S)) < 0.3,
                               rng.integers(0, cfg.vocab_size, (B, S)),
                               -1).astype(np.int32),
        "nsp_labels": rng.integers(0, 2, (B,)).astype(np.int32)}
    jparams = jax.jit(JaxBertPretrain(cfg).init)(
        jax.random.key(6), jnp.asarray(tokens))["params"]
    return dict(cfg=cfg, batch=batch, jparams=jparams,
                np_params=jax.tree_util.tree_map(np.asarray, jparams))


def _port(tiny):
    model = bert_params_from_jax(
        tiny["np_params"], BertConfig.tiny(policy=get_policy("O0")), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in tiny["batch"].items()}
    return model, dict(model.named_parameters()), batch


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_padded_head_matches_jax_h_plus_1_head(tiny, impl):
    with jax_common.force_impl(impl):
        wl, wg = jax.jit(jax.value_and_grad(jax_loss_fn(
            JaxBertPretrain(tiny["cfg"]), fuse_head=True)))(
                tiny["jparams"],
                {k: jnp.asarray(v) for k, v in tiny["batch"].items()})
    model, params, batch = _port(tiny)
    loss = bert_pretrain_loss_fn(model, fuse_head=True)(params, batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(loss.item(), float(wl), rtol=1e-5)
    got = dict(jax.tree_util.tree_leaves_with_path(
        flax_from_named(dict(zip(params, grads)))))
    want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, wg)))
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-5,
                                   err_msg=str(k))
    # the leaves the head's padding touches, named
    names = {jax.tree_util.keystr(k) for k in want}
    assert any("word_embeddings" in n for n in names)
    assert any("mlm_bias" in n for n in names)


def test_head_reaches_linear_xent_padded_to_a_multiple_of_8(tiny,
                                                            monkeypatch):
    seen = []
    orig = port_bert.linear_cross_entropy

    def spy(x, w, labels, **kw):
        seen.append((x.detach().clone(), w.detach().clone()))
        return orig(x, w, labels, **kw)

    monkeypatch.setattr(port_bert, "linear_cross_entropy", spy)
    model, params, batch = _port(tiny)
    bert_pretrain_loss_fn(model, fuse_head=True)(params, batch)
    (x, w), = seen
    H = tiny["cfg"].hidden_size
    assert x.shape[-1] == w.shape[-1] == 72 == -(-(H + 1) // 8) * 8
    assert torch.equal(x[..., H], torch.ones_like(x[..., H]))
    assert not x[..., H + 1:].any() and not w[:, H + 1:].any()
    assert torch.equal(w[:, H], params["mlm_bias"].detach())
    assert torch.equal(w[:, :H], params["bert.word_embeddings"].detach())

