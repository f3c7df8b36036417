"""The port's fused multi-head attention modules against the JAX
package's (``apex1_tpu/contrib/multihead_attn.py``), on the CPU.

The flax modules' params go into the port's modules
(`interop.mha_params_from_jax`); the same numpy (S, B, E) inputs go
through both, as tests/test_multihead_attn.py drives the JAX modules:
self-attention causal and not, an additive key-padding mask (riding
flash's bias, which takes no gradient), norm_add, separate QKV, the
encoder-decoder module, and the gradients of every parameter and of the
input. With dropout the JAX module's int32 seed (``seed_from_key`` of its
``dropout`` rng, recorded by wrapping the function with ``monkeypatch``)
is handed to the port as ``dropout_seed``: the dropped positions must be
the same bit for bit, the outputs within fp32 1e-5. JAX runs its XLA
composites, and its Pallas kernels in interpret mode for the masked
norm_add case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex1_tpu.contrib.multihead_attn as jax_mha
import apex1_tpu_torch.ops.attention as tattn
from apex1_tpu.ops import _common as jax_common
from apex1_tpu_torch import EncdecMultiheadAttn, SelfMultiheadAttn
from apex1_tpu_torch.interop import mha_params_from_jax
from apex1_tpu_torch.ops import NEG_INF

S, SK, B, E, H = 24, 16, 2, 32, 4
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(S, B, E)).astype(np.float32)
    kv = rng.normal(size=(SK, B, E)).astype(np.float32)
    mask = np.where(rng.random((B, 1, 1, S)) < 0.3, NEG_INF,
                    0.0).astype(np.float32)
    return x, kv, mask


#: name -> (module kwargs, causal, with mask)
SELF_CASES = {
    "plain": (dict(), False, False),
    "causal": (dict(), True, False),
    "mask": (dict(), False, True),
    "norm_add_mask_bias": (dict(include_norm_add=True, bias=True), True,
                           True),
    "separate_qkv": (dict(separate_qkv_params=True), False, False),
}


def _self_pair(kw):
    x, _, _ = _inputs()
    jm = jax_mha.SelfMultiheadAttn(embed_dim=E, num_heads=H, **kw)
    params = _np(jm.init(jax.random.key(0), jnp.asarray(x))["params"])
    tm = mha_params_from_jax(params, SelfMultiheadAttn(E, H, device="cpu",
                                                       **kw))
    return jm, params, tm


def _jax_self(jm, params, x, causal, mask, impl="xla", key=None):
    """(out, grads of Σ out·w for params and x)."""
    w = jnp.asarray(np.random.default_rng(5).normal(size=x.shape),
                    jnp.float32)
    kw = dict(causal=causal, attn_mask=None if mask is None
              else jnp.asarray(mask), is_training=key is not None)
    rngs = {} if key is None else {"dropout": key}

    def f(p, x):
        out = jm.apply({"params": p}, x, rngs=rngs, **kw)
        return jnp.sum(out * w), out

    with jax_common.force_impl(impl):
        (_, out), g = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    return np.asarray(out), _np(g)


def _port_self(tm, x, causal, mask, seed=None):
    w = torch.from_numpy(np.random.default_rng(5).normal(size=x.shape)
                         .astype(np.float32))
    xt = torch.from_numpy(x).requires_grad_()
    out = tm(xt, causal=causal,
             attn_mask=None if mask is None else torch.from_numpy(mask),
             is_training=seed is not None, dropout_seed=seed)
    (out * w).sum().backward()
    grads = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    return out.detach().numpy(), grads, xt.grad.numpy()


def _assert_grads(got_p, got_x, want):
    gp, gx = want
    assert set(got_p) == set(gp)
    for n, g in gp.items():
        np.testing.assert_allclose(got_p[n], g, err_msg=n, **TOL)
    np.testing.assert_allclose(got_x, gx, err_msg="dx", **TOL)


@pytest.mark.parametrize("name", list(SELF_CASES))
def test_self_attn_and_grads_match_jax(name):
    kw, causal, with_mask = SELF_CASES[name]
    x, _, mask = _inputs()
    mask = mask if with_mask else None
    jm, params, tm = _self_pair(kw)
    want_out, want_g = _jax_self(jm, params, x, causal, mask)
    out, gp, gx = _port_self(tm, x, causal, mask)
    np.testing.assert_allclose(out, want_out, **TOL)
    _assert_grads(gp, gx, want_g)


def test_masked_norm_add_matches_jax_pallas():
    kw, causal, _ = SELF_CASES["norm_add_mask_bias"]
    x, _, mask = _inputs(1)
    jm, params, tm = _self_pair(kw)
    want_out, want_g = _jax_self(jm, params, x, causal, mask, impl="pallas")
    out, gp, gx = _port_self(tm, x, causal, mask)
    np.testing.assert_allclose(out, want_out, **TOL)
    _assert_grads(gp, gx, want_g)


def test_norm_add_with_a_zero_projection_is_the_residual():
    x, _, _ = _inputs()
    _, _, tm = _self_pair(dict(include_norm_add=True))
    with torch.no_grad():
        tm.out_proj_weight.zero_()
    out = tm(torch.from_numpy(x), is_training=False)
    assert torch.equal(out, torch.from_numpy(x))


def _recorded_seed(jm, params, x, key, **kw):
    """The int32 seed the JAX module draws from ``key``."""
    seen = []
    orig = jax_mha.seed_from_key

    def recording(k):
        s = orig(k)
        seen.append(int(s))
        return s

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_mha, "seed_from_key", recording)
        jm.apply({"params": params}, *x, is_training=True,
                 rngs={"dropout": key}, **kw)
    assert len(seen) == 1
    return seen[0]


@pytest.mark.parametrize("causal", [False, True])
def test_dropout_masks_bitwise_and_outputs_match_jax(causal):
    kw = dict(dropout=0.5, include_norm_add=True)
    x, _, mask = _inputs(2)
    jm, params, tm = _self_pair(kw)
    key = jax.random.key(11)
    seed = _recorded_seed(jm, params, (jnp.asarray(x),), key,
                          attn_mask=jnp.asarray(mask), causal=causal)
    want_out, want_g = _jax_self(jm, params, x, causal, mask, key=key)
    out, gp, gx = _port_self(tm, x, causal, mask, seed=seed)
    # the norm_add epilogue's dropped positions leave the residual
    np.testing.assert_array_equal(out == x, want_out == x)
    assert 0.3 < (out == x).mean() < 0.7
    np.testing.assert_allclose(out, want_out, **TOL)
    _assert_grads(gp, gx, want_g)
    # another seed draws other masks; evaluation has none
    other, _, _ = _port_self(tm, x, causal, mask, seed=seed + 1)
    assert not np.allclose(other, out)
    with pytest.raises(ValueError, match="dropout_seed"):
        tm(torch.from_numpy(x), is_training=True)


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_encdec_attn_matches_jax(dropout):
    x, kv, _ = _inputs(3)
    kmask = np.where(np.arange(SK)[None, None, None, :] >= SK - 3, NEG_INF,
                     0.0).astype(np.float32).repeat(B, 0)
    kw = dict(dropout=dropout, include_norm_add=True, bias=True)
    jm = jax_mha.EncdecMultiheadAttn(embed_dim=E, num_heads=H, **kw)
    params = _np(jm.init(jax.random.key(1), jnp.asarray(x),
                         jnp.asarray(kv))["params"])
    tm = mha_params_from_jax(params, EncdecMultiheadAttn(E, H, device="cpu",
                                                         **kw))
    key = jax.random.key(4) if dropout else None
    seed = (_recorded_seed(jm, params, (jnp.asarray(x), jnp.asarray(kv)),
                           key, attn_mask=jnp.asarray(kmask))
            if dropout else None)
    rngs = {} if key is None else {"dropout": key}

    def f(p, x, kv):
        out = jm.apply({"params": p}, x, kv, attn_mask=jnp.asarray(kmask),
                       is_training=bool(dropout), rngs=rngs)
        return jnp.sum(out ** 2), out

    (_, want), (gp, gx, gkv) = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x),
            jnp.asarray(kv))
    xt, kvt = (torch.from_numpy(a).requires_grad_() for a in (x, kv))
    out = tm(xt, kvt, attn_mask=torch.from_numpy(kmask),
             is_training=bool(dropout), dropout_seed=seed)
    (out ** 2).sum().backward()
    assert out.shape == (S, B, E)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp[n]),
                                   err_msg=n, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    np.testing.assert_allclose(kvt.grad.numpy(), np.asarray(gkv), **TOL)


def test_masks_launch_no_dbias_and_params_must_fit(monkeypatch):
    calls = []
    real = tattn.flash_dbias
    monkeypatch.setattr(tattn, "flash_dbias",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    x, _, mask = _inputs()
    _, params, tm = _self_pair(dict(include_norm_add=True))
    xt = torch.from_numpy(x).requires_grad_()
    tm(xt, attn_mask=torch.from_numpy(mask), is_training=False).sum() \
        .backward()
    assert calls == [] and xt.grad is not None
    with pytest.raises(ValueError, match="do not fit"):
        mha_params_from_jax(params, SelfMultiheadAttn(E, H, device="cpu"))
    with pytest.raises(ValueError, match="multiple"):
        SelfMultiheadAttn(30, 4, device="cpu")
