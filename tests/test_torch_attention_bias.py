"""The port's flash attention with the additive ``bias`` operand against
the JAX package's, on the CPU.

The same numpy q, k, v and bias go through
``apex1_tpu.ops.attention.flash_attention(bias=...)`` under
``jax.value_and_grad`` (its XLA composite, and its Pallas kernels in
interpret mode: the dbias pass ``_dbias_kernel`` among them) and through
the port's plain path under autograd. The loss is Σ out², as in
tests/test_attention.py, whose five broadcast layouts this file repeats
(full, gqa-causal, cross-batchbias, ragged-bcast, multiblock) with its
tolerances: loss rtol 1e-5; dq, dk, dv rtol 1e-4, atol 1e-5; dbias atol
5e-5. Also: bias with segment ids, bias with dropout 0.1 (dbias against
JAX's, and against autograd through a composite that applies the
forward's keep mask), a bias row of NEG_INF on every key (the mask, not
the bias, decides the empty-row rule), a bf16 bias (its gradient comes
back in bf16), the shape errors, and a bias that takes no gradient
launching no dbias.

The CUDA kernels are held against the same plain versions on the card
(tests/test_torch_kernels_gpu.py and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex1_tpu_torch.ops.attention as tattn
from apex1_tpu.ops import _common as jax_common
from apex1_tpu.ops.attention import flash_attention as jax_flash
from apex1_tpu_torch.ops import NEG_INF
from apex1_tpu_torch.ops.attention import _keep, flash_attention
from apex1_tpu_torch.ops.stochastic import inv_keep

#: tests/test_attention.py::TestAdditiveBias's layouts
LAYOUTS = {
    "full": dict(B=2, Hq=4, Hkv=4, Sq=48, Sk=48, Bb=1, Hb=4, causal=False),
    "gqa-causal": dict(B=2, Hq=4, Hkv=2, Sq=48, Sk=48, Bb=1, Hb=4,
                       causal=True),
    "cross-batchbias": dict(B=2, Hq=4, Hkv=4, Sq=40, Sk=56, Bb=2, Hb=4,
                            causal=False),
    "ragged-bcast": dict(B=1, Hq=2, Hkv=2, Sq=33, Sk=47, Bb=1, Hb=1,
                         causal=False),
    "multiblock": dict(B=2, Hq=2, Hkv=2, Sq=96, Sk=96, Bb=1, Hb=2,
                       causal=True, blocks=(16, 32)),
}
P, SEED = 0.1, 4242


def _inputs(cfg, seed=1234, D=32):
    rng = np.random.default_rng(seed)
    x = {"q": rng.normal(size=(cfg["B"], cfg["Hq"], cfg["Sq"], D)),
         "k": rng.normal(size=(cfg["B"], cfg["Hkv"], cfg["Sk"], D)),
         "v": rng.normal(size=(cfg["B"], cfg["Hkv"], cfg["Sk"], D)),
         "bias": rng.normal(size=(cfg["Bb"], cfg["Hb"], cfg["Sq"],
                                  cfg["Sk"]))}
    return {k: v.astype(np.float32) for k, v in x.items()}


def _jax_grads(x, impl, **kw):
    """(loss, (dq, dk, dv, dbias)) of Σ out² through JAX's flash."""
    def f(q, k, v, b):
        with jax_common.force_impl(impl):
            out = jax_flash(q, k, v, bias=b, **kw)
        return jnp.sum(jnp.square(out.astype(jnp.float32)))

    loss, grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2, 3)))(
        *(jnp.asarray(x[n]) for n in ("q", "k", "v", "bias")))
    return float(loss), [np.asarray(g) for g in grads]


def _port_grads(x, bias_dtype=torch.float32, **kw):
    q, k, v = (torch.from_numpy(x[n]).requires_grad_()
               for n in ("q", "k", "v"))
    b = torch.from_numpy(x["bias"]).to(bias_dtype).requires_grad_()
    out = flash_attention(q, k, v, bias=b, **kw)
    loss = (out.float() ** 2).sum()
    loss.backward()
    return loss.item(), [t.grad for t in (q, k, v, b)]


def _assert_grads(got, want):
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(
            g.float().numpy(), w, rtol=1e-4,
            atol=5e-5 if name == "dbias" else 1e-5, err_msg=name)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_loss_and_four_grads_match_jax(layout, impl):
    cfg = LAYOUTS[layout]
    x = _inputs(cfg)
    kw = dict(causal=cfg["causal"])
    jkw = dict(kw)
    if "blocks" in cfg:
        jkw.update(block_q=cfg["blocks"][0], block_k=cfg["blocks"][1])
    wl, wg = _jax_grads(x, impl, **jkw)
    gl, gg = _port_grads(x, **kw)
    np.testing.assert_allclose(gl, wl, rtol=1e-5)
    assert gg[3].shape == x["bias"].shape
    _assert_grads(gg, wg)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_bias_with_segments_matches_jax(impl):
    cfg = dict(B=2, Hq=2, Hkv=2, Sq=48, Sk=48, Bb=1, Hb=2)
    x = _inputs(cfg, seed=7)
    segs = np.repeat(np.arange(3), 16)[None].repeat(2, 0).astype(np.int32)
    segs[1, 40:] = -1  # a padded tail
    wl, wg = _jax_grads(x, impl, segment_ids=jnp.asarray(segs))
    gl, gg = _port_grads(x, segment_ids=torch.from_numpy(segs))
    np.testing.assert_allclose(gl, wl, rtol=1e-5)
    _assert_grads(gg, wg)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("layout", ["gqa-causal", "cross-batchbias"])
def test_bias_with_dropout_matches_jax(layout, impl):
    cfg = LAYOUTS[layout]
    x = _inputs(cfg, seed=11)
    kw = dict(causal=cfg["causal"], dropout_p=P, dropout_seed=SEED)
    wl, wg = _jax_grads(x, impl, **kw)
    gl, gg = _port_grads(x, **kw)
    np.testing.assert_allclose(gl, wl, rtol=1e-5)
    _assert_grads(gg, wg)


def test_dbias_with_dropout_applies_the_forward_mask():
    """dbias from the Function equals autograd through a composite that
    drops the softmax with `_keep`, the forward's mask; the undropped
    composite's dbias differs."""
    cfg = LAYOUTS["gqa-causal"]
    x = _inputs(cfg, seed=12)
    _, gg = _port_grads(x, causal=True, dropout_p=P, dropout_seed=SEED)

    def composite(keep):
        q, k, v = (torch.from_numpy(x[n]) for n in ("q", "k", "v"))
        b = torch.from_numpy(x["bias"]).requires_grad_()
        kk, vv = (t.repeat_interleave(2, dim=1) for t in (k, v))
        s = torch.einsum("bhqd,bhkd->bhqk", q, kk) / 32 ** 0.5 + b
        S = s.shape[-1]
        causal = torch.ones(S, S, dtype=torch.bool).tril()
        probs = torch.softmax(torch.where(causal, s, NEG_INF), dim=-1)
        if keep is not None:
            probs = torch.where(keep, probs * inv_keep(P), 0.0)
        out = torch.einsum("bhqk,bhkd->bhqd", probs, vv)
        (out ** 2).sum().backward()
        return b.grad

    q = torch.from_numpy(x["q"])
    want = composite(_keep(q, cfg["Sk"], 0, 0, P, SEED))
    np.testing.assert_allclose(gg[3].numpy(), want.numpy(), rtol=1e-4,
                               atol=5e-5)
    assert not torch.allclose(composite(None), want, atol=1e-3)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_a_row_of_neg_inf_bias_follows_the_mask(impl):
    """Query row 3's keys all carry NEG_INF: the row is valid by the
    mask, so it takes uniform weights as ``_xla_attention`` gives, and
    a few NEG_INF keys of another row get p = 0."""
    cfg = dict(B=1, Hq=2, Hkv=2, Sq=24, Sk=24, Bb=1, Hb=2)
    x = _inputs(cfg, seed=5)
    x["bias"][:, :, 3, :] = NEG_INF
    x["bias"][:, :, 7, :5] = NEG_INF
    with jax_common.force_impl(impl):
        want = [np.asarray(o) for o in jax.jit(lambda q, k, v, b: jax_flash(
            q, k, v, bias=b, return_lse=True))(
                *(jnp.asarray(x[n]) for n in ("q", "k", "v", "bias")))]
    out, lse = flash_attention(
        *(torch.from_numpy(x[n]) for n in ("q", "k", "v")),
        bias=torch.from_numpy(x["bias"]), return_lse=True)
    np.testing.assert_allclose(out.numpy(), want[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), want[1], rtol=1e-5)
    v_mean = x["v"].mean(axis=2)
    np.testing.assert_allclose(out[0, :, 3].numpy(), v_mean[0], rtol=1e-5,
                               atol=1e-5)


def test_a_bf16_bias_gets_a_bf16_gradient():
    cfg = LAYOUTS["full"]
    x = _inputs(cfg, seed=3)
    _, g32 = _port_grads(x)
    _, g16 = _port_grads(x, bias_dtype=torch.bfloat16)
    assert g16[3].dtype == torch.bfloat16
    # the bf16 bias is the fp32 one rounded; its gradient one rounding
    # of an fp32 dbias on the rounded bias
    np.testing.assert_allclose(g16[3].float().numpy(), g32[3].numpy(),
                               rtol=2e-2, atol=2e-2)


def test_bad_bias_shapes_raise_naming_the_bias():
    q = torch.zeros(2, 2, 48, 16)
    with pytest.raises(ValueError, match="bias"):
        flash_attention(q, q, q, bias=torch.zeros(3, 2, 48, 48))
    with pytest.raises(ValueError, match="bias"):
        flash_attention(q, q, q, bias=torch.zeros(48, 48))
    with pytest.raises(ValueError, match="bias"):
        flash_attention(q, q, q, bias=torch.zeros(1, 1, 48, 47))
    with pytest.raises(ValueError, match="bias"):
        tattn.flash_fwd(q, q, q, None, None, 0.25, False,
                        bias=torch.zeros(1, 4, 48, 48))


def test_a_bias_without_gradient_launches_no_dbias(monkeypatch):
    calls = []
    real = tattn.flash_dbias

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tattn, "flash_dbias", spy)
    x = _inputs(LAYOUTS["full"], seed=9)
    q = torch.from_numpy(x["q"]).requires_grad_()
    k, v = (torch.from_numpy(x[n]) for n in ("k", "v"))
    mask = torch.from_numpy(x["bias"])
    flash_attention(q, k, v, bias=mask).sum().backward()
    assert calls == [] and q.grad is not None
    b = mask.clone().requires_grad_()
    flash_attention(q, k, v, bias=b).sum().backward()
    assert calls == [1] and b.grad.shape == b.shape
