"""The contrib modules: the port against the JAX package on the CPU.

- `focal_loss` with int, negative (background-only) and one-hot
  targets, label smoothing and the three reductions: value and logits'
  grad within 1e-5 of JAX's;
- `index_mul_2d` and its grads (a scatter-add over repeated indices);
- `group_norm` (function, bf16, SiLU) and `GroupNorm` from the flax
  params, grads included;
- the transducer: the joint (ReLU) equal to JAX's; the loss at "none",
  "sum" and "mean" within 1e-5 relative, with grads and variable
  lengths; the joint's dropout by its keep rate and 1 / (1 - p) scale
  (the port draws its mask from a torch.Generator, not JAX's);
- `SoftmaxCrossEntropyLoss` called and through ``apply`` with
  smoothing, ``padding_idx`` and ``half_to_float``, grads included;
- `openfold`: ``attention_core`` with each of bias1, bias2, the mask and
  the gate against JAX's XLA composite and its Pallas softmax
  (interpret mode), grads of q, k, v and the gate (the biases take none
  through the fused softmax, as on JAX's kernel path); fully masked
  rows; 5-D inputs with a (B, 1, H, S, S) bias raising the ValueError
  of JAX's kernel path (its XLA composite broadcasts instead);
  ``layer_norm``; ``swish`` and ``swiglu``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex1_tpu.contrib import GroupNorm as JaxGroupNorm
from apex1_tpu.contrib import SoftmaxCrossEntropyLoss as JaxXent
from apex1_tpu.contrib import focal_loss as jax_focal_loss
from apex1_tpu.contrib import group_norm as jax_group_norm
from apex1_tpu.contrib import index_mul_2d as jax_index_mul_2d
from apex1_tpu.contrib import openfold as jof
from apex1_tpu.contrib import transducer as jtr
from apex1_tpu.ops import _common as jax_common
from apex1_tpu_torch.contrib import (GroupNorm, SoftmaxCrossEntropyLoss,
                                     TransducerJoint, TransducerLoss,
                                     focal_loss, group_norm, index_mul_2d)
from apex1_tpu_torch.contrib import openfold as tof
from apex1_tpu_torch.contrib import transducer as ttr
from apex1_tpu_torch.interop import module_params_from_jax


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_() if grad else t


def _close(got, want, tol=1e-5):
    g = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(g, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ---- focal loss -----------------------------------------------------------

@pytest.mark.parametrize("reduction", ["sum", "mean", "none"])
@pytest.mark.parametrize("kind", ["int", "negative", "one_hot"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_focal_loss_matches_jax(kind, reduction, smoothing):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 16, 5)).astype(np.float32) * 2
    if kind == "one_hot":
        tg = (rng.random((3, 16, 5)) < 0.3).astype(np.float32)
    else:
        tg = rng.integers(0 if kind == "int" else -1, 5,
                          (3, 16)).astype(np.int32)
        if kind == "negative":
            tg[0, :4] = -1
    kw = dict(alpha=0.25, gamma=2.0, label_smoothing=smoothing,
              reduction=reduction)
    want, jg = jax.value_and_grad(
        lambda l: jnp.sum(jax_focal_loss(l, jnp.asarray(tg), **kw)))(
            jnp.asarray(x))
    tx = _t(x, grad=True)
    got = focal_loss(tx, _t(tg), **kw)
    got.sum().backward()
    _close(got.sum(), want)
    _close(tx.grad, jg)
    if reduction == "none":
        assert got.shape == x.shape
    with pytest.raises(ValueError):
        focal_loss(tx, _t(tg), num_classes=4)


# ---- index_mul_2d ---------------------------------------------------------

def test_index_mul_2d_and_grads_match_jax():
    rng = np.random.default_rng(1)
    in1 = rng.standard_normal((10, 8)).astype(np.float32)
    in2 = rng.standard_normal((6, 8)).astype(np.float32)
    idx = np.array([3, 1, 3, 9, 0, 3], np.int32)
    ct = rng.standard_normal((6, 8)).astype(np.float32)

    def jl(a, b):
        return jnp.sum(jax_index_mul_2d(a, b, jnp.asarray(idx)) * ct)

    (g1, g2) = jax.grad(jl, argnums=(0, 1))(jnp.asarray(in1),
                                            jnp.asarray(in2))
    a, b = _t(in1, True), _t(in2, True)
    out = index_mul_2d(a, b, _t(idx))
    (out * _t(ct)).sum().backward()
    _close(out, jax_index_mul_2d(jnp.asarray(in1), jnp.asarray(in2),
                                 jnp.asarray(idx)), 1e-6)
    _close(a.grad, g1, 1e-6)
    _close(b.grad, g2, 1e-6)
    with pytest.raises(ValueError, match="idx"):
        index_mul_2d(a, b[:5], _t(idx))


# ---- group norm -----------------------------------------------------------

@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_function_matches_jax(act):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 4, 4, 8)) * 3 + 1).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(8)).astype(np.float32)
    b = (0.1 * rng.standard_normal(8)).astype(np.float32)
    want = jax_group_norm(jnp.asarray(x), 2, jnp.asarray(g),
                          jnp.asarray(b), act=act)
    _close(group_norm(_t(x), 2, _t(g), _t(b), act=act), want)
    wb = jax_group_norm(jnp.asarray(x, jnp.bfloat16), 4, act=act)
    gb = group_norm(_t(x).bfloat16(), 4, act=act)
    assert gb.dtype == torch.bfloat16
    _close(gb, wb.astype(jnp.float32), 2 ** -7)
    with pytest.raises(ValueError, match="divisible"):
        group_norm(_t(x), 3)
    with pytest.raises(ValueError, match="act"):
        group_norm(_t(x), 2, act="gelu")


def test_group_norm_module_and_grads_match_flax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    ct = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    jm = JaxGroupNorm(num_groups=4, num_channels=8, act="silu")
    p = jm.init(jax.random.key(0), jnp.asarray(x))["params"]
    p = {"weight": p["weight"] + 0.3, "bias": p["bias"] - 0.2}

    def jl(p, xx):
        return jnp.sum(jm.apply({"params": p}, xx) * ct)

    jgp, jgx = jax.grad(jl, argnums=(0, 1))(p, jnp.asarray(x))
    tm = module_params_from_jax(jax.tree_util.tree_map(np.asarray, p),
                                GroupNorm(4, 8, act="silu", device="cpu"))
    tx = _t(x, True)
    y = tm(tx)
    (y * _t(ct)).sum().backward()
    _close(y, jm.apply({"params": p}, jnp.asarray(x)))
    _close(tx.grad, jgx)
    _close(tm.weight.grad, jgp["weight"])
    _close(tm.bias.grad, jgp["bias"])


# ---- transducer -----------------------------------------------------------

def test_transducer_joint_matches_jax():
    rng = np.random.default_rng(4)
    f = rng.standard_normal((2, 5, 8)).astype(np.float32)
    g = rng.standard_normal((2, 3, 8)).astype(np.float32)
    for relu in (False, True):
        want = jtr.transducer_joint(jnp.asarray(f), jnp.asarray(g),
                                    relu=relu)
        got = ttr.transducer_joint(_t(f), _t(g), relu=relu)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            TransducerJoint(relu=relu)(_t(f), _t(g)).numpy(), got.numpy())
    with pytest.raises(NotImplementedError, match="packed"):
        TransducerJoint(pack_output=True)


def test_transducer_joint_dropout_keep_rate_and_scale():
    p = 0.25
    f = torch.ones(4, 64, 16)
    g = torch.ones(4, 32, 16)
    h = ttr.transducer_joint(f, g, dropout=p, dropout_rng=7,
                             deterministic=False)
    keep = h != 0
    n = keep.numel()
    rate = keep.float().mean().item()
    assert abs(rate - (1 - p)) < 3 * (p * (1 - p) / n) ** 0.5
    assert torch.all(h[keep] == 2.0 / (1 - p))
    again = ttr.transducer_joint(f, g, dropout=p, dropout_rng=7,
                                 deterministic=False)
    assert torch.equal(again, h)
    gen = torch.Generator().manual_seed(7)
    assert torch.equal(TransducerJoint(dropout=p)(
        f, g, dropout_rng=gen, deterministic=False), h)
    assert torch.equal(ttr.transducer_joint(f, g, dropout=p), f[:, :, None]
                       + g[:, None])
    with pytest.raises(ValueError, match="dropout_rng"):
        ttr.transducer_joint(f, g, dropout=p, deterministic=False)


@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
def test_transducer_loss_and_grads_match_jax(reduction):
    rng = np.random.default_rng(5)
    B, T, U, V = 3, 7, 5, 6
    logits = rng.standard_normal((B, T, U, V)).astype(np.float32)
    targets = rng.integers(1, V, (B, U - 1)).astype(np.int32)
    f_len = np.array([T, 5, 3], np.int32)
    y_len = np.array([U - 1, 2, 4], np.int32)
    jargs = (jnp.asarray(targets), jnp.asarray(f_len), jnp.asarray(y_len))

    def jl(lg):
        out = jtr.transducer_loss(lg, *jargs, blank_idx=0,
                                  reduction=reduction)
        return jnp.sum(out * (1.0 + jnp.arange(out.size).reshape(
            out.shape)))

    want = jax.jit(lambda lg: jtr.transducer_loss(
        lg, *jargs, reduction=reduction))(jnp.asarray(logits))
    jg = jax.jit(jax.grad(jl))(jnp.asarray(logits))
    tl = _t(logits, True)
    got = TransducerLoss(blank_idx=0, reduction=reduction)(
        tl, _t(targets), _t(f_len), _t(y_len))
    w = 1.0 + torch.arange(got.numel()).reshape(got.shape)
    (got * w).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)
    assert torch.isfinite(tl.grad).all()


def test_transducer_loss_long_rows_stay_finite():
    """A row of 33 u positions: the scan's doubling steps add several
    -1e30 sentinels; the loss and its grads stay finite and equal to
    JAX's."""
    rng = np.random.default_rng(6)
    B, T, U, V = 2, 4, 33, 5
    logits = rng.standard_normal((B, T, U, V)).astype(np.float32)
    targets = rng.integers(1, V, (B, U - 1)).astype(np.int32)
    f_len, y_len = np.array([T, 3], np.int32), np.array([U - 1, 10],
                                                       np.int32)
    want = jax.jit(lambda *a: jtr.transducer_loss(*a, reduction="none"))(
        jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(f_len),
        jnp.asarray(y_len))
    tl = _t(logits, True)
    got = ttr.transducer_loss(tl, _t(targets), _t(f_len), _t(y_len),
                              reduction="none")
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5)
    assert torch.isfinite(tl.grad).all()
    with pytest.raises(ValueError, match="reduction"):
        ttr.transducer_loss(tl, _t(targets), _t(f_len), _t(y_len),
                            reduction="max")


# ---- xentropy -------------------------------------------------------------

@pytest.mark.parametrize("half_to_float", [False, True])
def test_softmax_cross_entropy_loss_matches_jax(half_to_float):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 6, 40)) * 3).astype(np.float32)
    lab = rng.integers(0, 40, (2, 6)).astype(np.int32)
    lab[0, :2] = 0
    dt = jnp.bfloat16 if half_to_float else jnp.float32

    def jl(lg):
        return jnp.sum(JaxXent.apply(lg, jnp.asarray(lab), 0.1, 0,
                                     half_to_float) * jnp.arange(12.0)
                       .reshape(2, 6))

    want = JaxXent.apply(jnp.asarray(x, dt), jnp.asarray(lab), 0.1, 0,
                         half_to_float)
    jg = jax.grad(jl)(jnp.asarray(x, dt))
    tx = _t(x).to(torch.bfloat16 if half_to_float else torch.float32)
    tx.requires_grad_()
    got = SoftmaxCrossEntropyLoss.apply(tx, _t(lab), 0.1, 0, half_to_float)
    assert got.dtype == torch.float32
    (got * torch.arange(12.0).reshape(2, 6)).sum().backward()
    _close(got, want)
    _close(tx.grad, jnp.asarray(jg, jnp.float32),
           2 ** -7 if half_to_float else 1e-5)
    crit = SoftmaxCrossEntropyLoss(smoothing=0.1, padding_idx=0)
    _close(crit(_t(x), _t(lab)), JaxXent(smoothing=0.1, padding_idx=0)(
        jnp.asarray(x), jnp.asarray(lab)))


# ---- openfold -------------------------------------------------------------

def _of_inputs(seed, B=2, H=3, S=16, D=8):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(q=r(B, H, S, D), k=r(B, H, S, D), v=r(B, H, S, D),
                bias1=r(B, 1, 1, S), bias2=r(B, 1, S, S),
                mask=rng.random((B, 1, 1, S)) > 0.2, gate=r(B, H, S, D),
                ct=r(B, H, S, D))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("opts", ["bias1", "bias2", "mask", "gate", "all"])
def test_attention_core_and_grads_match_jax(opts, impl):
    d = _of_inputs(8)
    names = ("bias1", "bias2", "mask", "gate") if opts == "all" else (opts,)
    kw_np = {n: d[n] for n in names}

    def jl(q, k, v, gate):
        kw = {n: jnp.asarray(a) for n, a in kw_np.items()}
        if "gate" in kw:
            kw["gate"] = gate
        return jnp.sum(jof.attention_core(q, k, v, **kw) * d["ct"])

    jargs = [jnp.asarray(d[n]) for n in ("q", "k", "v", "gate")]
    with jax_common.force_impl(impl):
        jkw = {n: jnp.asarray(a) for n, a in kw_np.items()}
        want = jof.attention_core(*jargs[:3], **jkw)
        jg = jax.grad(jl, argnums=(0, 1, 2, 3))(*jargs)
    targs = [_t(d[n], True) for n in ("q", "k", "v", "gate")]
    tkw = {n: _t(a) for n, a in kw_np.items()}
    if "gate" in tkw:
        tkw["gate"] = targs[3]
    got = tof.attention_core(*targs[:3], **tkw)
    (got * _t(d["ct"])).sum().backward()
    _close(got, want, 2e-5)
    for t, g, n in zip(targs, jg, ("q", "k", "v", "gate")):
        if n == "gate" and "gate" not in names:
            assert t.grad is None
            continue
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=2e-5, atol=2e-5, err_msg=n)


def test_attention_core_fully_masked_rows_and_5d():
    d = _of_inputs(9, B=1, H=2, S=8, D=4)
    mask = np.ones((1, 2, 8, 8), bool)
    mask[0, 0, 3] = False          # a query row with every key masked
    mask[..., 6:] = False
    want = jof.attention_core(jnp.asarray(d["q"]), jnp.asarray(d["k"]),
                              jnp.asarray(d["v"]), mask=jnp.asarray(mask))
    got = tof.attention_core(_t(d["q"]), _t(d["k"]), _t(d["v"]),
                             mask=_t(mask))
    _close(got, want, 2e-5)
    assert torch.isfinite(got).all()
    # 5-D (B, N, H, S, D) with B, N > 1 and a (B, 1, H, S, S) bias: the
    # folded mask cannot broadcast to the (B·N, H, S, S) scores
    rng = np.random.default_rng(10)
    q5 = rng.standard_normal((2, 3, 2, 8, 4)).astype(np.float32)
    b5 = rng.standard_normal((2, 1, 2, 8, 8)).astype(np.float32)
    with jax_common.force_impl("pallas"), pytest.raises(
            ValueError, match="broadcastable"):
        jof.attention_core(jnp.asarray(q5), jnp.asarray(q5),
                           jnp.asarray(q5), bias2=jnp.asarray(b5))
    with pytest.raises(ValueError, match="broadcastable"):
        tof.attention_core(_t(q5), _t(q5), _t(q5), bias2=_t(b5))
    # the MSA layout: (1, N, H, S, D) with bias1 (1, N, 1, 1, S) and the
    # pair bias (1, 1, H, S, S) broadcasts
    q1 = q5[:1]
    b1 = rng.standard_normal((1, 3, 1, 1, 8)).astype(np.float32)
    b2 = rng.standard_normal((1, 1, 2, 8, 8)).astype(np.float32)
    want = jof.attention_core(*(jnp.asarray(q1),) * 3,
                              bias1=jnp.asarray(b1), bias2=jnp.asarray(b2))
    got = tof.attention_core(*(_t(q1),) * 3, bias1=_t(b1), bias2=_t(b2))
    _close(got, want, 2e-5)


def test_openfold_layer_norm_swish_swiglu_match_jax():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((6, 32)).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    b = (0.1 * rng.standard_normal(32)).astype(np.float32)
    _close(tof.layer_norm(_t(x), _t(g), _t(b)),
           jof.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)))
    _close(tof.swish(_t(x)), jof.swish(jnp.asarray(x)), 1e-6)
    wg, wu = (rng.standard_normal((32, 16)).astype(np.float32)
              for _ in range(2))
    wd = rng.standard_normal((16, 8)).astype(np.float32)
    _close(tof.swiglu(_t(x), _t(wg), _t(wu), _t(wd)),
           jof.swiglu(*(jnp.asarray(a) for a in (x, wg, wu, wd))))
