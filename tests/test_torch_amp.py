"""The port's amp training step against the JAX package's, on the CPU.

- `DynamicLossScale.adjust` over a fixed finite/overflow sequence, with
  hysteresis 1 and 2: every state equal to JAX's exactly;
- `fused_adam` over 5 updates in both weight-decay modes: 1e-6
  relative (fp32 pow and division may round differently by an ulp);
- tiny GPT-2 (``use_flash=False``, ``fuse_head=False``) from the same
  params through ``Amp.make_train_step``:
  - O0: the step-0 loss and every grad leaf within 1e-5;
  - O2: a 3-step loss, grad norm and param trajectory within 2e-2
    relative (the params by their global norm; bf16 rounds at other
    places in the two frameworks);
  - O2_fp16: 3 steps with an overflow forced at step 2; skipped_steps,
    loss_scale and grads_finite equal to JAX's, and the step-2 params
    equal the step-1 params bit for bit;
- `interop` carries the whole JAX AmpState over and back unchanged, and
  the port continues JAX's run from its state after a step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex1_tpu.amp import Amp as JaxAmp
from apex1_tpu.core.loss_scale import DynamicLossScale as JaxDLS
from apex1_tpu.core.loss_scale import StaticLossScale as JaxSLS
from apex1_tpu.core.policy import get_policy as jax_get_policy
from apex1_tpu.models.gpt2 import GPT2 as JaxGPT2
from apex1_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from apex1_tpu.models.gpt2 import gpt2_loss_fn as jax_gpt2_loss_fn
from apex1_tpu.optim.clip_grad import clip_grad_norm as jax_clip
from apex1_tpu.optim.fused_adam import fused_adam as jax_fused_adam
from apex1_tpu_torch import (Amp, GPT2Config, fused_adam, get_policy,
                             gpt2_loss_fn, gpt2_params_from_jax)
from apex1_tpu_torch.core.loss_scale import (DynamicLossScale,
                                             StaticLossScale, all_finite,
                                             make_loss_scale, select_tree)
from apex1_tpu_torch.core.pytree import global_norm
from apex1_tpu_torch.interop import (amp_state_from_jax, amp_state_to_numpy,
                                     flax_from_named, named_from_flax)
from apex1_tpu_torch.optim import clip_grad_norm

_LS_FIELDS = ("scale", "growth_count", "overflow_count", "hysteresis_left")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees(got, want, **tol):
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert flat_g.keys() == flat_w.keys()
    for k, w in flat_w.items():
        np.testing.assert_allclose(np.asarray(flat_g[k], np.float32),
                                   np.asarray(w, np.float32), err_msg=str(k),
                                   **tol)


# ---- loss scaling --------------------------------------------------------


SEQ = [True, False, True, True, True, False, False, True, False, False,
       False, True, True, True, True]


@pytest.mark.parametrize("hysteresis", [1, 2])
def test_dynamic_loss_scale_state_machine_matches_jax(hysteresis):
    kw = dict(init_scale=2.0 ** 4, growth_interval=3, min_loss_scale=0.5,
              max_loss_scale=2.0 ** 6, hysteresis=hysteresis)
    jls, tls = JaxDLS(**kw), DynamicLossScale(**kw)
    js, ts = jls.init(), tls.init("cpu")
    for finite in SEQ:
        js = jls.adjust(js, jnp.bool_(finite))
        ts = tls.adjust(ts, torch.tensor(finite))
        for f in _LS_FIELDS:
            got, want = getattr(ts, f), np.asarray(getattr(js, f))
            assert got.shape == () and got.item() == want.item(), f
        assert ts.scale.dtype == torch.float32
        assert ts.growth_count.dtype == torch.int32


def test_static_and_noop_loss_scales_match_jax():
    js, ts = JaxSLS(128.0), StaticLossScale(128.0)
    a, b = js.init(), ts.init("cpu")
    for finite in (True, False, False):
        a = js.adjust(a, jnp.bool_(finite))
        b = ts.adjust(b, torch.tensor(finite))
    assert b.scale.item() == 128.0 and b.overflow_count.item() == 2
    assert int(a.overflow_count) == 2
    noop = make_loss_scale(None)
    st = noop.init("cpu")
    loss = torch.tensor(3.0)
    assert noop.scale(loss, st) is loss and noop.adjust(st, False) is st
    assert isinstance(make_loss_scale("dynamic"), DynamicLossScale)


def test_all_finite_select_tree_and_global_norm():
    a = {"x": torch.ones(3), "y": torch.full((2,), 2.0)}
    b = {"x": torch.zeros(3), "y": torch.zeros(2)}
    assert all_finite(a).item()
    assert not all_finite({**a, "y": torch.tensor([1.0, float("inf")])}
                          ).item()
    kept = select_tree(torch.tensor(False), a, b)
    assert all(torch.equal(kept[k], b[k]) for k in a)
    np.testing.assert_allclose(global_norm(a).item(), np.sqrt(3 + 8),
                               rtol=1e-7)


# ---- fused Adam and clipping ---------------------------------------------


def _tiny_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((4, 6)).astype(np.float32),
            "b": rng.standard_normal((6,)).astype(np.float32)}


@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_fused_adam_matches_jax(adam_w_mode):
    kw = dict(learning_rate=1e-2, weight_decay=0.05, adam_w_mode=adam_w_mode)
    jtx, ttx = jax_fused_adam(**kw), fused_adam(**kw)
    p0 = _tiny_tree(0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    for i in range(5):
        g = _tiny_tree(10 + i)
        ju, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                            jp)
        tu, ts = ttx.update({k: torch.from_numpy(v) for k, v in g.items()},
                            ts, tp)
        jp = {k: jp[k] + ju[k] for k in jp}
        tp = {k: tp[k] + tu[k] for k in tp}
        for k in jp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(ts.exp_avg_sq[k].numpy(),
                                       np.asarray(js.exp_avg_sq[k]),
                                       rtol=1e-6)
    assert ts.step.item() == int(js.step) == 5


def test_clip_grad_norm_matches_jax():
    g = _tiny_tree(3)
    jc, jn = jax_clip({k: jnp.asarray(v) for k, v in g.items()}, 0.5)
    tc, tn = clip_grad_norm({k: torch.from_numpy(v) for k, v in g.items()},
                            0.5)
    np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-6)


# ---- the GPT-2 training step ---------------------------------------------

B, S = 2, 16


@pytest.fixture(scope="module")
def tiny():
    """Tiny GPT-2 (vocab 250 padded to 256, so the loss masks padded
    columns) with the JAX package's params, and a fixed batch."""
    kw = dict(vocab_size=250, use_flash=False)
    jcfg = JaxGPT2Config.tiny(policy=jax_get_policy("O0"), **kw)
    tokens = np.random.default_rng(0).integers(0, 250, (B, S)).astype(
        np.int32)
    jparams = jax.jit(JaxGPT2(jcfg).init)(jax.random.key(0),
                                          jnp.asarray(tokens))["params"]
    return dict(kw=kw, tokens=tokens, jparams=jparams)


def _jax_run(tiny, level, steps, lr=1e-3, overflow_at=None, **amp_kw):
    """``steps`` JAX amp steps; the loss is multiplied by a factor that
    rides in the batch (inf at ``overflow_at``), so one jit serves."""
    cfg = JaxGPT2Config.tiny(policy=jax_get_policy(level), **tiny["kw"])
    base = jax_gpt2_loss_fn(JaxGPT2(cfg), fuse_head=False)
    amp = JaxAmp(jax_fused_adam(lr, weight_decay=0.01), opt_level=level,
                 **amp_kw)
    state = amp.init(tiny["jparams"])
    step = jax.jit(amp.make_train_step(lambda p, t, f: base(p, t) * f))
    out = []
    for i in range(steps):
        factor = jnp.float32(jnp.inf if i == overflow_at else 1.0)
        state, m = step(state, jnp.asarray(tiny["tokens"]), factor)
        out.append((_np_tree(state), _np_tree(m)))
    return out


def _port_model(tiny, level):
    cfg = GPT2Config.tiny(policy=get_policy(level), **tiny["kw"])
    return gpt2_params_from_jax(_np_tree(tiny["jparams"]), cfg, "cpu")


def _port_run(tiny, level, steps, lr=1e-3, overflow_at=None, state=None,
              **amp_kw):
    model = _port_model(tiny, level)
    base = gpt2_loss_fn(model, fuse_head=False)
    amp = Amp(fused_adam(lr, weight_decay=0.01), opt_level=level, **amp_kw)
    if state is None:
        state = amp.init(dict(model.named_parameters()))
    step = amp.make_train_step(lambda p, t, f: base(p, t) * f)
    tokens = torch.from_numpy(tiny["tokens"])
    out = []
    for i in range(steps):
        factor = torch.tensor(float("inf") if i == overflow_at else 1.0)
        state, m = step(state, tokens, factor)
        out.append((state, {k: v.numpy() for k, v in m.items()}))
    return out


def test_o0_loss_and_every_grad_leaf_match_jax(tiny):
    cfg = JaxGPT2Config.tiny(policy=jax_get_policy("O0"), **tiny["kw"])
    jloss, jgrads = jax.jit(jax.value_and_grad(
        jax_gpt2_loss_fn(JaxGPT2(cfg), fuse_head=False)))(
        tiny["jparams"], jnp.asarray(tiny["tokens"]))
    model = _port_model(tiny, "O0")
    params = dict(model.named_parameters())
    loss = gpt2_loss_fn(model, fuse_head=False)(
        params, torch.from_numpy(tiny["tokens"]))
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    _assert_trees(flax_from_named(dict(zip(params, grads))),
                  _np_tree(jgrads), rtol=1e-5, atol=1e-5)


def test_o2_three_step_trajectory_matches_jax(tiny):
    want = _jax_run(tiny, "O2", 3)
    got = _port_run(tiny, "O2", 3)
    for (js, jm), (ts, tm) in zip(want, got):
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=2e-2)
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"],
                                   rtol=2e-2)
        # the distance over all params, relative to their norm: Adam
        # moves an element whose grad is near 0 by about lr with the
        # grad's sign, which bf16 noise can flip, so neither an
        # elementwise rtol nor a zero-initialized leaf's own norm (LN
        # biases) is the measure
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
    assert got[1][1]["skipped_steps"].item() == 1
    assert got[2][1]["loss_scale"].item() == got[0][1]["loss_scale"] / 2
    before, after = got[0][0], got[1][0]
    for k in before.params:
        assert torch.equal(after.params[k], before.params[k]), k
        assert torch.equal(after.opt_state.exp_avg[k],
                           before.opt_state.exp_avg[k]), k
    assert after.opt_state.step.item() == 1 and after.step.item() == 2


def test_max_grad_norm_clips_like_jax(tiny):
    want = _jax_run(tiny, "O0", 2, max_grad_norm=0.1)
    got = _port_run(tiny, "O0", 2, max_grad_norm=0.1)
    for (_, jm), (_, tm) in zip(want, got):
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-5)
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"],
                                   rtol=1e-4)


def test_amp_refuses_what_is_not_ported():
    # every form is ported now, so each is accepted: grad_psum_axes
    # (tests/test_torch_ddp.py holds it against JAX's shard_map steps),
    # num_losses, accum_steps, has_aux and the scale clamps
    # (tests/test_torch_amp_features.py holds them against JAX)
    assert Amp(fused_adam(), grad_psum_axes=("dp",)).grad_psum_axes == \
        ("dp",)
    amp = Amp(fused_adam(), opt_level="O2_fp16", num_losses=2,
              min_loss_scale=1.0, max_loss_scale=2.0 ** 20)
    assert amp.num_losses == 2 and amp.scaler.max_loss_scale == 2.0 ** 20
    state = amp.init({"w": torch.ones(2)})
    assert len(state.loss_scale) == 2
    assert callable(amp.make_train_step(lambda p: p["w"].sum(),
                                        accum_steps=2, loss_id=1,
                                        has_aux=True))


def test_gpt2_refuses_flash_and_fused_head(tiny):
    """``use_flash=True`` runs (the flash slice) and gives the
    materialized path's logits; the fused head (the linear-xent slice,
    the default) runs and gives the materialized head's loss; training
    dropout runs with seeds (tests/test_torch_gpt2_dropout.py holds it
    against JAX) and raises without them."""
    tokens = torch.from_numpy(tiny["tokens"])
    cfg = GPT2Config.tiny(policy=get_policy("O0"), vocab_size=250)
    model = gpt2_params_from_jax(_np_tree(tiny["jparams"]), cfg, "cpu")
    logits = model(tokens)
    assert logits.shape == (B, S, 256) and torch.isfinite(logits).all()
    plain = _port_model(tiny, "O0")(tokens)
    np.testing.assert_allclose(logits.detach().numpy(),
                               plain.detach().numpy(), rtol=1e-5, atol=1e-5)
    params = dict(model.named_parameters())
    fused = gpt2_loss_fn(model)(params, tokens)
    materialized = gpt2_loss_fn(model, fuse_head=False)(params, tokens)
    np.testing.assert_allclose(fused.item(), materialized.item(), rtol=1e-5)
    dcfg = GPT2Config.tiny(policy=get_policy("O0"), vocab_size=250,
                           dropout=0.1)
    dmodel = gpt2_params_from_jax(_np_tree(tiny["jparams"]), dcfg, "cpu")
    with pytest.raises(ValueError, match="dropout_seeds"):
        dmodel(tokens, deterministic=False)
    dparams = dict(dmodel.named_parameters())
    dropped = gpt2_loss_fn(dmodel, fuse_head=False)(dparams, tokens,
                                                    dropout_rng=(0, 1))
    assert torch.isfinite(dropped)
    assert dropped.item() != gpt2_loss_fn(dmodel, fuse_head=False)(
        dparams, tokens).item()


# ---- interop: the whole training state -----------------------------------


def test_amp_state_round_trips_through_the_port(tiny):
    (jstate, _), = _jax_run(tiny, "O2_fp16", 1)
    back = amp_state_to_numpy(amp_state_from_jax(jstate, "cpu"))
    want = {"step": jstate.step, "params": jstate.params,
            "opt_state": {"step": jstate.opt_state.step,
                          "exp_avg": jstate.opt_state.exp_avg,
                          "exp_avg_sq": jstate.opt_state.exp_avg_sq},
            "loss_scale": {f: getattr(jstate.loss_scale, f)
                           for f in _LS_FIELDS}}
    _assert_trees(back, want, rtol=0, atol=0)
    assert set(named_from_flax(jstate.params)) == set(
        dict(_port_model(tiny, "O0").named_parameters()))


def test_port_continues_jax_run_from_its_state(tiny):
    """One step in JAX, then the next step in both: loss and grad norm
    at O0 within 1e-5 of JAX's second step."""
    (s1, _), (_, m2) = _jax_run(tiny, "O0", 2)
    (_, tm), = _port_run(tiny, "O0", 1, state=amp_state_from_jax(s1, "cpu"))
    np.testing.assert_allclose(tm["loss"], m2["loss"], rtol=1e-5)
    np.testing.assert_allclose(tm["grad_norm"], m2["grad_norm"], rtol=1e-5)
    assert tm["skipped_steps"] == m2["skipped_steps"] == 0


@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3", "O1_fp16",
                                   "O2_fp16", "O3_fp16"])
def test_policy_presets_match_jax(level):
    jp, tp = jax_get_policy(level), get_policy(level)
    for f in ("param_dtype", "compute_dtype", "output_dtype"):
        assert str(getattr(tp, f)).split(".")[-1] == \
            jnp.dtype(getattr(jp, f)).name, f
    for f in ("keep_norms_fp32", "fp32_fragile_ops", "loss_scale"):
        assert getattr(tp, f) == getattr(jp, f), f


def test_model_trains_but_serving_records_no_graph(tiny):
    """The params take gradients; the serving decoder's forward runs
    without autograd (the engine steps under inference mode)."""
    from apex1_tpu_torch.models.generate import gpt2_decoder
    cfg = GPT2Config.tiny(policy=get_policy("O0"), vocab_size=250)
    model = gpt2_params_from_jax(_np_tree(tiny["jparams"]), cfg, "cpu")
    assert all(p.requires_grad for p in model.parameters())
    apply_fn, make_cache = gpt2_decoder(model)
    logits, _ = apply_fn(torch.from_numpy(tiny["tokens"][:1, :4]),
                         make_cache(1, 8), 0, chunk_decode=True)
    assert logits.grad_fn is None and not logits.requires_grad
