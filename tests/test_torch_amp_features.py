"""The rest of the port's amp against the JAX package's, on the CPU.

A small MLP (6 -> 8 -> 3, tanh) whose loss is multiplied by a factor
that rides in the batch (inf forces an overflow), through the port's
`Amp` and JAX's on the same numpy params and batches:

- ``has_aux``: the aux (a float mean and an int count) equal JAX's,
  also on a forced-overflow step, which is skipped;
- ``accum_steps`` 2 and 4 at O0 (and 2 at O3, half masters): loss,
  grad norm, params after each step and the aux (float leaves the mean
  over micro-batches, the int the last one's) within 1e-5 (O3 2e-2);
- ``num_losses=2``: a step per ``loss_id``, an overflow on loss 1
  halving only its scale, JAX's tuple of scaler states;
- ``min_loss_scale``/``max_loss_scale`` under repeated forced
  overflows and growth (a scaler with growth every step): the scales
  equal JAX's, the caller's scaler untouched; a static scale refuses
  them;
- `Amp.make_forward` with ``cast_model_outputs``; `Amp.state_dict`
  keys equal JAX's (one loss and two), and a state dict from JAX loads;
- `half_function`, `float_function`, `promote_function` (module and
  bound forms): the dtypes JAX's give, nested inputs;
- `initialize`, `scale_loss`, `PrecisionPolicy.cast_to_output`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex1_tpu.amp as jamp
from apex1_tpu.core.loss_scale import DynamicLossScale as JaxDynamic
from apex1_tpu.core.policy import get_policy as jax_get_policy
from apex1_tpu.optim import fused_adam as jax_fused_adam
import apex1_tpu_torch.amp as tamp
from apex1_tpu_torch.core.loss_scale import DynamicLossScale
from apex1_tpu_torch.core.policy import get_policy
from apex1_tpu_torch.optim import fused_adam

B = 4


def _params():
    rng = np.random.default_rng(3)
    return {"w1": rng.standard_normal((6, 8)).astype(np.float32) * 0.5,
            "b1": rng.standard_normal((8,)).astype(np.float32) * 0.1,
            "w2": rng.standard_normal((8, 3)).astype(np.float32) * 0.5}


def _batch(i, lead=()):
    rng = np.random.default_rng(50 + i)
    return (rng.standard_normal(lead + (B, 6)).astype(np.float32),
            rng.standard_normal(lead + (B, 3)).astype(np.float32))


def _jax_loss(p, x, y, f):
    h = jnp.tanh(x.astype(p["w1"].dtype) @ p["w1"] + p["b1"])
    loss = jnp.mean(jnp.square(h @ p["w2"] - y.astype(h.dtype))) * f
    return loss, {"h_mean": jnp.mean(h.astype(jnp.float32)),
                  "count": jnp.sum((h > 0).astype(jnp.int32))}


def _port_loss(p, x, y, f):
    h = torch.tanh(x.to(p["w1"].dtype) @ p["w1"] + p["b1"])
    loss = ((h @ p["w2"] - y.to(h.dtype)).square().mean()) * f
    return loss, {"h_mean": h.float().mean(),
                  "count": (h > 0).sum().to(torch.int32)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _runs(level, factors, *, lead=(), accum=1, loss_ids=None, amp_kw=None,
          jamp_kw=None):
    """Steps through both packages: per step (JAX metrics, port
    metrics, JAX params, port params)."""
    amp_kw = amp_kw or {}
    ja = jamp.Amp(jax_fused_adam(1e-2), opt_level=level,
                  **(jamp_kw or amp_kw))
    ta = tamp.Amp(fused_adam(1e-2), opt_level=level, **amp_kw)
    js = ja.init({k: jnp.asarray(v) for k, v in _params().items()})
    ts = ta.init({k: torch.from_numpy(v) for k, v in _params().items()})
    ids = loss_ids or [0] * len(factors)
    jsteps = {i: jax.jit(ja.make_train_step(_jax_loss, has_aux=True,
                                            loss_id=i, accum_steps=accum))
              for i in set(ids)}
    tsteps = {i: ta.make_train_step(_port_loss, has_aux=True, loss_id=i,
                                    accum_steps=accum) for i in set(ids)}
    out = []
    for n, (f, i) in enumerate(zip(factors, ids)):
        x, y = _batch(n, lead)
        fa = np.full(lead, f, np.float32)
        js, jm = jsteps[i](js, x, y, fa)
        ts, tm = tsteps[i](ts, torch.from_numpy(x), torch.from_numpy(y),
                           torch.from_numpy(fa))
        out.append((jm, tm, js, ts))
    return out


def _check(out, tol):
    for jm, tm, js, ts in out:
        for k in ("loss", "grad_norm", "loss_scale", "grads_finite",
                  "skipped_steps"):
            np.testing.assert_allclose(_np(tm[k]), _np(jm[k]), rtol=tol,
                                       atol=tol, err_msg=k)
        np.testing.assert_allclose(_np(tm["aux"]["h_mean"]),
                                   _np(jm["aux"]["h_mean"]), rtol=tol,
                                   atol=tol)
        assert int(tm["aux"]["count"]) == int(jm["aux"]["count"])
        assert tm["aux"]["count"].dtype == torch.int32
        for k in js.params:
            np.testing.assert_allclose(_np(ts.params[k]),
                                       _np(js.params[k]), rtol=tol,
                                       atol=tol, err_msg=k)


def test_has_aux_on_clean_and_skipped_steps():
    # 1e-3: the loss small enough that the scale 2^16 does not overflow
    # fp16 by itself
    out = _runs("O2_fp16", [1e-3, 1e-3, np.inf, 1e-3])
    _check(out, 2e-2)
    jm, tm, js, ts = out[2]
    assert not bool(tm["grads_finite"]) and int(tm["skipped_steps"]) == 1
    for k in ts.params:      # the skipped step kept the params
        assert torch.equal(ts.params[k], out[1][3].params[k])


@pytest.mark.parametrize("level,accum,tol", [("O0", 2, 1e-5),
                                             ("O0", 4, 1e-5),
                                             ("O3", 2, 2e-2)])
def test_accum_steps_match_jax(level, accum, tol):
    out = _runs(level, [1.0, 1.0, 1.0], lead=(accum,), accum=accum)
    _check(out, tol)
    for _, tm, _, ts in out:
        assert all(p.dtype == get_policy(level).param_dtype
                   for p in ts.params.values())


def test_accum_steps_one_equals_the_mean_of_its_micro_batches():
    """accum 2 on (x0, x1) is one step on the mean gradient: the same
    update as the JAX package's single step on both halves at once
    (the loss is a mean over equal halves)."""
    amp = tamp.Amp(fused_adam(1e-2), opt_level="O0")
    x, y = _batch(0, (2,))
    f = np.ones((2,), np.float32)
    s0 = amp.init({k: torch.from_numpy(v) for k, v in _params().items()})
    s_acc, m_acc = amp.make_train_step(_port_loss, has_aux=True,
                                       accum_steps=2)(
        s0, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(f))
    s_one, m_one = amp.make_train_step(_port_loss, has_aux=True)(
        s0, torch.from_numpy(x.reshape(2 * B, 6)),
        torch.from_numpy(y.reshape(2 * B, 3)), torch.tensor(1.0))
    np.testing.assert_allclose(m_acc["loss"].item(), m_one["loss"].item(),
                               rtol=1e-6)
    for k in s_acc.params:
        np.testing.assert_allclose(_np(s_acc.params[k]),
                                   _np(s_one.params[k]), rtol=1e-5,
                                   atol=1e-6)


def test_num_losses_two_with_loss_id_matches_jax():
    out = _runs("O2_fp16", [1e-3, np.inf, 1e-3, np.inf],
                loss_ids=[0, 1, 0, 1], amp_kw=dict(num_losses=2))
    _check(out, 2e-2)
    js, ts = out[-1][2], out[-1][3]
    assert isinstance(ts.loss_scale, tuple) and len(ts.loss_scale) == 2
    for j, t in zip(js.loss_scale, ts.loss_scale):
        for f in ("scale", "growth_count", "overflow_count",
                  "hysteresis_left"):
            assert _np(getattr(t, f)) == _np(getattr(j, f)), f
    assert ts.loss_scale[0].scale.item() == 2.0 ** 16
    assert ts.loss_scale[1].scale.item() == 2.0 ** 14
    with pytest.raises(ValueError, match="loss_id"):
        tamp.Amp(fused_adam(), num_losses=2).make_train_step(
            _port_loss, loss_id=2)
    with pytest.raises(ValueError, match="num_losses"):
        tamp.Amp(fused_adam(), num_losses=0)


def test_min_max_loss_scale_clamp_like_jax():
    tsc = DynamicLossScale(growth_interval=1)
    jsc = JaxDynamic(growth_interval=1)
    kw = dict(loss_scale=tsc, min_loss_scale=2.0 ** 14,
              max_loss_scale=2.0 ** 17)
    jkw = dict(loss_scale=jsc, min_loss_scale=2.0 ** 14,
               max_loss_scale=2.0 ** 17)
    factors = [np.inf] * 4 + [1e-3] * 5
    out = _runs("O2_fp16", factors, amp_kw=kw, jamp_kw=jkw)
    _check(out, 2e-2)
    scales = [float(o[3].loss_scale.scale) for o in out]
    assert scales == [float(o[2].loss_scale.scale) for o in out]
    assert min(scales) == 2.0 ** 14 and max(scales) == 2.0 ** 17
    # the caller's scaler is copied, never changed
    assert (tsc.min_loss_scale, tsc.max_loss_scale) == (1.0, 2.0 ** 24)
    with pytest.raises(ValueError, match="dynamic"):
        tamp.Amp(fused_adam(), opt_level="O2", min_loss_scale=1.0)
    with pytest.raises(ValueError, match="dynamic"):
        tamp.Amp(fused_adam(), opt_level="O2_fp16", loss_scale=128.0,
                 max_loss_scale=1.0)


@pytest.mark.parametrize("out_dtype", ["float16", "float32", None])
def test_make_forward_casts_like_jax(out_dtype):
    def jfwd(p, x):
        return {"h": jnp.tanh(x @ p["w1"] + p["b1"]), "n": jnp.int32(3)}

    def tfwd(p, x):
        return {"h": torch.tanh(x @ p["w1"] + p["b1"]),
                "n": torch.tensor(3, dtype=torch.int32)}

    ja = jamp.Amp(jax_fused_adam(), opt_level="O2",
                  cast_model_outputs=None if out_dtype is None
                  else getattr(jnp, out_dtype))
    ta = tamp.Amp(fused_adam(), opt_level="O2",
                  cast_model_outputs=None if out_dtype is None
                  else getattr(torch, out_dtype))
    x = _batch(0)[0]
    p = _params()
    want = ja.make_forward(jfwd)(ja.init({k: jnp.asarray(v)
                                          for k, v in p.items()}), x)
    state = ta.init({k: torch.from_numpy(v) for k, v in p.items()})
    for src in (state, state.params):
        got = ta.make_forward(tfwd)(src, torch.from_numpy(x))
        for k in ("h", "n"):
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
        np.testing.assert_allclose(_np(got["h"]), _np(want["h"]),
                                   rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("num_losses", [1, 2])
def test_state_dict_round_trip_and_keys_match_jax(num_losses):
    ja = jamp.Amp(jax_fused_adam(), opt_level="O2_fp16",
                  num_losses=num_losses)
    ta = tamp.Amp(fused_adam(), opt_level="O2_fp16", num_losses=num_losses)
    p = _params()
    js = ja.init({k: jnp.asarray(v) for k, v in p.items()})
    ts = ta.init({k: torch.from_numpy(v) for k, v in p.items()})
    jsd, tsd = ja.state_dict(js), ta.state_dict(ts)

    def keys(d):
        return {k: keys(v) if isinstance(v, dict) else None
                for k, v in d.items()}

    assert keys(tsd) == keys(jsd)
    # a state dict written by JAX (numbers), with other values, loads
    flat = jax.tree_util.tree_map(lambda a: np.asarray(a) * 2, jsd)
    back = ta.load_state_dict(ts, flat)
    again = ta.state_dict(back)
    for path, v in jax.tree_util.tree_leaves_with_path(flat):
        got = again
        for k in path:
            got = got[k.key]
        assert got.item() == v.item(), path
        assert got.dtype == (torch.float32 if path[-1].key == "loss_scale"
                             else torch.int32)
    if num_losses == 1:
        del flat["hysteresis_left"]
        assert ta.load_state_dict(ts, flat).loss_scale \
            .hysteresis_left.item() == 1


def test_function_wrappers_give_jax_dtypes():
    def probe_j(*a, **kw):
        return jax.tree_util.tree_map(lambda t: str(t.dtype), (a, kw))

    def probe_t(*a, **kw):
        from apex1_tpu_torch.core.policy import map_tensors
        return map_tensors((list(a), kw),
                            lambda t: str(t.dtype).split(".")[-1])

    def j_args():
        return ((jnp.ones(2, jnp.bfloat16), {"b": jnp.ones(2, jnp.float16)},
                 jnp.ones(2, jnp.int32)), {"k": [jnp.ones(2, jnp.float32)]})

    def t_args():
        return ((torch.ones(2, dtype=torch.bfloat16),
                 {"b": torch.ones(2, dtype=torch.float16)},
                 torch.ones(2, dtype=torch.int32)),
                {"k": [torch.ones(2, dtype=torch.float32)]})

    def same(jw, tw):
        ja, jk = j_args()
        ta, tk = t_args()
        want = jw(probe_j)(*ja, **jk)
        got = tw(probe_t)(*ta, **tk)
        assert [got[0], got[1]] == [list(want[0]), want[1]]

    for level in ("O1", "O2_fp16"):
        same(lambda f: jamp.half_function(f, level),
             lambda f: tamp.half_function(f, level))
        amp_j = jamp.Amp(jax_fused_adam(), opt_level=level)
        amp_t = tamp.Amp(fused_adam(), opt_level=level)
        same(amp_j.half_function, amp_t.half_function)
        same(amp_j.float_function, amp_t.float_function)
        same(amp_j.promote_function, amp_t.promote_function)
    same(jamp.float_function, tamp.float_function)
    same(jamp.promote_function, tamp.promote_function)
    # promotion without a half operand keeps fp32; without floats nothing
    assert tamp.promote_function(lambda a, b: (a.dtype, b.dtype))(
        torch.ones(1), torch.ones(1, dtype=torch.bfloat16)) == \
        (torch.float32, torch.float32)
    assert tamp.promote_function(lambda a: a.dtype)(
        torch.ones(1, dtype=torch.int64)) == torch.int64


def test_initialize_scale_loss_and_cast_to_output():
    p = {k: torch.from_numpy(v) for k, v in _params().items()}
    amp, state = tamp.initialize(p, fused_adam(), "O2_fp16",
                                 max_grad_norm=1.0)
    assert isinstance(amp, tamp.Amp) and amp.max_grad_norm == 1.0
    assert amp.policy.name == "O2_fp16"
    assert all(v.dtype == torch.float32 for v in state.params.values())
    loss = torch.tensor(0.5)
    assert tamp.scale_loss(loss, state.loss_scale).item() == \
        float(jamp.scale_loss(jnp.float32(0.5), jax_get_policy("O0") and
                              _jax_ls()))
    for level in ("O2", "O3_fp16"):
        out = get_policy(level).cast_to_output(
            {"a": torch.ones(1), "i": torch.ones(1, dtype=torch.int32)})
        want = jax_get_policy(level).cast_to_output(
            {"a": jnp.ones(1), "i": jnp.ones(1, jnp.int32)})
        assert str(out["a"].dtype).split(".")[-1] == str(want["a"].dtype)
        assert out["i"].dtype == torch.int32


def _jax_ls():
    from apex1_tpu.core.loss_scale import make_loss_scale
    return make_loss_scale("dynamic").init()
