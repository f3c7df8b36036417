"""The port's fp16_utils against the JAX package's, on the CPU.

The same flat ``{name: array}`` params (norm and non-norm names: a
BERT-style ``ln1_scale``, a ResNet ``stem_bn.scale``, an
``attn_norm.scale``, a Dense ``qkv.bias``, an int counter) go through
both packages:

- `tofp16`, `network_to_half` (fp16 and bf16, with and without
  ``keep_norms_fp32``), `BN_convert_float`, `prep_param_lists`,
  `master_params_to_model_params`, `model_grads_to_master_grads`: the
  same dtype for every entry, the same values;
- `DynamicLossScaler` over a sequence of overflows and clean steps
  (``scale_window`` 2): the same scales; `scale_loss`, `unscale`,
  `has_overflow`; the static `LossScaler` never moves;
- `FP16_Optimizer` around ``fused_sgd`` with a dynamic loss scale on a
  small MLP, 4 steps, one with the loss multiplied by inf: losses,
  fp16 model params, fp32 masters and scales within 2e-2 (fp16
  compute) of JAX's, and the forced step keeps the masters bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex1_tpu.fp16_utils as jfu
from apex1_tpu.optim import fused_sgd as jax_fused_sgd
import apex1_tpu_torch.fp16_utils as tfu
from apex1_tpu_torch.optim import fused_sgd


def _tree():
    rng = np.random.default_rng(5)
    names = ["h.0.ln1_scale", "h.0.qkv.bias", "h.0.qkv.weight",
             "stem_bn.scale", "stage0_block0.bn1.bias", "attn_norm.scale",
             "lnf_bias", "fc.weight", "layer_norm.weight", "scale"]
    out = {n: rng.standard_normal((3, 2)).astype(np.float32)
           for n in names}
    out["step"] = np.arange(3, dtype=np.int32)
    return out


def _dt(x):
    return str(x.dtype).split(".")[-1]


def _same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert _dt(got[k]) == _dt(want[k]), k
        np.testing.assert_array_equal(
            got[k].float().numpy() if got[k].is_floating_point()
            else got[k].numpy(),
            np.asarray(want[k]).astype(np.float32)
            if jnp.issubdtype(want[k].dtype, jnp.floating)
            else np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("fn,kw", [
    ("tofp16", {}),
    ("network_to_half", {}),
    ("network_to_half", {"keep_norms_fp32": True}),
    ("network_to_half", {"dtype": "bfloat16", "keep_norms_fp32": True}),
    ("BN_convert_float", {}),
    ("master_params_to_model_params", {}),
    ("master_params_to_model_params", {"dtype": "bfloat16"}),
    ("model_grads_to_master_grads", {}),
])
def test_casts_match_jax(fn, kw):
    tree = _tree()
    jkw = {k: (getattr(jnp, v) if k == "dtype" else v)
           for k, v in kw.items()}
    tkw = {k: (getattr(torch, v) if k == "dtype" else v)
           for k, v in kw.items()}
    half = {k: (v.astype(np.float16) if v.dtype == np.float32 else v)
            for k, v in tree.items()} if fn == "model_grads_to_master_grads" \
        else tree
    want = getattr(jfu, fn)({k: jnp.asarray(v) for k, v in half.items()},
                            **jkw)
    got = getattr(tfu, fn)({k: torch.from_numpy(v) for k, v in half.items()},
                           **tkw)
    _same(got, want)


def test_prep_param_lists_matches_jax():
    tree = _tree()
    jm, jmaster = jfu.prep_param_lists({k: jnp.asarray(v)
                                        for k, v in tree.items()})
    tm, tmaster = tfu.prep_param_lists({k: torch.from_numpy(v)
                                        for k, v in tree.items()})
    _same(tm, jm)
    _same(tmaster, jmaster)


def test_dynamic_loss_scaler_matches_jax():
    j = jfu.DynamicLossScaler(init_scale=2.0 ** 10, scale_window=2)
    t = tfu.DynamicLossScaler(init_scale=2.0 ** 10, scale_window=2,
                              device="cpu")
    grads = {"a": np.array([1.0, 2.0], np.float32)}
    bad = {"a": np.array([1.0, np.inf], np.float32)}
    assert t.has_overflow({"a": torch.from_numpy(bad["a"])})
    assert not t.has_overflow({"a": torch.from_numpy(grads["a"])})
    scales = []
    for overflow in (True, False, False, False, True, False, False):
        assert t.loss_scale == j.loss_scale
        np.testing.assert_allclose(
            t.scale_loss(torch.tensor(0.5)).item(),
            float(j.scale_loss(jnp.float32(0.5))))
        np.testing.assert_allclose(
            t.unscale({"a": torch.from_numpy(grads["a"])})["a"].numpy(),
            np.asarray(j.unscale({"a": jnp.asarray(grads["a"])})["a"]))
        j.update_scale(overflow)
        t.update_scale(overflow)
        scales.append(t.loss_scale)
    assert scales == [512.0, 512.0, 1024.0, 1024.0, 512.0, 512.0, 1024.0]
    static = tfu.LossScaler(128.0, device="cpu")
    static.update_scale(True)
    assert static.loss_scale == 128.0 == jfu.LossScaler(128.0).loss_scale


def _mlp():
    rng = np.random.default_rng(9)
    return {"w1": rng.standard_normal((6, 8)).astype(np.float32) * 0.5,
            "ln_scale": 1 + 0.1 * rng.standard_normal(8).astype(np.float32),
            "w2": rng.standard_normal((8, 3)).astype(np.float32) * 0.5}


def test_fp16_optimizer_matches_jax():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4, 6)).astype(np.float32)
    y = rng.standard_normal((4, 3)).astype(np.float32)

    def jloss(p, x, y, f):
        h = jnp.tanh(x.astype(p["w1"].dtype) @ p["w1"]) * p["ln_scale"]
        return jnp.mean(jnp.square(h @ p["w2"] - y.astype(h.dtype))) * f

    def tloss(p, x, y, f):
        h = torch.tanh(x.to(p["w1"].dtype) @ p["w1"]) * p["ln_scale"]
        return ((h @ p["w2"] - y.to(h.dtype)).square().mean()) * f

    jo = jfu.FP16_Optimizer(jax_fused_sgd(0.1, momentum=0.9),
                            dynamic_loss_scale=True)
    to = tfu.FP16_Optimizer(fused_sgd(0.1, momentum=0.9),
                            dynamic_loss_scale=True)
    half = {k: v.astype(np.float16) for k, v in _mlp().items()}
    js = jo.init({k: jnp.asarray(v) for k, v in half.items()})
    ts = to.init({k: torch.from_numpy(v) for k, v in half.items()})
    assert all(v.dtype == torch.float32 for v in ts["master"].values())
    # 1e-3 keeps the loss times 2^16 inside fp16
    for i, f in enumerate((1e-3, 1e-3, np.inf, 1e-3)):
        jl, jmodel, js = jo.step(jloss, js, x, y, np.float32(f))
        prev = ts["master"]
        tl, tmodel, ts = to.step(tloss, ts, torch.from_numpy(x),
                                 torch.from_numpy(y), torch.tensor(f))
        if np.isfinite(f):
            np.testing.assert_allclose(tl.float().item(), float(jl),
                                       rtol=2e-2)
        else:
            for k in prev:
                assert torch.equal(ts["master"][k], prev[k]), k
        assert ts["scale"].scale.item() == float(js["scale"].scale)
        assert ts["scale"].overflow_count.item() == int(
            js["scale"].overflow_count)
        for k in jmodel:
            assert tmodel[k].dtype == torch.float16
            np.testing.assert_allclose(tmodel[k].float().numpy(),
                                       np.asarray(jmodel[k], np.float32),
                                       rtol=2e-2, atol=2e-3, err_msg=k)
            np.testing.assert_allclose(ts["master"][k].numpy(),
                                       np.asarray(js["master"][k]),
                                       rtol=2e-2, atol=2e-3, err_msg=k)
    assert ts["scale"].overflow_count.item() == 1
    static = tfu.FP16_Optimizer(fused_sgd(0.1), static_loss_scale=8.0)
    assert static.init({"w": torch.ones(2, dtype=torch.float16)})[
        "scale"].scale.item() == 8.0
