"""`rnn`, `reparameterization` and `contrib.sparsity`: the port against
the JAX package on the CPU.

- `LSTM`, `GRU`, `RNNReLU` and `RNNTanh` (2 layers, with and without
  biases, with a given initial state) from the flax modules' params
  (`interop.module_params_from_jax`): outputs and final states within
  1e-5, and every grad (input and params) within 1e-5 of ``jax.grad``'s;
- `weight_norm` at ``dim`` 0, 1 and None within 1e-6 of JAX's, fp16
  whose naive ||v||² overflows staying finite and equal to JAX's;
  `WeightNormDense` from the flax params, grads included;
  `remove_weight_norm`;
- ASP: `compute_m4n2_mask` equal to JAX's bit for bit, ties included;
  `_swap_gains` within 1e-5; `permutation_search`'s perm, mask and
  efficacy equal to JAX's on JAX's own test cases
  (``tests/test_misc_modules.py``; in the crafted one two swaps' gains
  tie exactly in JAX's sums and lie 2 ulps apart in torch's, which the
  port's tie rule, `sparsity.TIE`, reads as the tie it is);
  `ASP.apply_masks` with its name keys against JAX's keystr keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex1_tpu import reparameterization as jrp
from apex1_tpu import rnn as jrnn
from apex1_tpu.contrib import sparsity as jsp
from apex1_tpu_torch import reparameterization as trp
from apex1_tpu_torch import rnn as trnn
from apex1_tpu_torch.contrib import sparsity as tsp
from apex1_tpu_torch.interop import module_params_from_jax

T, B, I, H = 5, 3, 4, 6


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_() if grad else t


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


RNNS = {"LSTM": (jrnn.LSTM, trnn.LSTM), "GRU": (jrnn.GRU, trnn.GRU),
        "RNNReLU": (jrnn.RNNReLU, trnn.RNNReLU),
        "RNNTanh": (jrnn.RNNTanh, trnn.RNNTanh)}


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("name", list(RNNS))
def test_rnn_outputs_states_and_grads_match_flax(name, bias, with_state):
    jcls, tcls = RNNS[name]
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((T, B, I)).astype(np.float32)
    ct = rng.standard_normal((T, B, H)).astype(np.float32)
    lstm = name == "LSTM"
    state = None
    if with_state:
        s = [rng.standard_normal((2, B, H)).astype(np.float32) * 0.5
             for _ in range(2 if lstm else 1)]
        state = tuple(s) if lstm else s[0]
    jm = jcls(input_size=I, hidden_size=H, num_layers=2, bias=bias)
    jstate = None if state is None else jax.tree_util.tree_map(
        jnp.asarray, state)
    params = jm.init(jax.random.key(1), jnp.asarray(xs), jstate)["params"]

    def jl(p, x):
        outs, fin = jm.apply({"params": p}, x, jstate)
        h_n = fin[0] if lstm else fin
        return jnp.sum(outs * ct) + jnp.sum(h_n)

    jout, jfin = jm.apply({"params": params}, jnp.asarray(xs), jstate)
    jgp, jgx = jax.grad(jl, argnums=(0, 1))(params, jnp.asarray(xs))
    tm = module_params_from_jax(_np_tree(params),
                                tcls(I, H, num_layers=2, bias=bias,
                                     device="cpu"))
    tx = _t(xs, True)
    tstate = None if state is None else (
        tuple(_t(s) for s in state) if lstm else _t(state))
    outs, fin = tm(tx, tstate)
    h_n = fin[0] if lstm else fin
    ((outs * _t(ct)).sum() + h_n.sum()).backward()
    np.testing.assert_allclose(outs.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    for g, w in zip(fin if lstm else (fin,), jfin if lstm else (jfin,)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-5)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgp[n]),
                                   rtol=1e-5, atol=1e-5, err_msg=n)


@pytest.mark.parametrize("dim", [0, 1, None])
def test_weight_norm_matches_jax(dim):
    rng = np.random.default_rng(2)
    v = rng.standard_normal((8, 4)).astype(np.float32)
    g = rng.uniform(1, 2, 4 if dim == 1 else 8).astype(np.float32)
    if dim is None:
        g = np.float32(1.7)
    want = jrp.weight_norm(jnp.asarray(v), jnp.asarray(g), dim=dim)
    got = trp.weight_norm(_t(v), _t(g), dim=dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    if dim == 1:
        np.testing.assert_allclose(got.norm(dim=0).numpy(), g, rtol=1e-5)


def test_weight_norm_fp16_is_safe():
    v = np.full((4096, 2), 8.0, np.float16)
    g = np.ones(2, np.float16)
    got = trp.weight_norm(_t(v), _t(g), dim=1)
    assert got.dtype == torch.float16 and torch.isfinite(got).all()
    want = jrp.weight_norm(jnp.asarray(v), jnp.asarray(g), dim=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("use_bias", [True, False])
def test_weight_norm_dense_and_remove_match_flax(use_bias):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 8)).astype(np.float32)
    ct = rng.standard_normal((3, 4)).astype(np.float32)
    jm = jrp.WeightNormDense(features=4, use_bias=use_bias)
    params = jm.init(jax.random.key(0), jnp.asarray(x))["params"]
    params = dict(params, g=params["g"] * 1.5)

    def jl(p, xx):
        return jnp.sum(jm.apply({"params": p}, xx) * ct)

    jgp, jgx = jax.grad(jl, argnums=(0, 1))(params, jnp.asarray(x))
    tm = module_params_from_jax(_np_tree(params), trp.WeightNormDense(
        8, 4, use_bias=use_bias, device="cpu"))
    tx = _t(x, True)
    y = tm(tx)
    (y * _t(ct)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(jm.apply({"params": params},
                                                   jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-5)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgp[n]),
                                   rtol=1e-5, atol=1e-5, err_msg=n)
    want = jrp.remove_weight_norm(dict(params))
    got = trp.remove_weight_norm(dict(tm.named_parameters()))
    assert set(got) == set(want) and "v" not in got
    np.testing.assert_allclose(got["kernel"].detach().numpy(),
                               np.asarray(want["kernel"]), rtol=1e-6,
                               atol=1e-6)


def test_m4n2_mask_equals_jax_ties_included():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((6, 16)).astype(np.float32)
    w[0, :4] = [1.0, -1.0, 1.0, 0.5]       # a three-way tie in |w|
    w[1, 4:8] = 0.0                        # all four equal
    w[2, 8:12] = [-2.0, 2.0, -0.0, 0.0]    # ties in |w| and a signed zero
    want = np.asarray(jsp.compute_m4n2_mask(jnp.asarray(w)))
    got = tsp.compute_m4n2_mask(_t(w))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.reshape(6, 4, 4).sum(-1) == 2).all()
    np.testing.assert_allclose(tsp.mask_efficacy(_t(w)).item(),
                               float(jsp.mask_efficacy(jnp.asarray(w))),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="multiple of 4"):
        tsp.compute_m4n2_mask(torch.zeros(2, 6))


def test_swap_gains_match_jax():
    rng = np.random.default_rng(5)
    aw = np.abs(rng.standard_normal((16, 12))).astype(np.float32)
    want = np.asarray(jsp._swap_gains(jnp.asarray(aw)))
    got = tsp._swap_gains(_t(aw))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _crafted():
    rng = np.random.default_rng(1234)
    w = np.full((8, 8), 0.01, np.float32)
    w[:, :4] = 10.0 + rng.random((8, 4))
    return w


@pytest.mark.parametrize("case", ["crafted", "random"])
def test_permutation_search_equals_jax(case):
    """JAX's own test cases: the all-large stripe, and a (16, 12) normal
    draw searched for up to 64 swaps."""
    if case == "crafted":
        w, kw = _crafted(), {}
    else:
        w = np.random.default_rng(1234).standard_normal(
            (16, 12)).astype(np.float32)
        kw = dict(max_swaps=64)
    jperm, jmask, jeff = jsp.permutation_search(jnp.asarray(w), **kw)
    perm, mask, eff = tsp.permutation_search(_t(w), **kw)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(eff.item(), float(jeff), rtol=1e-6)
    assert eff.item() >= tsp.mask_efficacy(_t(w)).item() - 1e-6
    if case == "crafted":
        assert eff.item() > tsp.mask_efficacy(_t(w)).item() + 0.2


def test_asp_name_keys_match_jax_keystr_keys():
    rng = np.random.default_rng(6)
    tree = {"dense": {"kernel": rng.standard_normal((8, 8)).astype(
        np.float32), "bias": np.ones(8, np.float32)},
            "out": {"kernel": rng.standard_normal((8, 4)).astype(
                np.float32)}}
    jasp = jsp.ASP()
    jmasks = jasp.compute_sparse_masks(jax.tree_util.tree_map(jnp.asarray,
                                                              tree))
    jsparse = jasp.apply_masks(jax.tree_util.tree_map(jnp.asarray, tree))
    flat = {f"{a}.{b}": _t(v) for a, sub in tree.items()
            for b, v in sub.items()}
    asp = tsp.ASP()
    with pytest.raises(RuntimeError, match="compute_sparse_masks"):
        asp.apply_masks(flat)
    masks = asp.compute_sparse_masks(flat)
    assert sorted(masks) == ["dense.kernel", "out.kernel"]
    assert sorted(jmasks) == ["['dense']['kernel']", "['out']['kernel']"]
    sparse = asp.apply_masks(flat)
    for a, sub in tree.items():
        for b in sub:
            np.testing.assert_array_equal(sparse[f"{a}.{b}"].numpy(),
                                          np.asarray(jsparse[a][b]))
