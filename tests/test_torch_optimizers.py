"""The port's optimizers against the JAX package's, on the CPU.

Five steps of each optimizer, every flag, on params of mixed shapes
((7, 5), (5,), (3, 4, 2), (1,)) and per-step gradients drawn from a
seed with numpy: the port's `GradientTransformation` and the JAX
package's optax transform see the same arrays. fp32 params: the
params after every step and the whole optimizer state within 1e-6;
bf16 params (the update cast to bf16, the moments fp32): within
bf16's rounding, 2^-7 relative. Also the reference-signature
constructors through the `Optimizer` facade, `chain` of LARC and
FusedSGD, a learning-rate schedule, and the errors (nesterov without
momentum, an unknown norm_type, LARC's clip without a learning rate,
an update without params).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import apex1_tpu.optim as jopt
import apex1_tpu_torch.optim as topt

SHAPES = {"w": (7, 5), "b": (5,), "c": (3, 4, 2), "s": (1,)}
STEPS = 5

#: (id, JAX transform, port transform) built from one keyword set
CASES = [
    ("adam", "fused_adam", dict(learning_rate=1e-2, weight_decay=0.01)),
    ("adam_l2", "fused_adam", dict(learning_rate=1e-2, weight_decay=0.01,
                                   adam_w_mode=False)),
    ("adam_nobc", "fused_adam", dict(learning_rate=1e-2,
                                     bias_correction=False)),
    ("sgd", "fused_sgd", dict(learning_rate=0.1)),
    ("sgd_momentum", "fused_sgd", dict(learning_rate=0.1, momentum=0.9)),
    ("sgd_dampening", "fused_sgd", dict(learning_rate=0.1, momentum=0.9,
                                        dampening=0.3)),
    ("sgd_nesterov", "fused_sgd", dict(learning_rate=0.1, momentum=0.9,
                                       nesterov=True, weight_decay=1e-2)),
    ("sgd_wd", "fused_sgd", dict(learning_rate=0.1, momentum=0.9,
                                 weight_decay=1e-2)),
    ("sgd_wd_after", "fused_sgd", dict(learning_rate=0.1, momentum=0.9,
                                       weight_decay=1e-2,
                                       wd_after_momentum=True)),
    ("sgd_wd_no_momentum", "fused_sgd", dict(learning_rate=0.1,
                                             weight_decay=1e-2)),
    ("lamb", "fused_lamb", dict(learning_rate=1e-2)),
    ("lamb_no_wd", "fused_lamb", dict(learning_rate=1e-2, weight_decay=0.0)),
    ("lamb_nvlamb", "fused_lamb", dict(learning_rate=1e-2, weight_decay=0.0,
                                       use_nvlamb=True)),
    ("lamb_clip_nobc", "fused_lamb", dict(learning_rate=1e-2,
                                          max_grad_norm=0.05,
                                          bias_correction=False)),
    ("novograd", "fused_novograd", dict(learning_rate=1e-2)),
    ("novograd_init_zero", "fused_novograd", dict(learning_rate=1e-2,
                                                  init_zero=True)),
    ("novograd_sum_wd", "fused_novograd", dict(learning_rate=1e-2,
                                               grad_averaging=False,
                                               weight_decay=0.01)),
    ("novograd_inf_nobc", "fused_novograd", dict(learning_rate=1e-2,
                                                 norm_type=float("inf"),
                                                 bias_correction=False)),
    ("adagrad", "fused_adagrad", dict(learning_rate=1e-1)),
    ("adagrad_l2", "fused_adagrad", dict(learning_rate=1e-1,
                                         weight_decay=0.01)),
    ("adagrad_w", "fused_adagrad", dict(learning_rate=1e-1,
                                        weight_decay=0.01,
                                        adagrad_w_mode=True)),
]


def _params(dtype):
    rng = np.random.default_rng(7)
    out = {k: rng.standard_normal(s).astype(np.float32)
           for k, s in SHAPES.items()}
    out["s"] = np.zeros((1,), np.float32)   # a zero param (trust-ratio
    return out                              # and LARC guards)


def _grads(step):
    rng = np.random.default_rng(100 + step)
    g = {k: (rng.standard_normal(s) * 0.5).astype(np.float32)
         for k, s in SHAPES.items()}
    if step == 1:
        g["b"] = np.zeros_like(g["b"])      # a zero gradient
    return g


def _np(x):
    """A state (the port's dataclasses or JAX's NamedTuples, tuples,
    dicts, tensors, arrays) as nested lists and dicts of float64."""
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if hasattr(x, "_fields"):
        return {f: _np(getattr(x, f)) for f in x._fields}
    if hasattr(x, "__dataclass_fields__"):
        return {f: _np(getattr(x, f)) for f in x.__dataclass_fields__}
    if isinstance(x, (tuple, list)):
        return [_np(v) for v in x]
    return np.asarray(x, np.float64)


def _close(got, want, rtol, atol, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], rtol, atol, f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, rtol, atol, f"{path}[{i}]")
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=path)


def _run(jtx, ttx, dtype):
    """(JAX's, the port's) params and optimizer state after every step."""
    p0 = _params(dtype)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    jp = {k: jnp.asarray(v, jdt) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(tdt) for k, v in p0.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    jupd = jax.jit(jtx.update)
    out = []
    for i in range(STEPS):
        g = _grads(i)
        jg = {k: jnp.asarray(v, jdt) for k, v in g.items()}
        tg = {k: torch.from_numpy(v).to(tdt) for k, v in g.items()}
        u, js = jupd(jg, js, jp)
        jp = optax.apply_updates(jp, u)
        tu, ts = ttx.update(tg, ts, tp)
        tp = topt.apply_updates(tp, tu)
        assert all(tp[k].dtype == tdt for k in tp)
        out.append(((_np(jp), _np(js)), (_np(tp), _np(ts))))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,fn,kw", CASES, ids=[c[0] for c in CASES])
def test_optimizer_matches_jax(name, fn, kw, dtype):
    rtol, atol = (1e-6, 1e-6) if dtype == "float32" else (2.0 ** -7, 1e-6)
    for (jp, js), (tp, ts) in _run(getattr(jopt, fn)(**kw),
                                   getattr(topt, fn)(**kw), dtype):
        _close(tp, jp, rtol, atol, "params")
        if dtype == "float32":
            _close(ts, js, rtol, atol, "state")


@pytest.mark.parametrize("clip", [True, False], ids=["larc", "lars"])
def test_larc_chained_before_sgd_matches_jax(clip):
    kw = dict(trust_coefficient=0.02, clip=clip, learning_rate=0.1,
              weight_decay=1e-3)
    jtx = optax.chain(jopt.larc(**kw),
                      jopt.fused_sgd(0.1, momentum=0.9, weight_decay=1e-3))
    ttx = topt.chain(topt.LARC(**kw),
                     topt.fused_sgd(0.1, momentum=0.9, weight_decay=1e-3))
    for (jp, js), (tp, ts) in _run(jtx, ttx, "float32"):
        _close(tp, jp, 1e-6, 1e-6, "params")
        _close(ts, js, 1e-6, 1e-6, "state")


def test_schedule_learning_rate_matches_jax():
    def sched(step):
        return 0.1 / step

    for (jp, _), (tp, _) in _run(jopt.fused_sgd(sched, momentum=0.9),
                                 topt.fused_sgd(sched, momentum=0.9),
                                 "float32"):
        _close(tp, jp, 1e-6, 1e-6, "params")


@pytest.mark.parametrize("ctor,kw", [
    ("FusedAdam", dict(lr=1e-2, betas=(0.8, 0.99), weight_decay=0.01)),
    ("FusedSGD", dict(lr=0.1, momentum=0.9, nesterov=True)),
    ("FusedLAMB", dict(lr=1e-2, betas=(0.8, 0.99), max_grad_norm=0.5)),
    ("FusedNovoGrad", dict(lr=1e-2, betas=(0.9, 0.95), init_zero=True)),
    ("FusedAdagrad", dict(lr=1e-1, adagrad_w_mode=True, weight_decay=0.1)),
])
def test_reference_constructors_step_like_jax(ctor, kw):
    jo, to = getattr(jopt, ctor)(**kw), getattr(topt, ctor)(**kw)
    p0 = _params("float32")
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v) for k, v in p0.items()}
    js, ts = jo.init(jp), to.init(tp)
    for i in range(STEPS):
        g = _grads(i)
        jp, js = jo.step({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp, ts = to.step({k: torch.from_numpy(v) for k, v in g.items()},
                         ts, tp)
        _close(_np(tp), _np(jp), 1e-6, 1e-6, f"{ctor} step {i}")
    u, _ = to.update({k: torch.zeros_like(v) for k, v in tp.items()}, ts,
                     tp)
    assert set(u) == set(tp)


def test_errors_match_jax():
    with pytest.raises(ValueError, match="nesterov"):
        topt.fused_sgd(0.1, nesterov=True)
    with pytest.raises(ValueError, match="nesterov"):
        topt.FusedSGD(0.1, momentum=0.9, dampening=0.1, nesterov=True)
    with pytest.raises(ValueError, match="norm_type"):
        topt.fused_novograd(norm_type=1)
    p = {"w": torch.ones(3)}
    larc = topt.larc(clip=True)
    with pytest.raises(ValueError, match="learning_rate"):
        larc.update(p, larc.init(p), p)
    for tx in (topt.fused_sgd(), topt.fused_lamb(), topt.fused_novograd(),
               topt.fused_adagrad(), topt.larc(learning_rate=0.1),
               topt.fused_adam()):
        with pytest.raises(ValueError, match="requires params"):
            tx.update(p, tx.init(p))
