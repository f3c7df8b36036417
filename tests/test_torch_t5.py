"""The T5 slice as a whole: the port against the JAX package on the CPU.

- ``relative_position_bucket`` equal to the JAX function exactly, for
  every relative position in [-2048, 2048], at (8 buckets, max distance
  16) and (32, 128), bidirectional and not;
- a tiny T5 (``T5Config.tiny``: vocab 256, 2 + 2 layers, 4 heads of 16,
  d_ff 128, 8 buckets) from the JAX package's params
  (`interop.t5_params_from_jax`), O0 (fp32): the loss and every grad
  leaf of ``t5_loss_fn`` within 1e-5 of JAX's, with the fused and the
  materialized head, ``enc_pad_mask``, ``label_pad_id``, the untied
  head, the gated-GELU FFN and remat (against JAX's model without it),
  JAX through its XLA composites and (the fused head with padding)
  through its Pallas kernels in interpret mode;
- O2 under fused Adam: a 3-step loss, grad norm and param trajectory
  within 2e-2 of JAX's Pallas path (interpret mode). The port's plain
  backward rounds p and dS to bf16 before their products as the
  kernels do, and so do JAX's Pallas kernels; JAX's XLA composite
  differentiates in fp32 and rounds only dq, dk, dv, and its own grad
  norm lies 2.5 % from its Pallas path's at step 2 on this model (no
  1/sqrt(d) scale, so the logits are large). O2_fp16 with an overflow
  forced at step 2 skipped like JAX's;
- the params cross between the packages; `param_specs` gives each
  parameter's tensor-parallel spec; the entry points default to CUDA
  and the CPU runs no kernel, the cached decode included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex1_tpu.amp import Amp as JaxAmp
from apex1_tpu.core.policy import get_policy as jax_get_policy
from apex1_tpu.models.t5 import T5 as JaxT5
from apex1_tpu.models.t5 import T5Config as JaxT5Config
from apex1_tpu.models.t5 import \
    relative_position_bucket as jax_relative_position_bucket
from apex1_tpu.models.t5 import t5_loss_fn as jax_loss_fn
from apex1_tpu.ops import _common as jax_common
from apex1_tpu.optim.fused_adam import fused_adam as jax_fused_adam
from apex1_tpu_torch import (T5, Amp, T5Config, fused_adam, get_policy,
                             t5_loss_fn, t5_params_from_jax)
from apex1_tpu_torch.interop import flax_from_named, t5_params_to_numpy
from apex1_tpu_torch.models.generate import init_cache
from apex1_tpu_torch.models.t5 import (init_weights, param_specs,
                                       relative_position_bucket)
from apex1_tpu_torch.ops import KERNEL_WRAPPERS

B, S_ENC, S_DEC = 2, 12, 9
PAD = 0  # label_pad_id of the padded cases


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


@pytest.mark.parametrize("bidirectional", [True, False], ids=["enc", "dec"])
@pytest.mark.parametrize("buckets,max_dist", [(8, 16), (32, 128)])
def test_buckets_equal_the_reference_exactly(buckets, max_dist,
                                             bidirectional):
    rel = np.arange(-2048, 2049, dtype=np.int32)
    want = np.asarray(jax_relative_position_bucket(
        jnp.asarray(rel), bidirectional=bidirectional, num_buckets=buckets,
        max_distance=max_dist))
    got = relative_position_bucket(torch.from_numpy(rel),
                                   bidirectional=bidirectional,
                                   num_buckets=buckets,
                                   max_distance=max_dist)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


#: name -> (config overrides, fuse_head, padded (enc_pad_mask and
#: label_pad_id), the port's remat, JAX impls)
CASES = {
    "fused_padded": (dict(), True, True, False, ("xla", "pallas")),
    "fused": (dict(), True, False, False, ("xla",)),
    "logits_padded": (dict(), False, True, False, ("xla",)),
    "untied_gated": (dict(tie_word_embeddings=False, gated_act=True), True,
                     True, False, ("xla",)),
    "remat": (dict(gated_act=True), True, True, True, ("xla",)),
}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    enc = rng.integers(1, 256, (B, S_ENC)).astype(np.int32)
    dec = rng.integers(1, 256, (B, S_DEC)).astype(np.int32)
    dec[1, -3:] = PAD  # padded targets
    keep = np.ones((B, S_ENC), bool)
    keep[1, -4:] = False  # padded encoder keys
    return dict(enc=enc, dec=dec, keep=keep)


_PARAMS: dict = {}


def _jparams(overrides: dict):
    """The JAX package's params for a tiny config (made once a config)."""
    key = tuple(sorted(overrides.items()))
    if key not in _PARAMS:
        cfg = JaxT5Config.tiny(policy=jax_get_policy("O0"), **overrides)
        rng = np.random.default_rng(8)
        _PARAMS[key] = _np_tree(jax.jit(JaxT5(cfg).init)(
            jax.random.key(3),
            jnp.asarray(rng.integers(0, 256, (B, S_ENC)), jnp.int32),
            jnp.asarray(rng.integers(0, 256, (B, S_DEC)), jnp.int32))
            ["params"])
    return _PARAMS[key]


def _jax_args(data, padded):
    args = (jnp.asarray(data["enc"]), jnp.asarray(data["dec"]))
    return args + ((jnp.asarray(data["keep"]),) if padded else ())


def _port_args(data, padded):
    args = (torch.from_numpy(data["enc"]), torch.from_numpy(data["dec"]))
    return args + ((torch.from_numpy(data["keep"]),) if padded else ())


@pytest.mark.parametrize("name", list(CASES))
def test_o0_loss_and_every_grad_leaf_match_jax(data, name):
    overrides, fuse, padded, remat, impls = CASES[name]
    pad = PAD if padded else None
    jp = _jparams(overrides)
    jcfg = JaxT5Config.tiny(policy=jax_get_policy("O0"), **overrides)
    model = t5_params_from_jax(
        jp, T5Config.tiny(policy=get_policy("O0"), remat=remat, **overrides),
        "cpu")
    params = dict(model.named_parameters())
    loss = t5_loss_fn(model, fuse_head=fuse, label_pad_id=pad)(
        params, *_port_args(data, padded))
    grads = torch.autograd.grad(loss, list(params.values()))
    got = _leaves(flax_from_named(dict(zip(params, grads))))
    for impl in impls:
        with jax_common.force_impl(impl):
            wl, wg = jax.jit(jax.value_and_grad(jax_loss_fn(
                JaxT5(jcfg), fuse_head=fuse, label_pad_id=pad)))(
                    jp, *_jax_args(data, padded))
        np.testing.assert_allclose(loss.item(), float(wl), rtol=1e-5,
                                   err_msg=impl)
        want = _leaves(_np_tree(wg))
        assert got.keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{impl} {k}")


def test_remat_gives_the_grads_of_the_plain_model(data):
    jp = _jparams(dict())
    out = []
    for remat in (False, True):
        model = t5_params_from_jax(
            jp, T5Config.tiny(policy=get_policy("O0"), remat=remat), "cpu")
        params = dict(model.named_parameters())
        loss = t5_loss_fn(model, label_pad_id=PAD)(params,
                                                   *_port_args(data, True))
        out.append((loss, torch.autograd.grad(loss, list(params.values()))))
    assert out[0][0].item() == out[1][0].item()
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def _jax_run(data, level, steps, overflow_at=None, impl="xla"):
    cfg = JaxT5Config.tiny(policy=jax_get_policy(level))
    base = jax_loss_fn(JaxT5(cfg), label_pad_id=PAD)
    amp = JaxAmp(jax_fused_adam(1e-3, weight_decay=0.01), opt_level=level)
    state = amp.init(_jparams(dict()))
    step = jax.jit(amp.make_train_step(lambda p, f, *b: base(p, *b) * f))
    out = []
    with jax_common.force_impl(impl):
        for i in range(steps):
            f = jnp.float32(jnp.inf if i == overflow_at else 1.0)
            state, m = step(state, f, *_jax_args(data, True))
            out.append((_np_tree(state), _np_tree(m)))
    return out


def _port_run(data, level, steps, overflow_at=None):
    model = t5_params_from_jax(_jparams(dict()),
                               T5Config.tiny(policy=get_policy(level)),
                               "cpu")
    base = t5_loss_fn(model, label_pad_id=PAD)
    amp = Amp(fused_adam(1e-3, weight_decay=0.01), opt_level=level)
    state = amp.init(dict(model.named_parameters()))
    step = amp.make_train_step(lambda p, f, *b: base(p, *b) * f)
    out = []
    for i in range(steps):
        f = torch.tensor(float("inf") if i == overflow_at else 1.0)
        state, m = step(state, f, *_port_args(data, True))
        out.append((state, {k: v.numpy() for k, v in m.items()}))
    return out


def test_o2_three_step_trajectory_matches_jax(data):
    want = _jax_run(data, "O2", 3, impl="pallas")
    got = _port_run(data, "O2", 3)
    for (js, jm), (ts, tm) in zip(want, got):
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=2e-2)
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"],
                                   rtol=2e-2)
        got_l = _leaves(flax_from_named(ts.params))
        want_l = _leaves(js.params)
        dist = np.sqrt(sum(np.sum((got_l[k] - w) ** 2)
                           for k, w in want_l.items()))
        norm = np.sqrt(sum(np.sum(w ** 2) for w in want_l.values()))
        assert dist <= 2e-2 * norm, dist / norm
    assert got[-1][1]["loss"] < got[0][1]["loss"]


def test_o2_fp16_forced_overflow_skips_like_jax(data):
    want = _jax_run(data, "O2_fp16", 3, overflow_at=1)
    got = _port_run(data, "O2_fp16", 3, overflow_at=1)
    for (_, jm), (_, tm) in zip(want, got):
        for k in ("skipped_steps", "loss_scale", "grads_finite"):
            np.testing.assert_array_equal(tm[k], jm[k], err_msg=k)
    p1, p2 = got[0][0].params, got[1][0].params
    assert all(torch.equal(p1[k], p2[k]) for k in p1)


def test_params_round_trip_and_shapes(data):
    jp = _jparams(dict(tie_word_embeddings=False, gated_act=True))
    cfg = T5Config.tiny(policy=get_policy("O0"), tie_word_embeddings=False,
                        gated_act=True)
    model = t5_params_from_jax(jp, cfg, "cpu")
    back = _leaves(t5_params_to_numpy(model))
    want = _leaves(jp)
    assert back.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(back[k], w)
    logits = model(*_port_args(data, True)[:2])
    assert logits.shape == (B, S_DEC, 256) and logits.dtype == torch.float32
    assert model.encoder.rel_pos(S_ENC, S_ENC).shape == (1, 4, S_ENC, S_ENC)


def test_unported_options_raise_and_the_cpu_runs_no_kernel(data):
    before = {n: f.launches for n, f in KERNEL_WRAPPERS.items()}
    cfg = T5Config.tiny(policy=get_policy("O0"))
    model = init_weights(T5(cfg, device="cpu"), 0)
    enc, dec = _port_args(data, False)
    loss = t5_loss_fn(model)(dict(model.named_parameters()), enc, dec)
    loss.backward()
    assert torch.isfinite(loss)
    assert {n: f.launches for n, f in KERNEL_WRAPPERS.items()} == before
    memory = model.encode(enc)
    # the cached decode (ported since the T5 generation slice) runs too
    cache = init_cache(cfg.num_decoder_layers, B, cfg.num_heads, 4,
                       cfg.head_dim, torch.float32, device="cpu")
    with torch.no_grad():
        logits, cache = model.decode(dec[:, :1], memory, cache=cache,
                                     cache_index=0)
    assert logits.shape == (B, 1, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    assert {n: f.launches for n, f in KERNEL_WRAPPERS.items()} == before
    specs = param_specs(dict(model.named_parameters()))
    assert specs["shared_embedding"] == ("tp", None)
    assert specs["encoder.layer0.self_attn.wq"] == (None, "tp")
    assert specs["encoder.layer0.self_attn.wo"] == ("tp", None)
    assert specs["encoder.rel_pos.rel_bias"] == ()
    with pytest.raises(ValueError, match="rel_pos_max_dist"):
        T5Config.tiny(rel_pos_buckets=8, rel_pos_max_dist=4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            T5(cfg)
