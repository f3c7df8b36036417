"""The port's flash attention with in-kernel probability dropout against
the JAX package's, on the CPU.

The same numpy q, k, v and cotangents go through
``apex1_tpu.ops.attention.flash_attention(dropout_p=0.1,
dropout_seed=...)`` under ``jax.vjp`` (its XLA composite, and its
Pallas kernels in interpret mode: both draw the counter-hash mask) and
through the port's plain path under autograd: out, lse, dq, dk and dv
for causal and non-causal attention, segment ids, GQA, q/k offsets and
`fmha`. The mask itself is compared bit for bit (`attn_keep_mask`
against the reference's). Tolerances: f32 1e-5; bf16 1e-2 relative to
the output's largest magnitude (the rounding points differ as in
tests/test_torch_attention.py).

The CUDA kernels are held against the same plain versions on the card
(tests/test_torch_kernels_gpu.py and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex1_tpu.ops import _common as jax_common
from apex1_tpu.ops.attention import flash_attention as jax_flash
from apex1_tpu.ops.attention import fmha as jax_fmha
from apex1_tpu.ops.stochastic import attn_keep_mask as jax_keep_mask
from apex1_tpu_torch.ops import KERNEL_WRAPPERS
from apex1_tpu_torch.ops.attention import flash_attention, fmha
from apex1_tpu_torch.ops.stochastic import attn_keep_mask

P = 0.1
SEED = 20240611

#: name -> (B, Hq, Hkv, Sq, Sk, D, causal, segments, q_off, k_off, lse)
CASES = {
    "causal": (2, 2, 2, 64, 64, 32, True, False, 0, 0, True),
    "noncausal_segments": (2, 3, 3, 48, 48, 32, False, True, 0, 0, False),
    "gqa": (1, 4, 2, 48, 48, 64, True, False, 0, 0, True),
    "offsets": (1, 2, 2, 40, 56, 32, True, False, 8, 24, True),
}
TOLS = {"float32": 1e-5, "bfloat16": 1e-2}


def _inputs(name, seed=0):
    B, Hq, Hkv, Sq, Sk, D, causal, seg, q_off, k_off, lse = CASES[name]
    rng = np.random.default_rng(seed)
    x = {"q": rng.standard_normal((B, Hq, Sq, D)),
         "k": rng.standard_normal((B, Hkv, Sk, D)),
         "v": rng.standard_normal((B, Hkv, Sk, D)),
         "do": rng.standard_normal((B, Hq, Sq, D)),
         "dlse": rng.standard_normal((B, Hq, Sq))}
    x = {k: v.astype(np.float32) for k, v in x.items()}
    segs = None
    if seg:
        # BERT's padding: real tokens segment 1, a padded tail segment 0
        segs = np.ones((B, Sq), np.int32)
        segs[0, Sq - 9:] = 0
    kw = dict(causal=causal, q_offset=q_off, k_offset=k_off,
              return_lse=lse, dropout_p=P, dropout_seed=SEED)
    return x, segs, kw


def _jax_run(x, segs, kw, impl, dtype):
    jdt = getattr(jnp, dtype)
    jsegs = None if segs is None else jnp.asarray(segs)

    def f(q, k, v):
        return jax_flash(q, k, v, segment_ids=jsegs, **kw)

    def run(q, k, v):
        y, vjp = jax.vjp(f, q, k, v)
        ct = (jnp.asarray(x["do"], jdt), jnp.asarray(x["dlse"])) \
            if kw["return_lse"] else jnp.asarray(x["do"], jdt)
        return y, vjp(ct)

    with jax_common.force_impl(impl):
        y, grads = jax.jit(run)(*(jnp.asarray(x[n], jdt)
                                  for n in ("q", "k", "v")))
    outs = y if kw["return_lse"] else (y,)
    return [np.asarray(o.astype(jnp.float32)) for o in (*outs, *grads)]


def _port_run(x, segs, kw, dtype):
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x[n]).to(tdt).requires_grad_()
               for n in ("q", "k", "v"))
    y = flash_attention(q, k, v, segment_ids=(None if segs is None else
                                              torch.from_numpy(segs)), **kw)
    do = torch.from_numpy(x["do"]).to(tdt).float()
    if kw["return_lse"]:
        out, lse = y
        loss = (out.float() * do).sum() + (
            lse * torch.from_numpy(x["dlse"])).sum()
        outs = [out, lse]
    else:
        out = y
        loss = (out.float() * do).sum()
        outs = [out]
    loss.backward()
    return [t.detach().float().numpy() for t in (*outs, q.grad, k.grad,
                                                  v.grad)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("name", list(CASES))
def test_flash_dropout_and_grads_match_jax(name, impl, dtype):
    x, segs, kw = _inputs(name)
    want = _jax_run(x, segs, kw, impl, dtype)
    got = _port_run(x, segs, kw, dtype)
    tol = TOLS[dtype]
    names = (["out", "lse"] if kw["return_lse"] else ["out"]) + [
        "dq", "dk", "dv"]
    for n, g, w in zip(names, got, want):
        np.testing.assert_allclose(g, w, rtol=tol,
                                   atol=tol * max(1.0, np.abs(w).max()),
                                   err_msg=n)


@pytest.mark.parametrize("name", list(CASES))
def test_keep_mask_equals_the_reference_bit_for_bit(name):
    B, Hq, _, Sq, Sk, _, _, _, q_off, k_off, _ = CASES[name]
    rows = np.arange(Sq, dtype=np.int32)[:, None] + q_off
    cols = np.arange(Sk, dtype=np.int32)[None, :] + k_off
    rg, cg = np.broadcast_arrays(rows, cols)
    want = np.asarray(jax_keep_mask(jnp.int32(SEED), B, Hq, jnp.asarray(rg),
                                    jnp.asarray(cg), P))
    got = attn_keep_mask(SEED, B, Hq, torch.from_numpy(rows),
                         torch.from_numpy(cols), P).numpy()
    np.testing.assert_array_equal(got, want)
    # per-(batch, head) streams differ and the keep rate is about 1 - p
    assert 0.85 < got.mean() < 0.95
    assert not (got[0, 0] == got[-1, -1]).all()


def test_dropout_changes_the_output_and_a_seed_repeats_it():
    x, segs, kw = _inputs("causal")
    q, k, v = (torch.from_numpy(x[n]) for n in ("q", "k", "v"))
    plain = flash_attention(q, k, v, causal=True)
    a = flash_attention(q, k, v, causal=True, dropout_p=P, dropout_seed=5)
    b = flash_attention(q, k, v, causal=True, dropout_p=P,
                        dropout_seed=torch.tensor(5, dtype=torch.int32))
    c = flash_attention(q, k, v, causal=True, dropout_p=P, dropout_seed=6)
    assert torch.equal(a, b)
    assert not torch.equal(a, plain) and not torch.equal(a, c)
    # lse stays the undropped softmax's
    _, lse0 = flash_attention(q, k, v, causal=True, return_lse=True)
    _, lse1 = flash_attention(q, k, v, causal=True, return_lse=True,
                              dropout_p=P, dropout_seed=5)
    assert torch.equal(lse0, lse1)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_fmha_dropout_matches_jax(impl):
    rng = np.random.default_rng(3)
    B, S, H, D = 2, 48, 2, 32
    qkv = rng.standard_normal((B, S, 3, H, D)).astype(np.float32)
    segs = np.ones((B, S), np.int32)
    segs[1, 40:] = 0
    with jax_common.force_impl(impl):
        want = np.asarray(jax.jit(lambda a: jax_fmha(
            a, segment_ids=jnp.asarray(segs), causal=False, dropout_p=P,
            dropout_seed=11))(jnp.asarray(qkv)))
    got = fmha(torch.from_numpy(qkv), segment_ids=torch.from_numpy(segs),
               causal=False, dropout_p=P, dropout_seed=11)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_dropout_arguments_raise_as_the_reference_and_bias_still_raises():
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        flash_attention(q, q, q, dropout_p=1.0, dropout_seed=1)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        flash_attention(q, q, q, dropout_p=-0.1, dropout_seed=1)
    with pytest.raises(ValueError, match="dropout_seed"):
        flash_attention(q, q, q, dropout_p=0.1)
    # the bias runs with dropout since the T5 slice
    # (tests/test_torch_attention_bias.py); a bias of rank 2 raises as in
    # the reference
    with pytest.raises(ValueError, match="bias"):
        flash_attention(q, q, q, bias=torch.zeros(8, 8), dropout_p=0.1,
                        dropout_seed=1)
    # p == 0 ignores a seed and is the dropout-free result
    assert torch.equal(flash_attention(q + 1, q, q, dropout_seed=3),
                       flash_attention(q + 1, q, q))


def test_cpu_dropout_takes_plain_versions():
    before = {n: KERNEL_WRAPPERS[n].launches
              for n in ("flash_fwd", "flash_dq", "flash_dkv")}
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    flash_attention(q, q, q, causal=True, dropout_p=P,
                    dropout_seed=1).sum().backward()
    assert {n: KERNEL_WRAPPERS[n].launches for n in before} == before
    assert torch.isfinite(q.grad).all()
