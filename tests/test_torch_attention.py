"""The port's flash attention against the JAX package's, on the CPU.

The same numpy q, k, v and cotangents (dout and, with ``return_lse``,
dlse) go through ``apex1_tpu.ops.attention.flash_attention`` under
``jax.vjp`` (its XLA composite, and its Pallas kernels in interpret
mode) and through the port's plain path under autograd: out, lse, dq,
dk and dv for causal and non-causal attention, GQA, segment ids as one
array and as a pair (with -1 padding and rows that see no key), q/k
offsets and odd Sq != Sk. Tolerances: f32 1e-5; bf16 and fp16 1e-2
relative to the output's largest magnitude (the Pallas forward rounds
the probabilities to the operand type before P·V, where the plain
forward keeps fp32; the XLA composite rounds nothing, where the plain
backward rounds p and dS before their products as the kernels do).

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
from apex1_tpu_torch.ops import KERNEL_WRAPPERS, force_impl
from apex1_tpu_torch.ops.attention import flash_attention, flash_fwd, fmha

#: name -> (B, Hq, Hkv, Sq, Sk, D, causal, segments, q_off, k_off, lse)
CASES = {
    "causal": (2, 2, 2, 64, 64, 32, True, None, 0, 0, True),
    "noncausal": (2, 2, 2, 48, 48, 32, False, None, 0, 0, False),
    "gqa": (1, 4, 2, 48, 48, 64, True, None, 0, 0, True),
    "segments": (2, 2, 2, 64, 64, 32, True, "array", 0, 0, False),
    "segment_pair": (2, 2, 1, 40, 56, 32, False, "pair", 0, 0, True),
    "offsets": (1, 2, 2, 40, 48, 32, True, None, 3, 11, True),
    "odd": (1, 2, 2, 37, 53, 32, False, None, 0, 0, False),
}
TOLS = {"float32": 1e-5, "bfloat16": 1e-2, "float16": 1e-2}


def _segments(rng, kind, B, Sq, Sk):
    """Sorted document ids with a padded tail: one (B, S) array (tail
    -1), or a pair whose q tail (-1) and a q-only id (7) find no key."""
    def docs(S, pad):
        ids = np.sort(rng.integers(0, 3, (B, S)), axis=1).astype(np.int32)
        ids[:, S - 5:] = pad
        return ids

    if kind == "array":
        return docs(Sq, -1)
    qs, ks = docs(Sq, -1), docs(Sk, -2)
    qs[:, 2] = 7
    return qs, ks


def _inputs(name, seed=0):
    B, Hq, Hkv, Sq, Sk, D, causal, seg, q_off, k_off, lse = CASES[name]
    rng = np.random.default_rng(seed)
    x = {"q": rng.standard_normal((B, Hq, Sq, D)),
         "k": rng.standard_normal((B, Hkv, Sk, D)),
         "v": rng.standard_normal((B, Hkv, Sk, D)),
         "do": rng.standard_normal((B, Hq, Sq, D)),
         "dlse": rng.standard_normal((B, Hq, Sq))}
    x = {k: v.astype(np.float32) for k, v in x.items()}
    segs = None if seg is None else _segments(rng, seg, B, Sq, Sk)
    kw = dict(causal=causal, q_offset=q_off, k_offset=k_off,
              return_lse=lse)
    return x, segs, kw


def _jax_run(x, segs, kw, impl, dtype):
    jdt = getattr(jnp, dtype)

    def f(q, k, v):
        return jax_flash(q, k, v, segment_ids=segs, **kw)

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
    if isinstance(segs, tuple):
        segs = tuple(torch.from_numpy(s) for s in segs)
    elif segs is not None:
        segs = torch.from_numpy(segs)
    y = flash_attention(q, k, v, segment_ids=segs, **kw)
    if kw["return_lse"]:
        out, lse = y
        assert lse.dtype == torch.float32
        loss = (out.float() * torch.from_numpy(x["do"]).to(tdt).float()
                ).sum() + (lse * torch.from_numpy(x["dlse"])).sum()
        outs = [out, lse]
    else:
        out = y
        loss = (out.float() * torch.from_numpy(x["do"]).to(tdt).float()
                ).sum()
        outs = [out]
    assert out.dtype == tdt
    loss.backward()
    for t in (q, k, v):
        assert t.grad.dtype == tdt
    return [t.detach().float().numpy() for t in (*outs, q.grad, k.grad,
                                                  v.grad)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("name", list(CASES))
def test_flash_attention_and_grads_match_jax(name, impl, dtype):
    x, segs, kw = _inputs(name)
    want = _jax_run(x, segs, kw, impl, dtype)
    got = _port_run(x, segs, kw, dtype)
    tol = TOLS[dtype]
    names = (["out", "lse"] if kw["return_lse"] else ["out"]) + [
        "dq", "dk", "dv"]
    for n, g, w in zip(names, got, want):
        if n == "lse":
            # rows that see no key read NEG_INF on both sides
            np.testing.assert_array_equal(g <= -1e29, w <= -1e29)
            g, w = np.where(w <= -1e29, 0, g), np.where(w <= -1e29, 0, w)
        np.testing.assert_allclose(g, w, rtol=tol,
                                   atol=tol * max(1.0, np.abs(w).max()),
                                   err_msg=n)


def test_rows_without_keys_give_zero_out_and_grads():
    """Offsets past the first keys and a q-only segment: out 0, lse
    NEG_INF and dq 0 on those rows, and nothing NaN anywhere."""
    x, segs, kw = _inputs("offsets")
    got = _port_run(x, segs, kw, "float32")
    out, lse, dq = got[0], got[1], got[2]
    empty = lse <= -1e29
    assert empty.any() and not empty.all()
    assert not np.isnan(np.concatenate([g.ravel() for g in got])).any()
    assert (out[empty] == 0).all() and (dq[empty] == 0).all()


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_fmha_packed_qkv_matches_jax(impl):
    rng = np.random.default_rng(3)
    B, S, H, D = 2, 48, 2, 32
    qkv = rng.standard_normal((B, S, 3, H, D)).astype(np.float32)
    segs = np.sort(rng.integers(0, 3, (B, S)), axis=1).astype(np.int32)
    with jax_common.force_impl(impl):
        want = np.asarray(jax.jit(lambda a: jax_fmha(
            a, segment_ids=jnp.asarray(segs)))(jnp.asarray(qkv)))
    got = fmha(torch.from_numpy(qkv), segment_ids=torch.from_numpy(segs))
    assert got.shape == (B, S, H, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_bias_and_dropout_raise_naming_the_bert_slice():
    q = torch.zeros(1, 2, 8, 16)
    # the bias runs since the T5 slice (tests/test_torch_attention_bias.py);
    # a bias of another shape raises as in the reference
    with pytest.raises(ValueError, match="bias"):
        flash_attention(q, q, q, bias=torch.zeros(1, 3, 8, 8))
    # dropout runs (tests/test_torch_attention_dropout.py); a missing
    # seed raises as in the reference
    with pytest.raises(ValueError, match="dropout_seed"):
        flash_attention(q, q, q, dropout_p=0.1)
    with pytest.raises(ValueError, match="Hkv"):
        flash_attention(q, torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8, 16))
    with pytest.raises(ValueError, match="q_seg, k_seg"):
        flash_attention(q, torch.zeros(1, 2, 9, 16), torch.zeros(1, 2, 9, 16),
                        segment_ids=torch.zeros(1, 8, dtype=torch.int32))


def test_block_sizes_are_accepted_and_ignored():
    x, segs, kw = _inputs("causal")
    q, k, v = (torch.from_numpy(x[n]) for n in ("q", "k", "v"))
    a = flash_attention(q, k, v, causal=True)
    b = flash_attention(q, k, v, causal=True, block_q=16, block_k=32)
    assert torch.equal(a, b)


def test_cpu_takes_plain_versions_and_kernel_mode_raises():
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        assert name in KERNEL_WRAPPERS
    before = {n: KERNEL_WRAPPERS[n].launches
              for n in ("flash_fwd", "flash_dq", "flash_dkv")}
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    flash_attention(q, q, q, causal=True).sum().backward()
    assert {n: KERNEL_WRAPPERS[n].launches for n in before} == before
    with force_impl("kernel"), pytest.raises(RuntimeError, match="CUDA"):
        flash_fwd(q, q, q, None, None, 0.25, True)
