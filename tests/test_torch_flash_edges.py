"""The port's plain flash forward, dq and dk/dv against the JAX package's
``flash_attention``, on the CPU, at the shapes where the Hopper kernels'
tiles cut (`csrc/flash_wg.cuh`: 64 query rows a forward block, 64-key
tiles, 64 keys a dk/dv block, 64-row q tiles).

The plain versions are the oracle the card holds the kernels against
(tests/test_torch_kernels_gpu.py's `_EDGES`, chip_smoke.py), so they are
pinned here at those edges: Sq and Sk one below and above multiples of
64 and 128, causal diagonals that cross a tile mid-way (and offsets that
leave rows without keys), GQA 4/1 at head dim 128, a -1 segment tail, a
(B, Hq) bias, dropout with offsets. The same numpy q, k, v and
cotangents (dout, dlse) go through ``jax.vjp`` of the reference (its XLA
composite and its Pallas kernels in interpret mode) and through the
port's `flash_fwd`, `flash_dq` and `flash_dkv` called directly, dk/dv
also with ``out_dtype=torch.float32`` (the ring backward's partials),
which rounded to the operand type equals the default output. Tolerances
as tests/test_torch_attention.py: f32 1e-5, bf16 1e-2, relative to the
output's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex1_tpu.ops import _common as jax_common
from apex1_tpu.ops.attention import flash_attention as jax_flash
from apex1_tpu_torch.ops.attention import flash_dkv, flash_dq, flash_fwd

SEED = 4321

#: name -> (B, Hq, Hkv, Sq, Sk, D, causal, segments, q_off, k_off,
#: bias (Bb, Hb) or None, dropout p)
CASES = {
    "sq63_sk65": (1, 2, 2, 63, 65, 32, False, False, 0, 0, None, 0.0),
    "sq65_sk63_causal": (1, 2, 1, 65, 63, 32, True, False, 0, 0, None, 0.0),
    "sq127_sk129_causal": (1, 2, 2, 127, 129, 32, True, False, 2, 0, None,
                           0.0),
    "sq129_sk127": (1, 2, 2, 129, 127, 32, False, False, 0, 0, None, 0.0),
    "diagonal_mid_tile": (1, 2, 2, 96, 130, 32, True, False, 37, 5, None,
                          0.0),
    "keys_ahead_rows_without_keys": (1, 2, 2, 70, 100, 32, True, False, 0,
                                     40, None, 0.0),
    "gqa41_d128": (1, 4, 1, 65, 65, 128, True, False, 0, 0, None, 0.0),
    "segments_tail": (2, 2, 2, 129, 129, 32, True, True, 0, 0, None, 0.0),
    "bias_b_hq": (2, 2, 1, 65, 63, 32, False, False, 0, 0, ("B", "H"), 0.0),
    "dropout_offsets": (1, 2, 2, 65, 129, 32, True, False, 64, 3, None, 0.1),
}
TOLS = {"float32": 1e-5, "bfloat16": 1e-2}


def _inputs(name):
    (B, Hq, Hkv, Sq, Sk, D, causal, seg, q_off, k_off, bias,
     p) = CASES[name]
    rng = np.random.default_rng(Sq * 1000 + Sk)
    x = {"q": rng.standard_normal((B, Hq, Sq, D)),
         "k": rng.standard_normal((B, Hkv, Sk, D)),
         "v": rng.standard_normal((B, Hkv, Sk, D)),
         "do": rng.standard_normal((B, Hq, Sq, D)),
         "dlse": rng.standard_normal((B, Hq, Sq))}
    if bias is not None:
        x["bias"] = rng.standard_normal(
            (B if bias[0] == "B" else 1, Hq if bias[1] == "H" else 1, Sq,
             Sk))
    x = {k: v.astype(np.float32) for k, v in x.items()}
    segs = None
    if seg:
        # sorted document ids with a padded tail of -1
        segs = np.sort(rng.integers(0, 3, (B, Sq)), axis=1).astype(np.int32)
        segs[:, Sq - 11:] = -1
    kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
    if p:
        kw.update(dropout_p=p, dropout_seed=SEED)
    return x, segs, kw


def _jax_run(x, segs, kw, impl, dtype):
    """out, lse, dq, dk, dv of the reference under jax.vjp."""
    jdt = getattr(jnp, dtype)
    bias = None if "bias" not in x else jnp.asarray(x["bias"])

    def f(q, k, v):
        return jax_flash(q, k, v, segment_ids=segs, bias=bias,
                         return_lse=True, **kw)

    def run(q, k, v):
        y, vjp = jax.vjp(f, q, k, v)
        return y, vjp((jnp.asarray(x["do"], jdt), jnp.asarray(x["dlse"])))

    with jax_common.force_impl(impl):
        (out, lse), grads = jax.jit(run)(*(jnp.asarray(x[n], jdt)
                                           for n in ("q", "k", "v")))
    return [np.asarray(o.astype(jnp.float32)) for o in (out, lse, *grads)]


def _close(name, got, want, tol):
    if name == "lse":
        # rows that see no key read NEG_INF on both sides
        np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
        got = np.where(want <= -1e29, 0, got)
        want = np.where(want <= -1e29, 0, want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_flash_matches_jax_at_tile_edges(name, impl, dtype):
    x, segs, kw = _inputs(name)
    want = _jax_run(x, segs, kw, impl, dtype)
    tdt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(x[n]).to(tdt)
                   for n in ("q", "k", "v", "do"))
    dlse = torch.from_numpy(x["dlse"])
    seg = None if segs is None else torch.from_numpy(segs)
    bias = None if "bias" not in x else torch.from_numpy(x["bias"])
    drop = ((kw["dropout_p"], SEED) if "dropout_p" in kw else ())
    args = (seg, seg, q.shape[-1] ** -0.5, kw["causal"], kw["q_offset"],
            kw["k_offset"], *drop)
    out, lse = flash_fwd(q, k, v, *args, bias=bias)
    assert out.dtype == tdt and lse.dtype == torch.float32
    delta = (do.float() * out.float()).sum(-1)
    bwd = (q, k, v, do, lse, delta, dlse, *args)
    dq = flash_dq(*bwd, bias=bias)
    dk, dv = flash_dkv(*bwd, bias=bias)
    fk, fv = flash_dkv(*bwd, bias=bias, out_dtype=torch.float32)
    assert fk.dtype == fv.dtype == torch.float32
    assert torch.equal(fk.to(tdt), dk) and torch.equal(fv.to(tdt), dv)
    tol = TOLS[dtype]
    got = [t.float().numpy() for t in (out, lse, dq, dk, dv, fk, fv)]
    names = ["out", "lse", "dq", "dk", "dv", "dk fp32", "dv fp32"]
    for n, g, w in zip(names, got, want + want[3:]):
        _close(n, g, w, tol)
