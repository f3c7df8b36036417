"""Llama's context-parallel attention (``seq_shard_axis``, ring and
Ulysses) and `parallel.ulysses_attention` against the JAX package, on
the CPU.

The port's ranks run under gloo on a cp = n mesh (one launch per world
size, bodies in tests/torch_dist_ranks.py), rank r holding the r-th
sequence shard; JAX runs its flat Llama, and ``ulysses_attention``
under ``shard_map`` (device r = rank r). At cp 2 and 4, fp32:

- a tiny Llama (GQA 4/2, S 64) with ``seq_shard_axis="cp"`` and
  ``cp_impl`` "ring" and "ulysses": each rank's logits against the flat
  model's slice at the shard's global positions (1e-5), and the grads of
  the CE summed over the ranks' shards, summed over the ranks, against
  the flat model's (1e-5 of each leaf's largest value);
- `ulysses_attention` forward and vjp (causal GQA, and a KV head count
  below the group size, which repeats the KV heads) within 1e-5; its
  ValueErrors with JAX's messages; ``fallback="ring"`` equal to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from apex1_tpu.core.mesh import make_mesh
from apex1_tpu.core.policy import get_policy as jax_get_policy
from apex1_tpu.models.llama import Llama as JaxLlama
from apex1_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from apex1_tpu.ops import _common as jax_common
from apex1_tpu.ops import softmax_cross_entropy_loss
from apex1_tpu.parallel.ulysses import ulysses_attention as jax_ulysses
from apex1_tpu_torch.interop import named_from_flax
from apex1_tpu_torch.parallel import launch

import torch_dist_ranks

WORLDS = (2, 4)
B, S, VOCAB = 2, 64, 97
CFG = dict(vocab_size=VOCAB, max_seq_len=S)
HQ, SL, D = 4, 8, 16
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(n):
    rng = np.random.default_rng(50 + n)
    tok = rng.integers(0, VOCAB, (B, S)).astype(np.int32)
    lbl = rng.integers(0, VOCAB, (B, S)).astype(np.int32)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"tokens": np.stack(np.split(tok, n, axis=1)),
            "labels": np.stack(np.split(lbl, n, axis=1)),
            "q": f(n, B, HQ, SL, D), "k": f(n, B, 2, SL, D),
            "v": f(n, B, 2, SL, D), "k1": f(n, B, 1, SL, D),
            "v1": f(n, B, 1, SL, D), "do": f(n, B, HQ, SL, D),
            "_tok": tok, "_lbl": lbl}


def _jax_run(n, i):
    jcfg = JaxLlamaConfig.tiny(policy=jax_get_policy("O0"), **CFG)
    model = JaxLlama(jcfg)
    params = model.init(jax.random.key(0), jnp.asarray(i["_tok"]))["params"]

    def loss(p):
        logits = model.apply({"params": p}, jnp.asarray(i["_tok"]))
        ce = softmax_cross_entropy_loss(logits.astype(jnp.float32),
                                        jnp.asarray(i["_lbl"]))
        return jnp.sum(ce), logits

    with jax_common.force_impl("xla"):
        (_, logits), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(params)
    mesh = make_mesh(cp=n, dp=1, devices=jax.devices()[:n])

    def body(q, k, v, k1, v1, do):
        out = {}
        for name, (kk, vv) in (("gqa", (k, v)), ("gqa_rep", (k1, v1))):
            if out:
                # each case starts once the previous one's outputs exist
                # (XLA:CPU may run two independent cases' collectives in
                # different orders on the devices; see
                # tests/test_torch_tensor_parallel.py's _jax_cases)
                _, q, kk, vv, do = jax.lax.optimization_barrier(
                    (out["gqa"], q, kk, vv, do))
            y, back = jax.vjp(lambda q, k, v: jax_ulysses(
                q[0], k[0], v[0], "cp", causal=True)[None], q, kk, vv)
            out[name] = [y, *back(do)]
        _, q, k1, v1 = jax.lax.optimization_barrier(
            (out["gqa_rep"], q, k1, v1))
        out["fallback"] = jax_ulysses(q[0][:, :3], k1[0], v1[0], "cp",
                                      causal=True, fallback="ring")[None]
        return out

    with jax_common.force_impl("xla"):
        att = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(P("cp"),) * 6, out_specs=P("cp"),
            check_vma=False))(*(jnp.asarray(i[k]) for k in
                                ("q", "k", "v", "k1", "v1", "do")))
    errors = []
    for fn in (lambda: jax_ulysses(jnp.asarray(i["q"][0][:, :3]),
                                   jnp.asarray(i["k"][0][:, :1]),
                                   jnp.asarray(i["v"][0][:, :1]), "cp"),
               lambda: jax_ulysses(jnp.asarray(i["q"][0]),
                                   jnp.asarray(i["k"][0]),
                                   jnp.asarray(i["v"][0]), "cp",
                                   fallback="tree")):
        try:
            jax.eval_shape(jax.shard_map(lambda: fn()[None], mesh=mesh,
                                         in_specs=(), out_specs=P("cp"),
                                         check_vma=False))
            errors.append("no error")
        except ValueError as e:
            errors.append(f"ValueError: {e}")
    return dict(params=jax.tree_util.tree_map(np.asarray, params),
                logits=np.asarray(logits),
                grads=named_from_flax(jax.tree_util.tree_map(np.asarray,
                                                             grads)),
                att=jax.tree_util.tree_map(np.asarray, att), errors=errors)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"cp{n}")
def world(request):
    n = request.param
    i = _inputs(n)
    jx = _jax_run(n, i)
    port_in = {k: v for k, v in i.items() if not k.startswith("_")}
    port_in["params"] = jx["params"]
    port = launch(torch_dist_ranks.llama_cp_cases, n, port_in, n, CFG,
                  backend="gloo", timeout=120)
    return dict(n=n, port=port, jax=jx)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_llama_seq_shard_matches_flat_jax(world, impl):
    n, jx = world["n"], world["jax"]
    sl = S // n
    total = {}
    for r, got in enumerate(world["port"]):
        got = got[impl]
        np.testing.assert_allclose(got["logits"],
                                   jx["logits"][:, r * sl:(r + 1) * sl],
                                   err_msg=f"logits rank {r}", **TOL)
        for k, g in got["grads"].items():
            total[k] = total.get(k, 0) + g
    assert sorted(total) == sorted(jx["grads"])
    for k, g in total.items():
        w = jx["grads"][k]
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("name", ["gqa", "gqa_rep"])
def test_ulysses_attention_matches_jax(world, name):
    want = world["jax"]["att"][name]
    for r, got in enumerate(world["port"]):
        for j, (g, w) in enumerate(zip(got[f"ulysses_{name}"], want)):
            np.testing.assert_allclose(g, w[r], err_msg=f"output {j} rank "
                                       f"{r} (out, dq, dk, dv)", **TOL)


def test_ulysses_errors_and_ring_fallback_match_jax(world):
    for r, got in enumerate(world["port"]):
        assert got["errors"] == world["jax"]["errors"]
        np.testing.assert_allclose(got["fallback"],
                                   world["jax"]["att"]["fallback"][r],
                                   **TOL)
