"""The port's Mixture-of-Experts (`transformer.moe`), Llama's MoE blocks
and the int8 decoder's MoE layers against the JAX package, on the CPU.

- `router`: the dispatch tensor bit for bit at top-1 and top-2, with
  drops at capacity (the same tokens dropped), with a token mask; with
  forced ties (a zero gate: every probability equal) dispatch and
  combine bit for bit, the lower expert index first; elsewhere combine
  within 1e-6 and aux within 1e-6 relative (XLA's dot and exp round the
  last bit otherwise than torch's);
- `MoEMLP` from the flax module's params: y, aux and the grads of x and
  the three weights within 1e-5;
- `moe_shard_map_apply` on gloo ep = 2 and 4 (rank r against device r of
  JAX's ``shard_map``, this rank's tokens and experts), with and without
  ``stats_axes``: y, aux and the vjp's grads within 1e-5; `param_specs`
  and `shard_params` give the ep slice;
- a tiny Llama with ``moe_every=2``: the loss with the sowed balance
  terms and every grad leaf within 1e-5 of JAX's, both heads;
- the int8 decoder with MoE layers: the quantized tree bit for bit,
  prefill logits within 1e-5 and greedy `generate` streams equal to
  JAX's.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from apex1_tpu.core.mesh import make_mesh
from apex1_tpu.core.policy import get_policy as jax_get_policy
from apex1_tpu.models.generate import generate as jax_generate
from apex1_tpu.models.llama import Llama as JaxLlama
from apex1_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from apex1_tpu.models.llama import llama_loss_fn as jax_llama_loss_fn
from apex1_tpu.models.quant_decode import \
    llama_quant_decoder as jax_llama_quant_decoder
from apex1_tpu.ops import _common as jax_common
from apex1_tpu.transformer import moe as jmoe
from apex1_tpu_torch import (LlamaConfig, get_policy, llama_loss_fn,
                             llama_params_from_jax)
from apex1_tpu_torch.interop import named_from_flax
from apex1_tpu_torch.models.generate import generate
from apex1_tpu_torch.models.quant_decode import llama_quant_decoder
from apex1_tpu_torch.parallel import launch
from apex1_tpu_torch.transformer import moe

import torch_dist_ranks

TOL = dict(rtol=1e-5, atol=1e-5)
H, F = 8, 16
ROUTER_CASES = {"top2": dict(num_experts=8, top_k=2, capacity_factor=1.25),
                "top1_drops": dict(num_experts=4, top_k=1,
                                   capacity_factor=0.5),
                "top2_drops": dict(num_experts=4, top_k=2,
                                   capacity_factor=0.5)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _router_inputs(seed, T=37, E=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T, H)).astype(np.float32),
            (rng.standard_normal((H, E)) * 0.7).astype(np.float32),
            rng.random(T) > 0.2)


@pytest.mark.parametrize("case", list(ROUTER_CASES))
@pytest.mark.parametrize("masked", [False, True])
def test_router_matches_jax(case, masked):
    kw = ROUTER_CASES[case]
    x, wg, mask = _router_inputs(3, E=kw["num_experts"])
    jc, tc = (jmoe.MoEConfig(hidden_size=H, ffn_size=F, **kw),
              moe.MoEConfig(hidden_size=H, ffn_size=F, **kw))
    want = jax.jit(lambda x, w, m: jmoe.router(x, w, jc, m))(
        x, wg, mask if masked else None)
    got = moe.router(_t(x), _t(wg), tc, _t(mask) if masked else None)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-6)
    if "drops" in case:
        assert got[0].sum() < kw["top_k"] * x.shape[0]


@pytest.mark.parametrize("k", [1, 2])
def test_router_ties_bitwise(k):
    """A zero gate ties every expert: the lower index wins, as
    ``jax.lax.top_k`` orders equal values."""
    x, _, mask = _router_inputs(4)
    wg = np.zeros((H, 8), np.float32)
    jc = jmoe.MoEConfig(num_experts=8, top_k=k, capacity_factor=2.0,
                        hidden_size=H, ffn_size=F)
    tc = moe.MoEConfig(num_experts=8, top_k=k, capacity_factor=2.0,
                       hidden_size=H, ffn_size=F)
    for m in (None, mask):
        want = jax.jit(lambda x, w, m: jmoe.router(x, w, jc, m))(x, wg, m)
        got = moe.router(_t(x), _t(wg), tc, None if m is None else _t(m))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    vals, idx = moe.top_k(torch.tensor([[1.0, 3.0, 3.0, 0.5, 3.0]]), 2)
    assert idx.tolist() == [[1, 2]] and vals.tolist() == [[3.0, 3.0]]


def test_moe_mlp_defaults_to_cuda():
    """Without device=, `MoEMLP` puts its parameters on CUDA, and raises
    where there is none (never a silent CPU module)."""
    cfg = moe.MoEConfig(num_experts=4, top_k=2, hidden_size=H, ffn_size=F)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            moe.MoEMLP(cfg)
        return
    m = moe.MoEMLP(cfg)
    assert {p.device.type for p in m.parameters()} == {"cuda"}


def test_moe_mlp_matches_flax():
    rng = np.random.default_rng(6)
    cfg_kw = dict(num_experts=4, top_k=2, capacity_factor=1.0,
                  hidden_size=H, ffn_size=F)
    x = rng.standard_normal((2, 9, H)).astype(np.float32)
    ct = rng.standard_normal((2, 9, H)).astype(np.float32)
    jm = jmoe.MoEMLP(jmoe.MoEConfig(**cfg_kw))
    params = jm.init(jax.random.key(1), jnp.asarray(x))["params"]
    (y, aux), back = jax.vjp(lambda p, x: jm.apply({"params": p}, x),
                             params, jnp.asarray(x))
    gp, gx = back((jnp.asarray(ct), jnp.float32(1.0)))
    tm = moe.MoEMLP(moe.MoEConfig(**cfg_kw), device="cpu")
    with torch.no_grad():
        for k in ("router", "w1", "w2"):
            getattr(tm, k).copy_(_t(np.asarray(params[k])))
    xt = _t(x).requires_grad_()
    ty, taux = tm(xt)
    grads = torch.autograd.grad([ty, taux], [xt, tm.router, tm.w1, tm.w2],
                                [_t(ct), torch.tensor(1.0)])
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y), **TOL)
    np.testing.assert_allclose(float(taux.detach()), float(aux), rtol=1e-5)
    for g, w in zip(grads, (gx, gp["router"], gp["w1"], gp["w2"])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    specs = moe.param_specs(dict(tm.named_parameters()))
    assert specs == {"router": (), "w1": ("ep", None, None),
                     "w2": ("ep", None, None)}


# ---- expert parallelism over gloo ------------------------------------------

EP_CFG = dict(num_experts=4, top_k=2, capacity_factor=1.0, hidden_size=H,
              ffn_size=F)
WORLDS = (2, 4)
T_LOCAL = 6


def _ep_inputs(n):
    rng = np.random.default_rng(40 + n)
    return {"x": rng.standard_normal((n, T_LOCAL, H)).astype(np.float32),
            "ct": rng.standard_normal((n, T_LOCAL, H)).astype(np.float32),
            "wg": (rng.standard_normal((H, 4)) * 0.7).astype(np.float32),
            "w1": (rng.standard_normal((4, H, F)) * 0.3).astype(np.float32),
            "w2": (rng.standard_normal((4, F, H)) * 0.3).astype(np.float32)}


def _jax_ep(n, i):
    mesh = make_mesh(ep=n, dp=1, devices=jax.devices()[:n])
    cfg = jmoe.MoEConfig(**EP_CFG)

    def body(x, ct, wg, w1, w2):
        out = {}
        for name, kw in (("plain", {}), ("stats", dict(stats_axes="ep"))):
            if out:
                # the second case starts once the first one's outputs
                # exist (XLA:CPU may run two independent cases'
                # collectives in different orders on the devices; see
                # tests/test_torch_tensor_parallel.py's _jax_cases)
                _, x, ct = jax.lax.optimization_barrier(
                    (out["plain"], x, ct))
            (y, aux), back = jax.vjp(
                lambda x, wg, w1, w2: jmoe.moe_shard_map_apply(
                    x[0], wg, w1, w2, cfg, **kw), x, wg, w1, w2)
            gx, gwg, gw1, gw2 = back((ct[0], jnp.float32(1.0)))
            out[name] = [y[None], aux[None], gx, gwg[None], gw1, gw2]
        return out

    fn = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P("ep"), P("ep"), P(), P("ep"),
                                   P("ep")),
        out_specs={"plain": [P("ep")] * 6, "stats": [P("ep")] * 6},
        check_vma=False))
    out = fn(*(jnp.asarray(i[k]) for k in ("x", "ct", "wg", "w1", "w2")))
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"ep{n}")
def ep_world(request):
    n = request.param
    i = _ep_inputs(n)
    with ThreadPoolExecutor(1) as ex:
        port = ex.submit(launch, torch_dist_ranks.moe_cases, n, i, n,
                         EP_CFG, backend="gloo")
        return dict(n=n, port=port.result(), jax=_jax_ep(n, i), inputs=i)


@pytest.mark.parametrize("name", ["plain", "stats"])
def test_moe_shard_map_apply_matches_jax(ep_world, name):
    n, want = ep_world["n"], ep_world["jax"][name]
    e = 4 // n
    for r, got in enumerate(ep_world["port"]):
        g = got[name]
        w = [want[0][r], want[1][r], want[2][r],
             want[3][r], want[4][r * e:(r + 1) * e],
             want[5][r * e:(r + 1) * e]]
        for j, (a, b) in enumerate(zip(g, w)):
            np.testing.assert_allclose(a, b, err_msg=f"output {j} rank {r}",
                                       **TOL)


def test_shard_params_takes_the_ep_slice(ep_world):
    n, i = ep_world["n"], ep_world["inputs"]
    e = 4 // n
    for r, got in enumerate(ep_world["port"]):
        np.testing.assert_array_equal(got["shard"]["router"], i["wg"])
        for k in ("w1", "w2"):
            np.testing.assert_array_equal(got["shard"][k],
                                          i[k][r * e:(r + 1) * e])


# ---- Llama's MoE blocks and the int8 decoder -------------------------------

VOCAB = 97
LLAMA_KW = dict(vocab_size=VOCAB, max_seq_len=64, moe_every=2, num_experts=4,
                moe_top_k=2, moe_capacity_factor=1.0)


@pytest.fixture(scope="module")
def llama():
    tok = np.random.default_rng(8).integers(0, VOCAB, (2, 24)).astype(
        np.int32)
    jcfg = JaxLlamaConfig.tiny(policy=jax_get_policy("O0"), **LLAMA_KW)
    params = JaxLlama(jcfg).init(jax.random.key(0), jnp.asarray(tok))[
        "params"]
    return dict(tok=tok, params=params,
                np_params=jax.tree_util.tree_map(np.asarray, params))


@pytest.mark.parametrize("fuse_head", [False, True])
def test_llama_moe_every_matches_jax(llama, fuse_head):
    jcfg = JaxLlamaConfig.tiny(policy=jax_get_policy("O0"), **LLAMA_KW)
    tcfg = LlamaConfig.tiny(policy=get_policy("O0"), **LLAMA_KW)
    with jax_common.force_impl("xla"):
        wl, wg = jax.value_and_grad(jax_llama_loss_fn(
            JaxLlama(jcfg), fuse_head=fuse_head))(llama["params"],
                                                  jnp.asarray(llama["tok"]))
    model = llama_params_from_jax(llama["np_params"], tcfg, "cpu")
    assert "layer1.moe.w1" in dict(model.named_parameters())
    params = {k: v.detach().requires_grad_()
              for k, v in model.named_parameters()}
    loss = llama_loss_fn(model, fuse_head=fuse_head)(
        params, _t(llama["tok"]).long())
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(float(loss), float(wl), rtol=1e-5)
    want = named_from_flax(jax.tree_util.tree_map(np.asarray, wg))
    assert sorted(want) == sorted(params)
    for k, g in zip(params, grads):
        np.testing.assert_allclose(g.numpy(), want[k], err_msg=k, **TOL)


def test_int8_decoder_with_moe_layers_matches_jax(llama):
    jcfg = JaxLlamaConfig.tiny(policy=jax_get_policy("O0"), **LLAMA_KW)
    tcfg = LlamaConfig.tiny(policy=get_policy("O0"), **LLAMA_KW)
    jmodel = JaxLlama(jcfg)
    japply, jmake, jq = jax_llama_quant_decoder(jmodel, llama["params"])
    model = llama_params_from_jax(llama["np_params"], tcfg, "cpu")
    apply_fn, make_cache, tq = llama_quant_decoder(model)
    jflat = jax.tree_util.tree_map(np.asarray, jq)
    for k in ("router", "w1", "w2"):
        leaf = jflat["layer1"]["moe"][k]
        got = tq["layer1"]["moe"][k]
        if k == "router":
            np.testing.assert_array_equal(got.numpy(), leaf)
        else:
            for part in ("q", "s"):
                np.testing.assert_array_equal(got[part].numpy(), leaf[part])
    prompt = llama["tok"][:, :5]
    with jax_common.force_impl("xla"):
        want_logits, _ = japply(jq, jnp.asarray(prompt), jmake(2, 16), 0)
        want = np.asarray(jax_generate(japply, jq, jnp.asarray(prompt),
                                       max_new_tokens=8,
                                       cache=jmake(2, 16)))
    logits, _ = apply_fn(_t(prompt), make_cache(2, 16), 0)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               **TOL)
    got = generate(apply_fn, _t(prompt), max_new_tokens=8,
                   cache=make_cache(2, 16)).numpy()
    np.testing.assert_array_equal(got, want)
