"""The port's `models.llama_3d` against the JAX package, on the CPU.

A tiny Llama (4 layers, vocab 64, 4 query and 2 KV heads of 8, hidden
32, ffn 64, S 32; M = 4 microbatches of 2 sequences) from the JAX
package's flax init, carried across through numpy. The port's ranks
run under gloo (one launch per world size, bodies in
tests/torch_dist_ranks.py), each on its own mesh and shards; rank r's
coordinates are device r's in JAX's ``make_mesh``.

- O0 loss and every combined grad leaf (this rank's shard) of one
  forward and backward against the JAX flat Llama's ``value_and_grad``
  of the mean CE over the microbatches (plus the sowed MoE balance
  terms), loss 1e-5 relative and grads within 1e-5 of their leaf's
  largest value, at pp 2, pp 2 x V 2, pp 2 x tp 2, pp 2 x cp 2 (ring
  attention) and pp 2 x ep 2 with every FFN expert-routed (4 experts,
  top-2, capacity 4), scan and 1f1b; pp 2 x dp 2 x V 2 on the
  interleaved 1F1B;
- pp 2 x tp 2 against JAX's own ``make_train_step`` on the same
  4-device layout: one O0 step's loss and updated params (1e-5), and a
  3-step O2 trajectory (losses and params within 2e-2);
- an O2_fp16 step with a forced overflow: skipped, params and both
  Adam moments bit-identical, the scale halved;
- single-process: `init_params`, `from_llama_params` and
  `reshape_chunks` equal JAX's bit for bit; every `Llama3DConfig`
  ValueError with JAX's message; `interop.llama3d_state_from_jax`
  carries JAX's Adam state; `abstract_state` is meta.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex1_tpu.core.mesh import make_mesh as jax_make_mesh
from apex1_tpu.core.policy import get_policy as jax_get_policy
from apex1_tpu.models import llama_3d as J3
from apex1_tpu.models.llama import Llama as JaxLlama
from apex1_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from apex1_tpu.ops import softmax_cross_entropy_loss
from apex1_tpu_torch import LlamaConfig, get_policy
from apex1_tpu_torch.core.mesh import MESH_AXES
from apex1_tpu_torch.interop import named_from_flax
from apex1_tpu_torch.models import llama_3d as L3
from apex1_tpu_torch.parallel import launch

import torch_dist_ranks

M, S, MB = 4, 32, 2
KW = dict(num_layers=4, max_seq_len=S, vocab_size=64, num_heads=4,
          num_kv_heads=2, hidden_size=32, ffn_size=64)
MOE_KW = dict(KW, moe_every=1, num_experts=4, moe_top_k=2,
              moe_capacity_factor=4.0)
MODEL_KW = {False: KW, True: MOE_KW}
LAYOUTS = {
    2: {"pp2": dict(pp=2, microbatch_size=2),
        "pp2_1f1b": dict(pp=2, microbatch_size=2, schedule="1f1b"),
        "pp2_v2": dict(pp=2, microbatch_size=2, num_chunks=2),
        "pp2_v2_1f1b": dict(pp=2, microbatch_size=2, num_chunks=2,
                            schedule="1f1b")},
    4: {"pp2_tp2": dict(pp=2, tp=2, microbatch_size=2),
        "pp2_tp2_1f1b": dict(pp=2, tp=2, microbatch_size=2,
                             schedule="1f1b"),
        "pp2_cp2": dict(pp=2, cp=2, microbatch_size=2),
        "pp2_cp2_1f1b": dict(pp=2, cp=2, microbatch_size=2,
                             schedule="1f1b"),
        "pp2_ep2_moe": dict(pp=2, ep=2, moe=True, microbatch_size=1),
        "pp2_ep2_moe_1f1b": dict(pp=2, ep=2, moe=True, microbatch_size=1,
                                 schedule="1f1b"),
        "pp2_dp2_v2_1f1b": dict(pp=2, dp=2, num_chunks=2, microbatch_size=1,
                                schedule="1f1b"),
        "step_o0": dict(pp=2, tp=2, microbatch_size=2, steps=1),
        "step_o2": dict(pp=2, tp=2, microbatch_size=2, steps=3,
                        level="O2")}}
GRAD_CASES = {n: [name for name, lay in lays.items() if "steps" not in lay]
              for n, lays in LAYOUTS.items()}


def _jcfg(moe, level="O0"):
    return JaxLlamaConfig.tiny(policy=jax_get_policy(level),
                               **MODEL_KW[moe])


def _jcfg3d(lay):
    lay = dict(lay)
    moe = lay.pop("moe", False)
    lay.pop("steps", None)
    level = lay.pop("level", "O0")
    return J3.Llama3DConfig(model=_jcfg(moe, level), moe=moe,
                            num_microbatches=M, **lay)


@pytest.fixture(scope="module")
def gold():
    """The flat JAX Llama's params, batch, and O0 loss and grads, for
    the dense and the MoE model."""
    rng = np.random.default_rng(11)
    out = {"flat": {}, "tokens": {}, "labels": {}, "jflat": {}, "want": {}}
    for moe in (False, True):
        tok = rng.integers(0, 64, (M, S, MB)).astype(np.int32)
        lbl = rng.integers(0, 64, (M, S, MB)).astype(np.int32)
        model = JaxLlama(_jcfg(moe))
        flat = model.init(jax.random.key(0), jnp.asarray(tok[0].T))["params"]

        def loss(flat, model=model, tok=tok, lbl=lbl):
            def per(t, l):
                logits, av = model.apply({"params": flat}, t.T,
                                         mutable=["losses"])
                ce = softmax_cross_entropy_loss(
                    logits.astype(jnp.float32), l.T)
                aux = sum(jnp.sum(jnp.asarray(v)) for v in
                          jax.tree_util.tree_leaves(av.get("losses", {})))
                return ce, aux
            ces, auxes = jax.vmap(per)(jnp.asarray(tok), jnp.asarray(lbl))
            return jnp.mean(ces) + jnp.mean(auxes)

        out["want"][moe] = jax.jit(jax.value_and_grad(loss))(flat)
        out["jflat"][moe] = flat
        out["flat"][moe] = named_from_flax(
            jax.tree_util.tree_map(np.asarray, flat))
        out["tokens"][moe], out["labels"][moe] = tok, lbl
    return out


def _jax_steps(gold, lay, steps):
    """JAX's make_train_step on the layout's devices: the losses and the
    global params after ``steps`` steps."""
    cfg = _jcfg3d(lay)
    mesh = jax_make_mesh(dp=cfg.dp, pp=cfg.pp, cp=cfg.cp, ep=cfg.ep,
                         tp=cfg.tp, devices=jax.devices()[:4])
    chunk, shared = J3.from_llama_params(gold["jflat"][False], cfg)
    step, state, _ = J3.make_train_step(
        cfg, mesh, params={"chunk": chunk, "shared": shared})
    losses = []
    for _ in range(steps):
        state, loss = step(state, jnp.asarray(gold["tokens"][False]),
                           jnp.asarray(gold["labels"][False]))
        losses.append(float(loss))
    return losses, jax.tree_util.tree_map(np.asarray, state["params"])


def _world(n, gold):
    start_cfg = _jcfg3d(LAYOUTS[4]["step_o0"])
    chunk, shared = J3.from_llama_params(gold["jflat"][False], start_cfg)
    inputs = dict(flat=gold["flat"], tokens=gold["tokens"],
                  labels=gold["labels"],
                  start=jax.tree_util.tree_map(
                      np.asarray, {"chunk": chunk, "shared": shared}))
    lays = {k: dict(v, num_microbatches=M) for k, v in LAYOUTS[n].items()}
    with ThreadPoolExecutor(2) as ex:
        port = ex.submit(launch, torch_dist_ranks.llama_3d_cases, n, inputs,
                         lays, MODEL_KW, backend="gloo", timeout=240)
        over = (ex.submit(launch, torch_dist_ranks.llama_3d_overflow, 2,
                          inputs, dict(pp=2, num_microbatches=M,
                                       microbatch_size=2), KW,
                          backend="gloo", timeout=240) if n == 2 else None)
        jx = {}
        for name, lay in LAYOUTS[n].items():
            if lay.get("steps"):
                jx[name] = _jax_steps(gold, lay, lay["steps"])
        return dict(n=n, port=port.result(), jax=jx, inputs=inputs,
                    overflow=None if over is None else over.result())


@pytest.fixture(scope="module")
def world2(gold):
    return _world(2, gold)


@pytest.fixture(scope="module")
def world4(gold):
    return _world(4, gold)


def _shard(x, spec, coords, sizes):
    x = np.asarray(x)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        x = np.split(x, sizes[ax], axis=d)[coords[ax]]
    return x


def _want_local(tree_chunk, tree_shared, cfg, got):
    coords = dict(zip(MESH_AXES, got["coords"]))
    sizes = dict(zip(MESH_AXES, got["sizes"]))
    cs, ss = J3.chunk_param_specs(cfg), J3.shared_param_specs()
    out = {f"chunk.{k}": _shard(v, tuple(cs[k]), coords, sizes)[:, 0]
           for k, v in tree_chunk.items()}
    out.update({f"shared.{k}": _shard(v, tuple(ss[k]), coords, sizes)
                for k, v in tree_shared.items()})
    return out


def _check_grads(world, gold, name):
    lay = LAYOUTS[world["n"]][name]
    cfg = _jcfg3d(lay)
    moe = lay.get("moe", False)
    wl, wg = gold["want"][moe]
    gc, gs = J3.from_llama_params(wg, cfg)
    for r, got in enumerate(world["port"]):
        got = got[name]
        np.testing.assert_allclose(got["loss"], float(wl), rtol=1e-5,
                                   err_msg=f"loss rank {r}")
        want = _want_local(gc, gs, cfg, got)
        assert sorted(want) == sorted(got["grads"])
        for k, w in want.items():
            np.testing.assert_allclose(
                got["grads"][k], w, rtol=1e-5,
                atol=1e-5 * np.abs(w).max(), err_msg=f"{k} rank {r}")


@pytest.mark.parametrize("name", GRAD_CASES[2])
def test_loss_and_grads_match_flat_jax_world2(world2, gold, name):
    _check_grads(world2, gold, name)


@pytest.mark.parametrize("name", GRAD_CASES[4])
def test_loss_and_grads_match_flat_jax_world4(world4, gold, name):
    _check_grads(world4, gold, name)


@pytest.mark.parametrize("name,tol", [("step_o0", 1e-5), ("step_o2", 2e-2)])
def test_steps_match_jax_make_train_step(world4, name, tol):
    world = world4
    losses, params = world["jax"][name]
    cfg = _jcfg3d(LAYOUTS[4][name])
    for r, got in enumerate(world["port"]):
        got = got[name]
        np.testing.assert_allclose(got["losses"], losses, rtol=tol,
                                   err_msg=f"losses rank {r}")
        assert int(got["step"]) == len(losses)
        want = _want_local(params["chunk"], params["shared"], cfg, got)
        for k, w in want.items():
            np.testing.assert_allclose(got["params"][k], w, rtol=tol,
                                       atol=tol * np.abs(w).max(),
                                       err_msg=f"{k} rank {r}")


def test_fp16_overflow_skips_the_step(world2):
    for got in world2["overflow"]:
        assert np.isfinite(got["losses"][0])
        assert not np.isfinite(got["losses"][1])
        assert got["same"] == {"params": True, "exp_avg": True,
                               "exp_avg_sq": True}
        assert got["step"][1] == got["step"][0]
        assert got["scale"][1] == got["scale"][0] / 2
        assert got["overflow"] == [0, 1]


@pytest.mark.parametrize("n", [2, 4])
def test_abstract_state_is_meta(world2, world4, n):
    for got in {2: world2, 4: world4}[n]["port"]:
        ab = got["abstract"]
        assert ab["meta"]
        assert ab["data"][0] == M and ab["data"][1] == S
        assert all(shape for shape in ab["shapes"].values())


# ---- single process ---------------------------------------------------------


def _port_cfg(lay, level="O0"):
    lay = dict(lay)
    moe = lay.pop("moe", False)
    return L3.Llama3DConfig(model=LlamaConfig.tiny(
        policy=get_policy(level), **MODEL_KW[moe]), moe=moe, **lay)


@pytest.mark.parametrize("lay", [dict(pp=2, num_chunks=2), dict(pp=4),
                                 dict(pp=2, tp=2, moe=True, ep=2)])
def test_trees_equal_jax_bitwise(gold, lay):
    jcfg, cfg = _jcfg3d(lay), _port_cfg(lay)
    moe = lay.get("moe", False)
    for (jc, js_), (tc, ts) in (
            (J3.init_params(jcfg, seed=3), L3.init_params(cfg, 3, "cpu")),
            (J3.from_llama_params(gold["jflat"][moe], jcfg),
             L3.from_llama_params({k: torch.from_numpy(v.copy()) for k, v in
                                   gold["flat"][moe].items()}, cfg))):
        for k in jc:
            np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
        for k in js_:
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js_[k]))
    to = dataclasses.replace(jcfg, pp=1, num_chunks=1)
    for k, v in J3.reshape_chunks(jc, to).items():
        got = L3.reshape_chunks(tc, dataclasses.replace(cfg, pp=1,
                                                        num_chunks=1))[k]
        np.testing.assert_array_equal(got.numpy(), np.asarray(v))


@pytest.mark.parametrize("kw", [
    dict(schedule="gpipe"), dict(pp=2, num_chunks=2, num_microbatches=3,
                                 schedule="1f1b"),
    dict(num_chunks=2, schedule="1f1b"), dict(pp=3), dict(tp=3),
    dict(cp=3), dict(pp=2, num_chunks=2, num_microbatches=1),
    dict(ep=2), dict(moe=True, ep=3)])
def test_config_errors_match_jax(kw):
    with pytest.raises(ValueError) as want:
        J3.Llama3DConfig(model=_jcfg(False), **kw)
    with pytest.raises(ValueError) as got:
        L3.Llama3DConfig(model=LlamaConfig.tiny(policy=get_policy("O0"),
                                                **KW), **kw)
    assert str(got.value) == str(want.value)


def test_state_from_jax_carries_adam(gold):
    from apex1_tpu_torch.interop import llama3d_state_from_jax
    cfg = _jcfg3d(dict(pp=1))
    chunk, shared = J3.from_llama_params(gold["jflat"][False], cfg)
    st = J3.state_template(cfg, params={"chunk": chunk, "shared": shared})
    opt = jax.tree_util.tree_map(lambda x: np.asarray(x) + 0.5, st["opt"])
    opt = opt._replace(step=np.int32(1)) if hasattr(opt, "_replace") else \
        dataclasses.replace(opt, step=np.int32(1))
    from apex1_tpu_torch.core.mesh import Mesh
    # a one-rank mesh without a process group: every axis of size 1
    mesh = type("OneRank", (), dict(size=lambda self, a: 1,
                                    index=lambda self, a: 0,
                                    local_shard=Mesh.local_shard))()
    got = llama3d_state_from_jax(
        jax.tree_util.tree_map(np.asarray, st["params"]),
        _port_cfg(dict(pp=1)), mesh, opt_state=opt, device="cpu")
    assert int(got["step"]) == int(got["opt"].step) == 1
    np.testing.assert_array_equal(got["opt"].exp_avg["chunk.wq"].numpy(),
                                  np.asarray(opt.exp_avg["chunk"]["wq"])[:, 0])
    np.testing.assert_array_equal(got["params"]["shared.emb"].numpy(),
                                  np.asarray(shared["emb"]))
