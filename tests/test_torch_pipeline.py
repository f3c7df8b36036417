"""The port's pipeline parallelism against the JAX package's, on the CPU.

The port's ranks run under gloo (`apex1_tpu_torch.parallel.launch`, one
launch per world size, bodies in tests/torch_dist_ranks.py) on a pp = n
mesh; the JAX package runs the same cases under ``shard_map`` on its
8-device CPU mesh (axis ``pp``, device r = rank r). Stage: linear + tanh
(tests/test_pipeline.py's), D 16. At pp 2 and 4, fp32 within 1e-5:

- the scan schedule at V 1 and 2, M 4 and 8: the broadcast outputs and
  the loss and grads of `forward_backward_pipelining_*` against JAX's
  ``value_and_grad`` of ``pipelined_loss_fn`` (this rank's stage
  column); the partial convention (``broadcast_outputs=False``, the
  loss masked to the last stage) and ``remat_stage`` give the same
  grads; a padded ``boundary_shape``; the ``with_aux`` channel's
  per-rank outputs, aux and grads taken inside;
- `one_f_one_b` plain (V 1), with ``loss_params`` and aux (V 1 and 2)
  and interleaved with ``skip_idle=False``: each rank's loss sum,
  grads, microbatch cotangents, loss-param grads and aux sum;
- the tied embedding: `pipeline_tied_apply` in both conventions, the
  tied grads summed by `allreduce_embedding_grads`, against JAX's
  outer convention;
- the p2p shifts and their transposes, bit for bit, and the chained
  send/recv pair;
- the pp getters, the embedding group, the virtual-aware first and
  last stage and `get_forward_backward_func`;
- each ValueError the JAX package raises, with its message (the
  bubble-skip contract on a ring-bearing stage included).

Single-process: the microbatch calculators and
`forward_backward_no_pipelining` against JAX's, the enums and the
logging knob.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from apex1_tpu.core.mesh import make_mesh
from apex1_tpu.parallel.ring_attention import ring_attention as jax_ring
from apex1_tpu.transformer import enums as jenums
from apex1_tpu.transformer import microbatches as jmb
from apex1_tpu.transformer.pipeline_parallel import p2p_communication as jp2p
from apex1_tpu.transformer.pipeline_parallel import schedules as js
from apex1_tpu_torch.parallel import launch
from apex1_tpu_torch.transformer import enums, log_util, microbatches
from apex1_tpu_torch.transformer.pipeline_parallel import schedules

import torch_dist_ranks

WORLDS = (2, 4)
GRID = [(1, 4), (1, 8), (2, 4), (2, 8)]
D = 16
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(n: int) -> dict:
    rng = np.random.default_rng(30 + n)

    def f(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    i = {"w1": f(1, n, D, D, scale=0.5), "b1": f(1, n, D, scale=0.1),
         "w2": f(2, n, D, D, scale=0.5), "b2": f(2, n, D, scale=0.1),
         "mbs4": f(4, 2, D), "tg4": f(4, 2, D), "mbs8": f(8, 2, D),
         "tg8": f(8, 2, D), "mbs_narrow": f(4, 2, 12), "u": f(D),
         "emb": f(12, D, scale=0.5),
         "tok": rng.integers(0, 12, (4, 2)).astype(np.int32),
         "x": f(n, 3, D), "ct": f(n, 3, D)}
    return i


def _stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _stage_aux(p, x):
    y = _stage(p, x)
    return y, 0.01 * jnp.sum(y * y)


def _mse(outs, targets):
    return jnp.mean((outs - targets) ** 2)


def _embed(tied, tok):
    return tied["emb"][tok]


def _head(tied, outs):
    logits = jnp.einsum("mbd,vd->mbv", outs, tied["emb"])
    return -jnp.mean(jax.nn.log_softmax(logits.astype(jnp.float32))[..., 0],
                     axis=1)


def _jax_error(mesh, body) -> str:
    """The message of the ValueError that tracing ``body`` under
    shard_map raises."""
    fn = jax.shard_map(lambda: body()[None], mesh=mesh, in_specs=(),
                       out_specs=P("pp"), check_vma=False)
    try:
        jax.eval_shape(fn)
    except ValueError as e:
        return f"ValueError: {e}"
    return "no error"


def _jax_run(n: int, i: dict) -> dict:
    mesh = make_mesh(pp=n, devices=jax.devices()[:n])
    j = {k: jnp.asarray(v) for k, v in i.items()}
    out = {}

    def chunk(V):
        return {"w": j[f"w{V}"], "b": j[f"b{V}"]}

    for V, M in GRID:
        f = js.pipelined_loss_fn(_stage, _mse, mesh, num_chunks=V)
        loss, g = jax.jit(jax.value_and_grad(f))(chunk(V), j[f"mbs{M}"],
                                                  j[f"tg{M}"])

        def outs(params, mbs, V=V):
            local = jax.tree_util.tree_map(lambda p: p[:, 0], params)
            bc = js.pipeline_apply(_stage, local, mbs, num_chunks=V)
            # the second pipeline starts once the first one's outputs
            # exist (XLA:CPU may order two independent programs'
            # collectives differently on the devices; see
            # tests/test_torch_tensor_parallel.py's _jax_cases)
            _, local = jax.lax.optimization_barrier((bc, local))
            return (bc, js.pipeline_apply(_stage, local, mbs, num_chunks=V,
                                          broadcast_outputs=False)[None])

        bc, part = jax.jit(jax.shard_map(
            outs, mesh=mesh, in_specs=(P(None, "pp"), P()),
            out_specs=(P(), P("pp")), check_vma=False))(chunk(V),
                                                        j[f"mbs{M}"])
        out[f"V{V}_M{M}"] = dict(loss=np.asarray(loss),
                                 w=np.asarray(g["w"]), b=np.asarray(g["b"]),
                                 outs=np.asarray(bc), part=np.asarray(part))

    def bounded(params, mbs):
        local = jax.tree_util.tree_map(lambda p: p[:, 0], params)
        return js.pipeline_apply(_stage, local, mbs, num_chunks=2,
                                 boundary_shape=(2, 16),
                                 boundary_dtype=jnp.float32)

    out["boundary"] = np.asarray(jax.jit(jax.shard_map(
        bounded, mesh=mesh, in_specs=(P(None, "pp"), P()), out_specs=P(),
        check_vma=False))(chunk(2), j["mbs_narrow"]))

    def aux_body(params, mbs, tg):
        local = jax.tree_util.tree_map(lambda p: p[:, 0], params)

        def scalar(loc):
            y, aux = js.pipeline_apply(_stage_aux, loc, mbs, num_chunks=2,
                                       with_aux=True,
                                       broadcast_outputs=False)
            return _mse(y, tg) + aux, (y, aux)

        g, (y, aux) = jax.grad(scalar, has_aux=True)(local)
        return jax.tree_util.tree_map(lambda t: t[None],
                                      dict(y=y, aux=aux, w=g["w"],
                                           b=g["b"]))

    out["aux"] = jax.tree_util.tree_map(np.asarray, jax.jit(jax.shard_map(
        aux_body, mesh=mesh, in_specs=(P(None, "pp"), P(), P()),
        out_specs=P("pp"), check_vma=False))(chunk(2), j["mbs4"],
                                             j["tg4"]))

    # 1F1B, per rank
    lpar = {"u": j["u"]}

    def loss_plain(y, m):
        return _mse(y, j["tg4"][m])

    def loss_lp(lp_, y, m):
        return _mse(y * lp_["u"], j["tg4"][m])

    for name, V, kw in (
            ("plain", 1, dict(loss_mb=loss_plain)),
            ("lp_aux", 1, dict(loss_mb=loss_lp, loss_params=lpar,
                               with_aux=True, aux_cotangent=0.5)),
            ("v2_lp_aux", 2, dict(loss_mb=loss_lp, loss_params=lpar,
                                  with_aux=True, aux_cotangent=0.5)),
            ("v2_noskip", 2, dict(loss_mb=loss_plain, skip_idle=False))):
        stage = _stage_aux if kw.get("with_aux") else _stage
        lm = kw.pop("loss_mb")

        def body(params, mbs, V=V, kw=kw, stage=stage, lm=lm):
            local = jax.tree_util.tree_map(
                lambda p: p[:, 0] if V > 1 else p[0, 0], params)
            return list(js.one_f_one_b(stage, local, mbs, lm,
                                       num_chunks=V, **kw))

        out[f"1f1b_{name}"] = _per_rank_sharded(mesh, body, chunk(V),
                                                j["mbs4"])

    def tied_inner(params, tied, tok):
        local = jax.tree_util.tree_map(lambda p: p[:, 0], params)
        return jnp.mean(js.pipeline_tied_apply(_stage, local, _embed, _head,
                                               tied, tok))

    tied_f = jax.shard_map(tied_inner, mesh=mesh,
                           in_specs=(P(None, "pp"), P(), P()),
                           out_specs=P(), check_vma=False)
    loss, (gc, gt) = jax.jit(jax.value_and_grad(tied_f, argnums=(0, 1)))(
        chunk(1), {"emb": j["emb"]}, j["tok"])
    out["tied"] = dict(loss=np.asarray(loss), w=np.asarray(gc["w"]),
                       b=np.asarray(gc["b"]), emb=np.asarray(gt["emb"]))

    def p2p_body(x, ct):
        res = {}
        for name, fn in (("fwd", jp2p.send_forward_recv_forward),
                         ("bwd", jp2p.send_backward_recv_backward)):
            if res:     # one case after the other (as above)
                _, x, ct = jax.lax.optimization_barrier((res["fwd"], x, ct))
            y, back = jax.vjp(lambda a: fn(a[0])[None], x)
            res[name] = [y, back(ct)[0]]
        return res

    out["p2p"] = jax.tree_util.tree_map(np.asarray, jax.jit(jax.shard_map(
        p2p_body, mesh=mesh, in_specs=(P("pp"), P("pp")), out_specs=P("pp"),
        check_vma=False))(j["x"], j["ct"]))

    # the JAX package's error messages
    def ring(p, x):
        a = jax_ring(x[None, None], x[None, None], x[None, None], "pp")
        return _stage(p, a[0, 0])

    sp1 = {k: v[0, 0] for k, v in chunk(1).items()}
    loc1 = {k: v[:, 0] for k, v in chunk(1).items()}
    loc2 = {k: v[:, 0] for k, v in chunk(2).items()}
    out["errors"] = {
        "v2_few_mb": _jax_error(mesh, lambda: js.pipeline_apply(
            _stage, loc2, j["mbs4"][:n - 1], num_chunks=2)),
        "boundary": _jax_error(mesh, lambda: js.pipeline_apply(
            _stage, loc1, j["mbs4"], boundary_shape=(2, 8))),
        "1f1b_mod": _jax_error(mesh, lambda: js.one_f_one_b(
            _stage, loc2, j["mbs8"][:n + 1], loss_plain, num_chunks=2)[0]),
        "1f1b_aux": _jax_error(mesh, lambda: js.one_f_one_b(
            _stage_aux, sp1, j["mbs4"], loss_plain, with_aux=True)[0]),
        "skip_ring": _jax_error(mesh, lambda: js.pipeline_apply(
            ring, loc1, j["mbs4"])),
        "skip_idle_ring": _jax_error(mesh, lambda: js.one_f_one_b(
            ring, sp1, j["mbs4"], loss_plain)[0]),
        "no_skip_ring": "no error"}
    return out


def _per_rank_sharded(mesh, body, params, mbs):
    def inner(params, mbs):
        return jax.tree_util.tree_map(lambda t: jnp.asarray(t)[None],
                                      body(params, mbs))

    fn = jax.jit(jax.shard_map(inner, mesh=mesh,
                               in_specs=(P(None, "pp"), P()),
                               out_specs=P("pp"), check_vma=False))
    return jax.tree_util.tree_map(np.asarray, fn(params, mbs))


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"pp{n}")
def world(request):
    n = request.param
    inputs = _inputs(n)
    # the ranks run while JAX compiles
    with ThreadPoolExecutor(1) as ex:
        port = ex.submit(launch, torch_dist_ranks.pipeline_cases, n, inputs,
                         n, GRID, backend="gloo", timeout=120)
        jx = _jax_run(n, inputs)
        return dict(n=n, port=port.result(), jax=jx)


def _close(got, want, msg):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=msg, **TOL)


@pytest.mark.parametrize("V,M", GRID)
def test_scan_schedule_matches_jax(world, V, M):
    want = world["jax"][f"V{V}_M{M}"]
    n = world["n"]
    for s, got in enumerate(world["port"]):
        g = got[f"V{V}_M{M}"]
        _close(g["loss"], want["loss"], f"loss rank {s}")
        _close(g["outs"], want["outs"], f"outputs rank {s}")
        _close(g["part"], want["part"][s], f"partial outputs rank {s}")
        for k in ("w", "b"):
            for pre in ("", "part_", "remat_"):
                _close(g[pre + k], want[k][:, s], f"{pre}{k} rank {s}")
        assert (np.abs(g["part"]).max() == 0) == (s != n - 1)


def test_padded_boundary_and_aux_channel_match_jax(world):
    for s, got in enumerate(world["port"]):
        _close(got["boundary"], world["jax"]["boundary"], f"rank {s}")
        for k in ("y", "aux", "w", "b"):
            _close(got["aux"][k], world["jax"]["aux"][k][s],
                   f"aux channel {k} rank {s}")


@pytest.mark.parametrize("name", ["plain", "lp_aux", "v2_lp_aux",
                                  "v2_noskip"])
def test_one_f_one_b_matches_jax(world, name):
    want = world["jax"][f"1f1b_{name}"]
    for s, got in enumerate(world["port"]):
        got = got[f"1f1b_{name}"]
        assert len(got) == len(want)
        for j, (g, w) in enumerate(zip(got, want)):
            gl, wl = (jax.tree_util.tree_leaves(g),
                      jax.tree_util.tree_leaves(w))
            assert len(gl) == len(wl)
            for a, b in zip(gl, wl):
                _close(a, b[s], f"output {j} rank {s}")


@pytest.mark.parametrize("conv", ["outer", "inside"])
def test_tied_embedding_conventions_match_jax(world, conv):
    want = world["jax"]["tied"]
    for s, got in enumerate(world["port"]):
        got = got[f"tied_{conv}"]
        _close(got["loss"], want["loss"], f"loss rank {s}")
        _close(got["emb"], want["emb"], f"tied grad rank {s}")
        for k in ("w", "b"):
            _close(got[k], want[k][:, s], f"{k} rank {s}")


def test_p2p_shifts_match_jax_bitwise(world):
    for s, got in enumerate(world["port"]):
        for name in ("fwd", "bwd"):
            for g, w in zip(got[f"p2p_{name}"], world["jax"]["p2p"][name]):
                np.testing.assert_array_equal(g, w[s])
        # the chained pair is one shift
        np.testing.assert_array_equal(got["p2p_chained"],
                                      got["p2p_fwd"][0])


def test_parallel_state_and_schedule_selection(world):
    n = world["n"]
    for s, got in enumerate(world["port"]):
        st = got["state"]
        assert st["sizes"] == [n, s]
        assert st["embed"] == (s in (0, n - 1))
        assert st["func"] == \
            "forward_backward_pipelining_without_interleaving"
        assert st["vfunc"] == "forward_backward_pipelining_with_interleaving"
        assert st["virtual"] == [2, 1]
        first, last = s == 0, s == n - 1
        assert st["flags"] == [[first, False, first, last],
                               [False, last, first, last]]


@pytest.mark.parametrize("case", ["v2_few_mb", "boundary", "1f1b_mod",
                                  "1f1b_aux", "skip_ring", "skip_idle_ring",
                                  "no_skip_ring"])
def test_errors_match_jax(world, case):
    want = world["jax"]["errors"][case]
    for got in world["port"]:
        assert got["errors"][case] == want


def test_virtual_pipeline_needs_pp(world):
    for got in world["port"]:
        assert got["errors"]["virtual_pp1"] == (
            "ValueError: virtual pipeline requires pp > 1")


# ---- single process ---------------------------------------------------------


@pytest.mark.parametrize("args", [(None, 64, 2, 4), (None, 96, 3, 2),
                                  ((16, 8, 200), 64, 2, 2),
                                  ((8, 8, 0), 32, 1, 2)])
def test_microbatch_calculators_match_jax(args):
    want = jmb.build_num_microbatches_calculator(*args)
    got = microbatches.build_num_microbatches_calculator(*args)
    assert type(got).__name__ == type(want).__name__
    for consumed in (0, 30, 100, 250):
        want.update(consumed)
        got.update(consumed)
        assert got.get() == want.get()
        assert (got.get_current_global_batch_size()
                == want.get_current_global_batch_size())


@pytest.mark.parametrize("args", [(None, 65, 2, 4), ((16, 7, 200), 64, 2, 2),
                                  ((10, 8, 200), 64, 4, 2)])
def test_microbatch_calculator_errors_match_jax(args):
    with pytest.raises(ValueError) as want:
        jmb.build_num_microbatches_calculator(*args)
    with pytest.raises(ValueError) as got:
        microbatches.build_num_microbatches_calculator(*args)
    assert str(got.value) == str(want.value)


def test_no_pipelining_matches_jax():
    rng = np.random.default_rng(5)
    w = {"w": rng.standard_normal((D, D)).astype(np.float32) * 0.5,
         "b": rng.standard_normal(D).astype(np.float32) * 0.1}
    mbs = rng.standard_normal((4, 3, D)).astype(np.float32)

    def jloss(p, mb):
        return jnp.mean(_stage(p, mb) ** 2)

    wl, wg = js.forward_backward_no_pipelining(
        jloss, jax.tree_util.tree_map(jnp.asarray, w), jnp.asarray(mbs))
    gl, gg = schedules.forward_backward_no_pipelining(
        lambda p, mb: (torch_dist_ranks._stage(p, mb) ** 2).mean(),
        {k: torch.from_numpy(v) for k, v in w.items()},
        torch.from_numpy(mbs))
    _close(gl, wl, "loss")
    for k in w:
        _close(gg[k], wg[k], k)
    assert schedules.get_forward_backward_func().__name__ == \
        "forward_backward_no_pipelining"


def test_enums_and_logging_knob():
    for name in ("ModelType", "AttnType", "AttnMaskType"):
        assert ({m.name: m.value for m in getattr(enums, name)}
                == {m.name: m.value for m in getattr(jenums, name)})
    log_util.set_logging_level("debug")
    assert log_util.get_transformer_logger().level == 10
    log_util.set_logging_level(30)
    assert log_util.get_transformer_logger("x").parent.level == 30
