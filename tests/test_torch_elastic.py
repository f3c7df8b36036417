"""The port's `resilience.reshard` and `resilience.elastic` against the
JAX package, on the CPU.

- `reshard_state` on tests/test_elastic.py's ``_synth_state`` (fp32,
  bf16 as a tensor made from its 2-byte view, fp16, int8 and fp16
  scales) between its ``PLAN_A`` and ``PLAN_B`` (the JAX planner's
  plans, through JSON): every output leaf byte-equal to JAX's output,
  the report equal, A -> B -> A bit-exact; the ZeRO flat-shard repack
  equal to JAX's; each `LayoutMismatch` (tests/test_elastic.py:134-196);
- `reshard_checkpoint` of the same `llama_3d` state in both packages:
  the output manifest's ``tree`` (paths, shapes, dtypes, digests) equal,
  the reports equal, the A -> B -> A round trip restoring the source
  digests; a bit flip in the output refused at restore; the plan-less
  and layout-change refusals;
- `elastic_resume` at the banked device count: a plain resume with the
  JAX package's ``elastic.detect`` / ``elastic.resume`` events; at
  another count a re-plan by the port's planner (the JAX plan's "v5e"
  is no row of the port's table: priced at the detected card, h100
  here) and a reshard; `drill` runs (its acceptance run:
  tests/test_torch_elastic_replan.py);
- `shrink_schedule` equal to JAX's;
- the ZeRO repack at gloo (`parallel.launch`, bodies in
  tests/torch_dist_ranks.py): `distributed_fused_adam` saved at world 4
  (fsdp 4), resharded by zero plans dp 4 -> dp 2, restored at world 2
  onto the mesh, one step: params within 1e-6 of continuing at world 4;
- `llama_3d`'s cross-topology resume at gloo world 4 (the counterpart
  of tests/test_llama_3d.py:105-140): one O0 step on (pp 2, tp 2,
  num_chunks 2) from the JAX package's weights, `gather_state`
  committed with its plan, resharded onto (pp 4, tp 1, num_chunks 1)
  and restored there (`local_state`): the resumed step's loss within
  2e-5 relative of continuing on the first layout, whose first loss
  holds against the JAX flat Llama's (1e-5).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex1_tpu.resilience import checkpointer as jax_ckptr
from apex1_tpu.resilience import reshard as jax_reshard
from apex1_tpu.testing import chaos as jax_chaos
from apex1_tpu_torch.core.pytree import keystr, tree_flatten_with_path
from apex1_tpu_torch.optim.fused_adam import FusedAdamState
from apex1_tpu_torch.parallel import launch
from apex1_tpu_torch.resilience import (IntegrityError, LayoutMismatch,
                                        ResilientCheckpointer,
                                        elastic_resume, read_manifest,
                                        read_plan, reshard_checkpoint,
                                        reshard_state)
from apex1_tpu_torch.resilience import elastic
from apex1_tpu_torch.testing import chaos

import test_elastic as J
import torch_dist_ranks

PLAN_A = json.loads(json.dumps(J.PLAN_A))
PLAN_B = json.loads(json.dumps(J.PLAN_B))


def _tensor(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def _to_port(tree):
    """A JAX-side host tree as the port's: tensors, FusedAdamState the
    port's dataclass."""
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return FusedAdamState(**{f: _to_port(getattr(tree, f))
                                 for f in tree._fields})
    return _tensor(tree)


def _raw(x):
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().tobytes()
    return np.asarray(x).tobytes()


def _flat(tree):
    return [(keystr(p), x) for p, x in tree_flatten_with_path(tree)]


class TestReshardState:
    def test_restack_equals_jax_and_round_trips(self):
        src = J._synth_state((2, 2, 1))
        port = _to_port(src)
        mid, rep = reshard_state(port, PLAN_A, PLAN_B)
        jmid, jrep = jax_reshard.reshard_state(src, J.PLAN_A, J.PLAN_B)
        assert rep == jrep and rep["n_restacked"] == 5
        jleaves = [(jax.tree_util.keystr(p), x) for p, x in
                   jax.tree_util.tree_flatten_with_path(jmid)[0]]
        assert [p for p, _ in _flat(mid)] == [p for p, _ in jleaves]
        for (p, x), (_, y) in zip(_flat(mid), jleaves):
            assert tuple(x.shape) == np.shape(y) and _raw(x) == _raw(y), p
            assert isinstance(x, torch.Tensor)
        back, _ = reshard_state(mid, PLAN_B, PLAN_A)
        for (p, x), (_, y) in zip(_flat(back), _flat(port)):
            assert x.dtype == y.dtype and _raw(x) == _raw(y), p

    def test_numpy_leaves_stay_numpy(self):
        src = J._synth_state((2, 2, 1))
        out, _ = reshard_state(src, PLAN_A, PLAN_B)
        jout, _ = jax_reshard.reshard_state(src, J.PLAN_A, J.PLAN_B)
        for x, y in zip(jax.tree_util.tree_leaves(out),
                        jax.tree_util.tree_leaves(jout)):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()

    def _zero_plans(self, tag, dp_a=3, dp_b=2, zero_b=True):
        gb6 = J._shape_with(name=tag, global_batch=6)
        pa = J.planner.plan_for_layout(
            gb6, J.planner.Layout(dp=dp_a, num_microbatches=6 // dp_a,
                                  zero=True))
        pb = J.planner.plan_for_layout(
            gb6, J.planner.Layout(dp=dp_b, num_microbatches=6 // dp_b,
                                  zero=zero_b))
        return json.loads(json.dumps(pa)), json.loads(json.dumps(pb))

    def test_zero_shard_repack_equals_jax(self):
        pa, pb = self._zero_plans("tiny-z")
        params = {"w": np.arange(34.0, dtype=np.float32).reshape(17, 2)}
        shard = np.concatenate([np.arange(36.0, dtype=np.float32)[:34],
                                np.zeros(2, np.float32)])
        state = {"params": params,
                 "opt": {"exp_avg_shard": shard,
                         "exp_avg_sq_shard": shard * 2.0}}
        out, rep = reshard_state(_to_port(state), pa, pb)
        jout, jrep = jax_reshard.reshard_state(state, pa, pb)
        assert rep == jrep and rep["n_repacked"] == 2
        for f in ("exp_avg_shard", "exp_avg_sq_shard"):
            assert out["opt"][f].shape == (34,)
            np.testing.assert_array_equal(out["opt"][f].numpy(),
                                          jout["opt"][f])
        back, _ = reshard_state(out, pb, pa)
        np.testing.assert_array_equal(back["opt"]["exp_avg_sq_shard"],
                                      shard * 2.0)

    def test_nonzero_source_tail_refused(self):
        pa, pb = self._zero_plans("tiny-z4")
        state = {"params": {"w": torch.ones(17, 2)},
                 "opt": {"exp_avg_shard": torch.arange(36.0)}}
        with pytest.raises(LayoutMismatch, match="conservation"):
            reshard_state(state, pa, pb)

    def test_zero_flip_is_structure_change_refused(self):
        pa, pb = self._zero_plans("tiny-z2", zero_b=False)
        with pytest.raises(LayoutMismatch, match="zero"):
            reshard_state({"params": {"w": torch.zeros(4)}}, pa, pb)

    def test_model_change_refused(self):
        other = json.loads(json.dumps(J.planner.plan_for_layout(
            J._shape_with(num_layers=8),
            J.planner.Layout(dp=2, pp=2, tp=1, num_microbatches=4))))
        with pytest.raises(LayoutMismatch, match="never the model"):
            reshard_state(_to_port(J._synth_state()), PLAN_A, other)

    def test_leaf_disagreeing_with_plan_stack_refused(self):
        state = _to_port(J._synth_state((1, 2, 2)))
        with pytest.raises(LayoutMismatch, match="own plan meta"):
            reshard_state(state, PLAN_A, PLAN_B)

    def test_plan_spec_equals_the_planners(self):
        from apex1_tpu.planner.emit import PLAN_SCHEMA, plan_spec
        from apex1_tpu_torch.resilience import reshard
        assert reshard.PLAN_SCHEMA == PLAN_SCHEMA
        for plan in (PLAN_A, PLAN_B):
            assert reshard.plan_spec(plan) == plan_spec(plan)
            assert reshard.mesh_str(plan) == jax_reshard.mesh_str(plan)


class TestReshardCheckpoint:
    def _both(self, tmp_path, plan=PLAN_A):
        jstate = jax.tree_util.tree_map(np.asarray, J._l3d_state(J.PLAN_A))
        pstate = _to_port(jstate)
        with jax_ckptr.ResilientCheckpointer(tmp_path / "j",
                                             plan=J.PLAN_A) as ck:
            jsrc = ck.save_sync(3, jstate, meta={"data_step": 4})
        with ResilientCheckpointer(tmp_path / "p", plan=plan) as ck:
            psrc = ck.save_sync(3, pstate, meta={"data_step": 4})
        return jstate, pstate, jsrc, psrc

    def test_reshard_equals_jax_and_round_trips(self, tmp_path):
        jstate, pstate, jsrc, psrc = self._both(tmp_path)
        assert read_manifest(psrc).tree == read_manifest(jsrc).tree
        out, m1, r1 = reshard_checkpoint(psrc, pstate, PLAN_B,
                                         tmp_path / "o1")
        _jo, jm, jr = jax_reshard.reshard_checkpoint(
            jsrc, J._l3d_state(J.PLAN_A), J.PLAN_B, tmp_path / "jo")
        assert m1.tree == jm.tree and r1 == jr
        assert r1["n_restacked"] > 0 and r1["conserved"]
        assert read_plan(out)["mesh"] == PLAN_B["mesh"]
        assert m1.meta["resharded_from"]["step"] == 3
        assert m1.meta["data_step"] == 4
        template_b = _to_port(jax.tree_util.tree_map(
            np.asarray, J._l3d_state(J.PLAN_B)))
        _o3, m3, _r3 = reshard_checkpoint(out, template_b, PLAN_A,
                                          tmp_path / "o3")
        assert m3.tree == read_manifest(psrc).tree

    def test_resharded_checkpoint_is_verified_not_trusted(self,
                                                          tmp_path):
        _j, pstate, _js, psrc = self._both(tmp_path)
        out, _m, _r = reshard_checkpoint(psrc, pstate, PLAN_B,
                                         tmp_path / "out")
        template_b = _to_port(jax.tree_util.tree_map(
            np.asarray, J._l3d_state(J.PLAN_B)))
        with ResilientCheckpointer(tmp_path / "ck2", plan=PLAN_B) as ck2:
            restored, man = ck2.restore(template=template_b, path=out)
            assert man.meta["data_step"] == 4
            assert restored["params"]["chunk"]["wq"].shape[:3] == (1, 2, 2)
            chaos.bitflip_checkpoint(out)
            with pytest.raises(IntegrityError):
                ck2.restore(template=template_b, path=out)

    def test_no_plan_meta_is_clear_layout_mismatch(self, tmp_path):
        _j, pstate, _js, _ps = self._both(tmp_path)
        with ResilientCheckpointer(tmp_path / "np") as ck:
            src = ck.save_sync(1, pstate)
        with pytest.raises(LayoutMismatch, match="no plan meta"):
            reshard_checkpoint(src, pstate, PLAN_B, tmp_path / "out")
        with pytest.raises(LayoutMismatch, match="no plan meta"):
            elastic_resume(tmp_path / "np", n_devices=4,
                           make_template=lambda p: pstate)
        with ResilientCheckpointer(tmp_path / "np", plan=PLAN_A) as ck2:
            with pytest.raises(LayoutMismatch, match="no plan meta"):
                ck2.restore(template=pstate)

    def test_layout_change_restore_points_at_elastic_resume(self,
                                                            tmp_path):
        _j, pstate, _js, _ps = self._both(tmp_path)
        with ResilientCheckpointer(tmp_path / "p", plan=PLAN_B) as ck2:
            with pytest.raises(LayoutMismatch, match="elastic_resume"):
                ck2.restore(template=pstate)


def _events(d):
    out = []
    for n in sorted(os.listdir(d)):
        with open(os.path.join(d, n)) as f:
            out += [json.loads(line) for line in f]
    return [{k: v for k, v in e.items() if k not in ("t", "ckpt", "path")}
            for e in out if e.get("kind") == "event"]


class TestElasticResume:
    def test_same_device_count_is_plain_resume_like_jax(self, tmp_path,
                                                        monkeypatch):
        from apex1_tpu.resilience import elastic as jax_elastic
        jstate, pstate, _js, psrc = TestReshardCheckpoint()._both(tmp_path)
        for name, fn, d in (("port", elastic_resume, tmp_path / "p"),
                            ("jax", jax_elastic.elastic_resume,
                             tmp_path / "j")):
            monkeypatch.setenv("APEX1_OBS_DIR", str(tmp_path / f"obs_{name}"))
            dec = fn(d, n_devices=PLAN_A["n_devices"],
                     make_template=lambda p: pstate)
            assert not dec.resharded and dec.path == dec.source
            assert dec.plan["mesh"] == PLAN_A["mesh"]
            assert (dec.step, dec.data_step) == (3, 4)
        monkeypatch.delenv("APEX1_OBS_DIR")
        got, want = (_events(tmp_path / "obs_port"),
                     _events(tmp_path / "obs_jax"))
        assert [e["name"] for e in got] == ["elastic.detect",
                                            "elastic.resume"]
        assert got == want

    def test_other_device_count_names_the_planner_item(self, tmp_path,
                                                        monkeypatch):
        """Another device count re-plans with the planner (the item this
        test once named) and reshards; the drill runs."""
        _j, pstate, _js, psrc = TestReshardCheckpoint()._both(tmp_path)
        monkeypatch.setenv("APEX1_OBS_DIR", str(tmp_path / "obs"))
        dec = elastic_resume(tmp_path / "p", n_devices=2,
                             make_template=lambda p: pstate)
        monkeypatch.delenv("APEX1_OBS_DIR")
        assert dec.resharded and dec.source == psrc
        assert dec.plan["n_devices"] == 2 and dec.plan["generation"] == \
            "h100"
        assert dec.report["conserved"] and dec.report["n_restacked"] > 0
        assert read_plan(dec.path) == dec.plan
        events = _events(tmp_path / "obs")
        assert [e["name"] for e in events] == list(elastic.EPISODE_EVENTS)
        assert "'v5e'" in events[1]["generation_source"]
        # the drill runs (refusing only a multi-rank leg on a card)
        with pytest.raises(ValueError, match="gloo ranks of the CPU"):
            elastic.drill(8, 4, device="cuda")


def test_shrink_schedule_equals_jax():
    for seed in (0, 11, 12345):
        for n, lo, hi in ((8, 2, 6), (6, 0, 10), (4, 3, 4)):
            assert chaos.shrink_schedule(seed, n_devices=n, lo=lo, hi=hi) \
                == jax_chaos.shrink_schedule(seed, n_devices=n, lo=lo,
                                             hi=hi)
    with pytest.raises(ValueError, match="proper divisor"):
        chaos.shrink_schedule(1, n_devices=1, lo=0, hi=2)
    with pytest.raises(ValueError, match="hi > lo"):
        chaos.shrink_schedule(1, n_devices=4, lo=2, hi=2)


# ---------------------------------------------------------------------------
# gloo: the ZeRO repack and llama_3d's cross-topology resume


L3_KW = dict(num_layers=4, max_seq_len=32, vocab_size=64, num_heads=4,
             num_kv_heads=2, hidden_size=32, ffn_size=64)
L3_SHAPE = J.planner.ModelShape(
    name="tiny-l3d", num_layers=4, hidden_size=32, ffn_size=64,
    num_heads=4, num_kv_heads=2, head_dim=8, vocab_size=64, seq_len=32,
    global_batch=8)
LAY_A = dict(pp=2, tp=2, num_chunks=2, num_microbatches=4,
             microbatch_size=2)
LAY_B = dict(pp=4, tp=1, num_chunks=1, num_microbatches=4,
             microbatch_size=2)


def _plan(shape, **lay):
    return json.loads(json.dumps(J.planner.plan_for_layout(
        shape, J.planner.Layout(**lay))))


def _zero_inputs():
    rng = np.random.default_rng(4)
    return dict(w=rng.normal(size=(5, 3)).astype(np.float32),
                b=rng.normal(size=(2,)).astype(np.float32),
                gw=rng.normal(size=(3, 5, 3)).astype(np.float32),
                gb=rng.normal(size=(3, 2)).astype(np.float32))


def _llama_inputs():
    from apex1_tpu.core.policy import get_policy as jax_get_policy
    from apex1_tpu.models.llama import Llama as JaxLlama
    from apex1_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from apex1_tpu_torch import LlamaConfig, get_policy
    from apex1_tpu_torch.interop import named_from_flax
    from apex1_tpu_torch.models import llama_3d as L3
    rng = np.random.default_rng(11)
    tok = rng.integers(0, 64, (4, 32, 2)).astype(np.int32)
    lbl = rng.integers(0, 64, (4, 32, 2)).astype(np.int32)
    flat = JaxLlama(JaxLlamaConfig.tiny(policy=jax_get_policy("O0"),
                                        **L3_KW)).init(
        jax.random.key(0), jnp.asarray(tok[0].T))["params"]
    named = {k: torch.from_numpy(np.array(v)) for k, v in named_from_flax(
        jax.tree_util.tree_map(np.asarray, flat)).items()}
    cfg_a = L3.Llama3DConfig(model=LlamaConfig.tiny(
        policy=get_policy("O0"), **L3_KW), **LAY_A)
    chunk, shared = L3.from_llama_params(named, cfg_a)
    start_a = {"chunk": {k: v.numpy() for k, v in chunk.items()},
               "shared": {k: v.numpy() for k, v in shared.items()}}
    return flat, dict(start_a=start_a, tokens=tok, labels=lbl)


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """The two world-4 launches side by side (the ZeRO save, the
    llama_3d resume), then the ZeRO resume at world 2 on the resharded
    checkpoint."""
    from concurrent.futures import ThreadPoolExecutor
    from apex1_tpu_torch.parallel import distributed_optimizer as do
    d = tmp_path_factory.mktemp("elastic_gloo")
    zin = _zero_inputs()
    flat, lin = _llama_inputs()
    p4 = _plan(L3_SHAPE, dp=4, num_microbatches=2, zero=True)
    p2 = _plan(L3_SHAPE, dp=2, num_microbatches=4, zero=True)
    plans = {"a": _plan(L3_SHAPE, dp=1, **LAY_A),
             "b": _plan(L3_SHAPE, dp=1, **LAY_B)}
    with ThreadPoolExecutor(2) as ex:
        zf = ex.submit(launch, torch_dist_ranks.zero_reshard_save, 4, zin,
                       str(d / "src"), p4, backend="gloo", timeout=120)
        lf = ex.submit(launch, torch_dist_ranks.llama_3d_resume, 4, lin,
                       str(d / "l3d"), LAY_A, LAY_B, L3_KW, plans,
                       backend="gloo", timeout=240)
        cont = zf.result()
        n = 17
        template = {"params": {"w": torch.zeros(5, 3),
                               "b": torch.zeros(2)},
                    "opt": do.DistributedAdamState(
                        step=torch.zeros((), dtype=torch.int32),
                        exp_avg_shard=torch.zeros(
                            do.shard_padded_len(n, 4)),
                        exp_avg_sq_shard=torch.zeros(
                            do.shard_padded_len(n, 4)))}
        out, _man, rep = reshard_checkpoint(
            os.path.join(d, "src", "step_00000002"), template, p2,
            d / "dst")
        res = launch(torch_dist_ranks.zero_reshard_resume, 2, zin, out, p2,
                     backend="gloo", timeout=120)
        return dict(zero=dict(cont=cont, report=rep, res=res),
                    llama=lf.result(), flat=flat, llama_inputs=lin)


def test_zero_repack_resume_at_half_the_world(gloo):
    z = gloo["zero"]
    assert z["report"]["n_repacked"] == 2 and z["report"]["conserved"]
    for got in z["res"]:
        assert (got["step"], got["data_step"], got["plan_dp"],
                got["shard_len"]) == (3, 2, 2, 9)
        for k in ("w", "b"):
            np.testing.assert_allclose(got["params"][k],
                                       z["cont"][0]["params"][k],
                                       rtol=1e-6, atol=1e-6)


def _jax_flat_loss(flat, tok, lbl):
    """The JAX flat Llama's O0 loss: the mean CE over the microbatches
    (tokens (M, S, mb))."""
    from apex1_tpu.core.policy import get_policy as jax_get_policy
    from apex1_tpu.models.llama import Llama as JaxLlama
    from apex1_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from apex1_tpu.ops import softmax_cross_entropy_loss
    model = JaxLlama(JaxLlamaConfig.tiny(policy=jax_get_policy("O0"),
                                         **L3_KW))
    ces = [softmax_cross_entropy_loss(
        model.apply({"params": flat}, jnp.asarray(t.T)).astype(
            jnp.float32), jnp.asarray(lab.T)) for t, lab in zip(tok, lbl)]
    return float(jnp.mean(jnp.stack(ces)))


def test_llama_3d_cross_topology_resume(gloo):
    lin = gloo["llama_inputs"]
    want1 = _jax_flat_loss(gloo["flat"], lin["tokens"], lin["labels"])
    res = gloo["llama"]
    report = res[0]["report"]
    assert report["n_restacked"] == 3 * 9 and report["conserved"]
    assert report["stack_from"] == [2, 2, 1] and \
        report["stack_to"] == [1, 4, 1]
    for got in res:
        np.testing.assert_allclose(got["loss1"], want1, rtol=1e-5)
        np.testing.assert_allclose(got["loss_res"], got["loss_cont"],
                                   rtol=2e-5)
        assert got["step"] == 2 and got["data_step"] == 1
        assert got["same_back"]
        assert got["global_shapes"]["wq"][:3] == [2, 2, 1]
