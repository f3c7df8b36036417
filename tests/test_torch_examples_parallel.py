"""The port's parallel examples and its planner's layout rules against
the JAX package on the CPU.

- `examples.gpt2_pp_tied` (its defaults: 4 layers, hidden 64, vocab 256,
  4 microbatches of 2 x 64) at pp 1 in-process, and at pp 2 and 4 over
  gloo ranks (bodies in tests/torch_dist_ranks.py), against the JAX
  script's ``shard_map`` step on 1, 2 and 4 of the 8 virtual devices,
  3 steps: the losses within 1e-5, the tied table and every stage's
  blocks within 1e-5 but for at most 1 % within half the learning rate
  (`_close_adam`);
- `examples.llama_distributed` at O0 for ``--tp 2`` and ``--tp 2
  --fsdp 2`` against the JAX script's GSPMD step on the same mesh
  shapes, from JAX's params, 3 steps: the losses within 1e-5, every
  param's elements within 1e-5 but for at most 1 % within half the
  learning rate (Adam's steps on gradients that are rounding noise);
- `examples.llama_3d` at one rank: its O2 trajectory (5 steps) within
  2e-2 of JAX's `models.llama_3d` step on the script's batches; its
  SIGTERM drill (exit 75, then ``--resume auto`` giving the
  uninterrupted run's losses bit for bit); ``--tp 3`` exits 2 with
  ``ILLEGAL LAYOUT`` naming tp-heads; ``--plan auto`` plans one rank's
  layout and trains on it (its rules checked against the model's); a
  changed device count under ``--elastic`` re-plans and reshards;
- `planner.check_layout` returns JAX's violations rule for rule (and
  message for message) over `enumerate_layouts`' cases of every banked
  shape and a list of illegal layouts; `enumerate_layouts` yields JAX's
  layouts;
- none of the new modules imports ``jax`` or ``apex1_tpu``.
"""

import dataclasses
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as Ps

from apex1_tpu import planner as jplanner
from apex1_tpu.amp import Amp as JaxAmp
from apex1_tpu.core.mesh import make_mesh as jax_make_mesh
from apex1_tpu.core.policy import get_policy as jax_get_policy
from apex1_tpu.models import llama_3d as J3
from apex1_tpu.models.llama import Llama as JaxLlama
from apex1_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from apex1_tpu.models.llama import llama_loss_fn as jax_llama_loss_fn
from apex1_tpu.models.llama import param_specs as jax_param_specs
from apex1_tpu.ops import _common as jax_common
from apex1_tpu.ops import (layer_norm, scaled_upper_triang_masked_softmax,
                           softmax_cross_entropy_loss)
from apex1_tpu.optim.fused_adam import FusedAdamState, fused_adam
from apex1_tpu.parallel import fsdp_param_specs, shard_opt_state_specs
from apex1_tpu.transformer.pipeline_parallel import schedules
from apex1_tpu_torch import planner
from apex1_tpu_torch.examples import gpt2_pp_tied, llama_3d
from apex1_tpu_torch.parallel import launch

import torch_dist_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, SEQ = 3, 32
L, E, H, V, MB, M, S = 4, 64, 4, 256, 2, 4, 64


def _jax_pp_tied(P_: int) -> dict:
    """The JAX script's train step (examples/gpt2_pp_tied.py:62-141) on
    a pp mesh of the first ``P_`` devices, its defaults, ``STEPS``
    steps: the losses, the tied table and the stacked blocks."""
    lps, D = L // P_, E // H
    mesh = jax_make_mesh(pp=P_, devices=jax.devices()[:P_])
    rng = np.random.default_rng(0)

    def w(*shape, scale=0.02):
        return jnp.asarray(rng.normal(size=shape) * scale, jnp.float32)

    chunk = {
        "ln1_g": jnp.ones((1, P_, lps, E)), "ln1_b": jnp.zeros((1, P_, lps, E)),
        "wqkv": w(1, P_, lps, E, 3 * E), "wo": w(1, P_, lps, E, E),
        "ln2_g": jnp.ones((1, P_, lps, E)), "ln2_b": jnp.zeros((1, P_, lps, E)),
        "w1": w(1, P_, lps, E, 4 * E), "w2": w(1, P_, lps, 4 * E, E),
    }
    tied = {"wte": w(V, E), "wpe": w(S, E, scale=0.01)}

    def block(x, p):
        h = layer_norm(x, p["ln1_g"], p["ln1_b"])
        qkv = (h @ p["wqkv"]).reshape(MB, S, 3, H, D)
        q, k, v = (qkv[:, :, i].transpose(0, 2, 1, 3) for i in range(3))
        s_ = jnp.einsum("bhqd,bhkd->bhqk", q, k)
        a = scaled_upper_triang_masked_softmax(s_, scale=1.0 / np.sqrt(D))
        o = jnp.einsum("bhqk,bhkd->bhqd", a, v)
        x = x + o.transpose(0, 2, 1, 3).reshape(MB, S, E) @ p["wo"]
        h = layer_norm(x, p["ln2_g"], p["ln2_b"])
        return x + jax.nn.gelu(h @ p["w1"]) @ p["w2"]

    def stage_fn(p_stage, x):
        for j in range(lps):
            x = block(x, jax.tree.map(lambda a, j=j: a[j], p_stage))
        return x

    def embed_fn(tied, tokens):
        return tied["wte"][tokens] + tied["wpe"][None]

    def make_head_fn(labels):
        def head_fn(tied, outs):
            logits = jnp.einsum("mbse,ve->mbsv", outs, tied["wte"])
            ce = softmax_cross_entropy_loss(
                logits[:, :, :-1].reshape(M * MB, S - 1, V),
                labels.reshape(M * MB, S)[:, 1:])
            return jnp.mean(ce.reshape(M, -1), axis=1)
        return head_fn

    tx = fused_adam(1e-3)
    params = {"chunk": chunk, "tied": tied}
    state = {"params": params, "opt": tx.init(params)}
    cspecs = jax.tree.map(lambda _: Ps(None, "pp"), chunk)
    pspecs = {"chunk": cspecs, "tied": {"wte": Ps(), "wpe": Ps()}}
    sspecs = {"params": pspecs, "opt": FusedAdamState(
        step=Ps(), exp_avg=pspecs, exp_avg_sq=pspecs)}

    def train_step(state, tokens):
        def scalar(params):
            local = jax.tree.map(lambda p: p[:, 0], params["chunk"])
            per_mb = schedules.pipeline_tied_apply(
                stage_fn, local, embed_fn, make_head_fn(tokens),
                params["tied"], tokens, broadcast_outputs=False)
            return jnp.mean(per_mb)

        loss_part, grads = jax.value_and_grad(scalar)(state["params"])
        loss = jax.lax.psum(loss_part, "pp")
        grads["tied"] = schedules.allreduce_embedding_grads(grads["tied"])
        updates, new_opt = tx.update(grads, state["opt"], state["params"])
        return {"params": optax.apply_updates(state["params"], updates),
                "opt": new_opt}, loss

    tokens = jnp.asarray(rng.integers(0, V, (M, MB, S)), jnp.int32)
    step = jax.jit(jax.shard_map(train_step, mesh=mesh,
                                 in_specs=(sspecs, Ps()),
                                 out_specs=(sspecs, Ps()), check_vma=False))
    losses = []
    with jax_common.force_impl("xla"):
        for _ in range(STEPS):
            state, loss = step(state, tokens)
            losses.append(float(loss))
    return dict(losses=losses,
                params=jax.tree_util.tree_map(np.asarray, state["params"]))


def _jax_llama_distributed(params, dp: int, fsdp: int, tp: int) -> dict:
    """The JAX script's GSPMD loop (examples/llama_distributed.py:49-98)
    at O0 on the first dp·fsdp·tp devices, ``STEPS`` steps."""
    mesh = jax_make_mesh(dp=dp, fsdp=fsdp, tp=tp,
                         devices=jax.devices()[:dp * fsdp * tp])
    cfg = JaxLlamaConfig.tiny(policy=jax_get_policy("O0"), max_seq_len=SEQ)
    model = JaxLlama(cfg)
    rng = np.random.default_rng(0)
    rng.integers(0, cfg.vocab_size, (4, SEQ))
    amp = JaxAmp(tx=fused_adam(3e-4, weight_decay=0.1), opt_level="O0",
                 max_grad_norm=1.0)
    state = amp.init(params)
    tp_specs = jax_param_specs(state.params)
    if fsdp > 1:
        zero = fsdp_param_specs(state.params, divisor=fsdp)
        tp_specs = jax.tree_util.tree_map(
            lambda t, z: z if t == Ps() else t, tp_specs, zero,
            is_leaf=lambda v: isinstance(v, Ps))
    opt_specs = shard_opt_state_specs(state.opt_state, param_specs=tp_specs)

    def put(tree, specs):
        return jax.device_put(tree, jax.tree_util.tree_map(
            lambda s: NamedSharding(mesh, s), specs,
            is_leaf=lambda v: isinstance(v, Ps)))

    state = dataclasses.replace(state, params=put(state.params, tp_specs),
                                opt_state=put(state.opt_state, opt_specs))
    batch_spec = NamedSharding(mesh, Ps(("dp", "fsdp")))
    losses = []
    with jax_common.force_impl("xla"):
        step = jax.jit(amp.make_train_step(jax_llama_loss_fn(model)))
        for _ in range(STEPS):
            batch = jax.device_put(jnp.asarray(
                rng.integers(0, cfg.vocab_size, (4, SEQ)), jnp.int32),
                batch_spec)
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
    return dict(losses=losses,
                params=jax.tree_util.tree_map(np.asarray, state.params))


def _flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _close_adam(got: dict, want: dict, lr: float):
    """Every leaf's elements within 1e-5, but for at most 1 % within
    lr / 2: Adam turns a gradient that is rounding noise into a step of
    up to about the learning rate."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        close = np.isclose(got[k], w, rtol=1e-5, atol=1e-5)
        assert close.mean() >= 0.99, (k, close.mean())
        np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=lr / 2,
                                   err_msg=k)


def _pp_params(port: dict, want: dict, stage: int, P_: int):
    """The port's ``chunk.*`` (this stage's (1, lps, ...)) and
    ``tied.*`` against JAX's stacked (1, P, lps, ...) blocks."""
    got = {k: np.asarray(v) for k, v in port.items()}
    ref = {**{f"chunk.{k}": v[:, stage] for k, v in want["chunk"].items()},
           **{f"tied.{k}": v for k, v in want["tied"].items()}}
    _close_adam(got, ref, 1e-3)


@pytest.fixture(scope="module")
def llama_params():
    cfg = JaxLlamaConfig.tiny(policy=jax_get_policy("O0"), max_seq_len=SEQ)
    tokens = jnp.asarray(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, SEQ)), jnp.int32)
    params = JaxLlama(cfg).init(jax.random.key(0), tokens)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, llama_params):
    n = request.param
    inputs = {"steps": STEPS, "seq": SEQ, "llama": llama_params}
    with ThreadPoolExecutor(1) as ex:
        port = ex.submit(launch, torch_dist_ranks.examples_cases, n, inputs,
                         n, backend="gloo")
        want = dict(pp=_jax_pp_tied(n), ld=_jax_llama_distributed(
            llama_params, 1, n // 2, 2))
        return n, port.result(), want


def test_gpt2_pp_tied_pp1_matches_jax():
    got = gpt2_pp_tied.main(["--pp", "1", "--device", "cpu", "--steps",
                             str(STEPS)])
    want = _jax_pp_tied(1)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    _pp_params({k: v.numpy() for k, v in got["params"].items()},
               want["params"], 0, 1)


def test_gpt2_pp_tied_ranks_match_jax(world):
    n, port, want = world
    for r, got in enumerate(port):
        assert got["pp"]["stage"] == r
        np.testing.assert_allclose(got["pp"]["losses"], want["pp"]["losses"],
                                   rtol=1e-5)
        _pp_params(got["pp"]["params"], want["pp"]["params"], r, n)


def test_llama_distributed_ranks_match_jax_gspmd(world):
    n, port, want = world
    ref = _flat(want["ld"]["params"])
    for got in port:
        np.testing.assert_allclose(got["ld"]["losses"], want["ld"]["losses"],
                                   rtol=1e-5)
        _close_adam(got["ld"]["params"], ref, 3e-4)


L3D = ["--dp", "1", "--pp", "1", "--tp", "1", "--device", "cpu"]
#: the uninterrupted 6-step run both llama_3d tests below read
L3D_FULL = L3D + ["--steps", "6", "--ckpt-every", "2"]


@pytest.fixture(scope="module")
def l3d_full():
    return llama_3d.main(L3D_FULL)


def test_llama_3d_o2_trajectory_matches_jax(l3d_full):
    steps = 5
    got = dict(l3d_full, losses=l3d_full["losses"][:steps])
    mcfg = JaxLlamaConfig.tiny(num_layers=4, max_seq_len=64, vocab_size=256,
                               num_heads=4, num_kv_heads=2, hidden_size=64,
                               ffn_size=128, policy=jax_get_policy("O2"))
    cfg = J3.Llama3DConfig(model=mcfg, num_microbatches=4,
                           microbatch_size=1, learning_rate=3e-3)
    mesh = jax_make_mesh(dp=1, pp=1, cp=1, ep=1, tp=1,
                         devices=jax.devices()[:1])
    want = []
    with jax_common.force_impl("xla"):
        step, state, _ = J3.make_train_step(cfg, mesh=mesh)
        for i in range(steps):
            # the JAX script's batch_at (examples/llama_3d.py:319-333)
            r = np.random.default_rng([0, i])
            canon = r.integers(0, 256, (4, 64))
            toks = jnp.asarray(canon.reshape(4, 1, 64).transpose(0, 2, 1),
                               jnp.int32)
            state, loss = step(state, toks, jnp.roll(toks, -1, axis=1))
            want.append(float(loss))
    np.testing.assert_allclose(got["losses"], want, rtol=2e-2)
    assert got["plan"]["mesh"] == {"dp": 1, "pp": 1, "cp": 1, "ep": 1,
                                   "tp": 1}


def test_llama_3d_sigterm_drill_resumes_bit_for_bit(tmp_path, monkeypatch,
                                                     capsys, l3d_full):
    full = l3d_full
    drill = L3D_FULL + ["--ckpt-dir", str(tmp_path / "ck")]
    monkeypatch.setenv("APEX1_CHAOS_SIGTERM_STEP", "3")
    with pytest.raises(SystemExit) as exit_:
        llama_3d.main(drill)
    assert exit_.value.code == 75
    monkeypatch.delenv("APEX1_CHAOS_SIGTERM_STEP")
    resumed = llama_3d.main(drill)
    assert resumed["start"] == 3
    assert resumed["losses"] == full["losses"][3:]
    # --elastic on the same device count resumes plainly from the
    # banked plan; another count re-plans and reshards (then this one
    # rank cannot run the two-device layout)
    more = llama_3d.main(drill[:-4] + ["--steps", "8", "--ckpt-every", "2",
                                       "--ckpt-dir", str(tmp_path / "ck"),
                                       "--elastic"])
    assert more["start"] == 6 and len(more["losses"]) == 2
    capsys.readouterr()
    with pytest.raises(SystemExit, match="spans 2 devices, but 1 ranks"):
        llama_3d.main(drill + ["--elastic", "--devices", "2"])
    assert "re-planned and resharded" in capsys.readouterr().out
    from apex1_tpu_torch.resilience import read_plan
    (moved,) = os.listdir(tmp_path / "ck" / "elastic")
    assert read_plan(tmp_path / "ck" / "elastic" / moved)["n_devices"] == 2


def test_llama_3d_illegal_layout_exits_2_naming_the_rule(capsys):
    with pytest.raises(SystemExit) as exit_:
        llama_3d.main(["--tp", "3", "--device", "cpu"])
    assert exit_.value.code == 2
    err = capsys.readouterr().err
    assert "ILLEGAL LAYOUT" in err and "[tp-heads]" in err


def test_llama_3d_plan_needs_the_planner(capsys):
    """--plan auto: the planner searches the world size's layouts, and
    the pick's partition rules are checked against the model's."""
    got = llama_3d.main(L3D + ["--plan", "auto", "--steps", "2"])
    assert got["plan_verified"] and len(got["losses"]) == 2
    assert np.isfinite(got["losses"]).all()
    assert got["plan"]["n_devices"] == 1 and got["plan"]["mesh"] == {
        "dp": 1, "pp": 1, "cp": 1, "ep": 1, "tp": 1}
    out = capsys.readouterr().out
    assert "plan: mesh dp=1 pp=1" in out and "plan verified" in out


ILLEGAL = [
    dict(tp=3), dict(pp=5), dict(dp=0), dict(tp=-1), dict(sp_mode="ring"),
    dict(pp=3), dict(pp=2, num_chunks=2, num_microbatches=1),
    dict(pp=1, num_chunks=2, schedule="1f1b"),
    dict(pp=2, num_chunks=2, num_microbatches=3, schedule="1f1b"),
    dict(ep=2), dict(zero=True), dict(dp=3), dict(cp=3),
    dict(num_microbatches=3), dict(tp=8, cp=8)]


def _rules(violations) -> list:
    return [(v.rule, v.message) for v in violations]


@pytest.mark.parametrize("name", list(planner.BANKED_SHAPES))
def test_check_layout_matches_jax_over_enumerated_and_illegal(name):
    shape = planner.BANKED_SHAPES[name]
    jshape = jplanner.BANKED_SHAPES[name]
    assert dataclasses.asdict(shape) == dataclasses.asdict(jshape)
    for n in (1, 2, 4, 8, 16):
        for kw in (dict(), dict(allow_cp=False), dict(allow_zero=False)):
            got = list(planner.enumerate_layouts(shape, n, **kw))
            want = list(jplanner.enumerate_layouts(jshape, n, **kw))
            assert ([dataclasses.asdict(x) for x in got]
                    == [dataclasses.asdict(x) for x in want])
            for lay in got:
                jlay = jplanner.Layout(**dataclasses.asdict(lay))
                for devices in (n, None, n * 2):
                    assert _rules(planner.check_layout(shape, lay, devices)) \
                        == _rules(jplanner.check_layout(jshape, jlay,
                                                        devices))
    base = dict(num_microbatches=shape.global_batch)
    for kw in ILLEGAL:
        lay = planner.Layout(**{**base, **kw})
        got = _rules(planner.check_layout(shape, lay, 4))
        assert got == _rules(jplanner.check_layout(
            jshape, jplanner.Layout(**{**base, **kw}), 4))
        assert got, kw


def test_check_layout_matches_jax_on_moe_and_example_shapes():
    moe = dict(name="moe", num_layers=8, hidden_size=64, ffn_size=128,
               num_heads=4, num_kv_heads=2, head_dim=16, vocab_size=256,
               seq_len=64, global_batch=8, num_experts=4)
    for dims in (moe, dict(moe, num_experts=0, name="dense"),
                 dict(moe, num_experts=3, name="odd")):
        shape, jshape = planner.ModelShape(**dims), \
            jplanner.ModelShape(**dims)
        for n in (1, 2, 4, 8):
            got = [dataclasses.asdict(x)
                   for x in planner.enumerate_layouts(shape, n)]
            assert got == [dataclasses.asdict(x) for x in
                           jplanner.enumerate_layouts(jshape, n)]
        for kw in ILLEGAL + [dict(ep=2, num_microbatches=4),
                             dict(ep=4, num_microbatches=2)]:
            kw = {"num_microbatches": 8, **kw}
            assert _rules(planner.check_layout(
                shape, planner.Layout(**kw))) == _rules(
                jplanner.check_layout(jshape, jplanner.Layout(**kw)))


NEW_MODULES = ["apex1_tpu_torch.planner", "apex1_tpu_torch.planner.layouts",
               "apex1_tpu_torch.models.near_tie",
               "apex1_tpu_torch.examples._common"] + [
    f"apex1_tpu_torch.{m}" for m in (
        "core.capability", "perf_model", "obs.calibrate", "planner.memory",
        "planner.cost", "planner.search", "planner.emit",
        "planner.__main__", "resilience.reshard",
        "resilience.elastic")] + [
    f"apex1_tpu_torch.examples.{m}" for m in (
        "llama_distributed", "gpt2_pp_tied", "llama_3d", "t5_seq2seq",
        "serving_llama", "dcgan_amp", "rnnt_speech")]


def test_new_modules_import_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {NEW_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'apex1_tpu'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
