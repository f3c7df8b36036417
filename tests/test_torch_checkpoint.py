"""The port's `checkpoint` and key paths against the JAX package, on the
CPU.

- `core.pytree` key paths equal ``jax.tree_util.keystr`` leaf for leaf,
  in JAX's order, for nested dicts, lists, tuples, namedtuples, the
  `AmpState` of the same params (a chex dataclass there: fields sorted)
  and a threefry key (one uint32 leaf);
- round trips bit for bit (tests/test_checkpoint.py:36-100): a tiny
  GPT-2's O2 `AmpState` after 2 steps (and the same next step from the
  restore), an fp16 `LossScaleState` after an overflow, a Llama's int8
  decode params, and a state with fp32, bf16, fp16, int8, int32 and bool
  leaves, a Python scalar and a key, whose manifest leaf entries equal
  the JAX package's ``tree_entries`` of the same arrays; a template of
  meta tensors; a template-free restore as nested dicts;
- `CheckpointManager` rotation and resume (tests/test_checkpoint.py:
  116-131);
- at gloo world 2 (`parallel.launch`, rank body in
  tests/torch_dist_ranks.py): an unsharded checkpoint restored onto the
  mesh with fsdp specs equals `core.mesh.place` of the full state
  (tests/test_checkpoint.py:102-114); a `distributed_fused_adam` state
  saved through `to_global` holds the padded global flat buffer, the
  ranks' slices in order; the sentinel's health flag agrees over the
  fsdp group (one MIN all-reduce);
- every typed `CheckpointError` of tests/test_resilience.py:97-136, and
  a short leaf file, a shape and a dtype that differ from the template.
"""

import collections
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex1_tpu.amp import Amp as JaxAmp
from apex1_tpu.optim.fused_adam import fused_adam as jax_fused_adam
from apex1_tpu.resilience import manifest as jax_manifest
from apex1_tpu_torch import Amp, GPT2Config, fused_adam, get_policy
from apex1_tpu_torch.checkpoint import (CheckpointError, CheckpointManager,
                                        restore_checkpoint, save_checkpoint)
from apex1_tpu_torch.core.pytree import keystr, tree_flatten_with_path
from apex1_tpu_torch.parallel import launch
from apex1_tpu_torch.resilience import manifest

import torch_dist_ranks


def _jax_paths(tree):
    return [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _paths(tree):
    return [keystr(p) for p, _ in tree_flatten_with_path(tree)]


def _leaves(tree):
    return [x for _, x in tree_flatten_with_path(tree)]


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x)
    return x


def _assert_same(a, b):
    assert _paths(a) == _paths(b)
    for x, y in zip(_leaves(a), _leaves(b)):
        assert type(x) is type(y)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(_bits(x), _bits(y))
        else:
            assert x == y


Point = collections.namedtuple("Point", ["y", "x"])


class TestKeyPaths:
    def test_containers(self):
        rng = np.random.default_rng(0)
        arr = lambda *s: rng.normal(size=s).astype(np.float32)
        tree = {"b": [arr(2), (arr(1), arr(3))], "a": {"z": arr(2),
                                                       "c": None},
                10: Point(y=arr(1), x={"k": arr(2)})}
        jtree = {"b": [arr(2), (arr(1), arr(3))], "a": {"z": arr(2),
                                                        "c": None},
                 10: Point(y=arr(1), x={"k": arr(2)})}
        # jax sorts mixed key types only when comparable: keep str keys
        tree.pop(10), jtree.pop(10)
        tree["p"], jtree["p"] = Point(y=arr(1), x={"k": arr(2)}), \
            Point(y=arr(1), x={"k": arr(2)})
        assert _paths(tree) == _jax_paths(jtree)
        assert _paths({1: 0.0, 3: 1.0, 2: 2.0}) == \
            _jax_paths({1: 0.0, 3: 1.0, 2: 2.0})

    def test_amp_state_sorted_like_chex(self):
        w = np.ones((3,), np.float32)
        state = Amp(fused_adam(1e-3), opt_level="O2_fp16").init(
            {"w": torch.from_numpy(w), "b.x": torch.zeros(2)})
        jstate = JaxAmp(jax_fused_adam(1e-3), opt_level="O2_fp16").init(
            {"w": jnp.asarray(w), "b.x": jnp.zeros(2)})
        assert _paths(state) == _jax_paths(jstate)

    def test_key_is_one_uint32_leaf(self):
        from apex1_tpu_torch.core.random import prng_key
        key = prng_key(42)
        tree = {"rng": key, "n": torch.tensor(1)}
        assert _paths(tree) == _jax_paths(
            {"rng": jax.random.key(42), "n": jnp.int32(1)})
        want = jax_manifest.tree_entries({"rng": jax.random.key(42)})
        assert manifest.tree_entries({"rng": key}) == want


def _gpt2_amp(level="O2", steps=2):
    from apex1_tpu_torch import gpt2_loss_fn, gpt2_params_from_jax
    from apex1_tpu_torch.models.gpt2 import init_params
    cfg = GPT2Config.tiny(num_layers=1, hidden_size=64, max_seq_len=16,
                          use_flash=False, policy=get_policy(level))
    model = gpt2_params_from_jax(init_params(cfg, 0), cfg, "cpu")
    amp = Amp(fused_adam(1e-3), opt_level=level)
    state = amp.init(dict(model.named_parameters()))
    step = amp.make_train_step(gpt2_loss_fn(model, fuse_head=False))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 16)))
    for _ in range(steps):
        state, _ = step(state, tokens)
    return state, step, tokens


class TestRoundTrip:
    def test_gpt2_o2_amp_state_and_next_step(self, tmp_path):
        state, step, tokens = _gpt2_amp()
        save_checkpoint(tmp_path / "ck", state)
        restored = restore_checkpoint(tmp_path / "ck", template=state)
        _assert_same(restored, state)
        s1, m1 = step(state, tokens)
        s2, m2 = step(restored, tokens)
        assert torch.equal(m1["loss"], m2["loss"])
        _assert_same(s1, s2)

    def test_loss_scale_state(self, tmp_path):
        amp = Amp(fused_adam(1e-2), opt_level="O1_fp16",
                  loss_scale="dynamic")
        state = amp.init({"w": torch.ones(8), "b": torch.zeros(4)})
        step = amp.make_train_step(
            lambda p, x: torch.sum(torch.square(p["w"])) * x
            + torch.sum(p["b"]))
        state, _ = step(state, torch.tensor(1e30))     # overflow
        state, _ = step(state, torch.tensor(1.0))
        save_checkpoint(tmp_path / "c2", state)
        restored = restore_checkpoint(tmp_path / "c2", template=state)
        assert float(restored.loss_scale.scale) == \
            float(state.loss_scale.scale)
        assert int(restored.loss_scale.overflow_count) == \
            int(state.loss_scale.overflow_count) >= 1
        _assert_same(restored, state)

    def test_int8_decode_params(self, tmp_path):
        from apex1_tpu_torch import LlamaConfig
        from apex1_tpu_torch.models.llama import Llama
        from apex1_tpu_torch.models.quant_decode import (
            quantize_llama_params)
        cfg = LlamaConfig.tiny(policy=get_policy("O2"), max_seq_len=32)
        model = Llama(cfg, device="cpu")
        g = torch.Generator().manual_seed(3)
        params = {k: torch.randn(v.shape, generator=g) * 0.02
                  for k, v in model.named_parameters()}
        q = quantize_llama_params(params, cfg)
        dtypes = {x.dtype for x in _leaves(q)}
        assert {torch.int8, torch.bfloat16, torch.float32} <= dtypes
        save_checkpoint(tmp_path / "q", q)
        _assert_same(restore_checkpoint(tmp_path / "q", template=q), q)

    def test_every_dtype_and_jax_digests(self, tmp_path):
        from apex1_tpu_torch.core.random import prng_key
        rng = np.random.default_rng(5)
        f32 = rng.normal(size=(3, 5)).astype(np.float32)
        bf = rng.normal(size=(4, 2)).astype(ml_dtypes.bfloat16)
        f16 = rng.normal(size=(7,)).astype(np.float16)
        i8 = rng.integers(-127, 127, (2, 3)).astype(np.int8)
        i32 = rng.integers(-9, 9, (5,)).astype(np.int32)
        b = rng.random((3,)) > 0.5
        state = {"f32": torch.from_numpy(f32),
                 "bf16": torch.from_numpy(bf.view(np.int16).copy()).view(
                     torch.bfloat16),
                 "f16": torch.from_numpy(f16), "i8": torch.from_numpy(i8),
                 "nested": [torch.from_numpy(i32), torch.from_numpy(b)],
                 "scalar": 7, "key": prng_key(9)}
        save_checkpoint(tmp_path / "m", state)
        restored = restore_checkpoint(tmp_path / "m", template=state)
        _assert_same(restored, state)
        jstate = {"f32": f32, "bf16": bf, "f16": f16, "i8": i8,
                  "nested": [i32, b], "scalar": 7,
                  "key": jax.random.key(9)}
        assert manifest.tree_entries(restored) == \
            jax_manifest.tree_entries(jstate)

    def test_meta_template_and_template_free(self, tmp_path):
        state, _, _ = _gpt2_amp(steps=1)
        save_checkpoint(tmp_path / "ck", state)
        meta = _to_meta(state)
        got = restore_checkpoint(tmp_path / "ck", template=meta,
                                 device="cpu")
        _assert_same(got, state)
        free = restore_checkpoint(tmp_path / "ck", device="cpu")
        assert set(free) == {"step", "params", "opt_state", "loss_scale"}
        assert torch.equal(free["params"]["h.0.ln1_scale"],
                           state.params["h.0.ln1_scale"])
        assert torch.equal(free["opt_state"]["exp_avg"]["wte"],
                           state.opt_state.exp_avg["wte"])


def _to_meta(tree):
    from apex1_tpu_torch.core.pytree import tree_map_with_path
    return tree_map_with_path(
        lambda p, x: torch.empty(x.shape, dtype=x.dtype, device="meta")
        if isinstance(x, torch.Tensor) else x, tree)


def test_manager_rotation_and_resume(tmp_path):
    amp = Amp(fused_adam(1e-2), opt_level="O0")
    state = amp.init({"w": torch.ones(8)})
    step = amp.make_train_step(lambda p, x: torch.sum(p["w"] ** 2) * x)
    with CheckpointManager(tmp_path / "mgr", max_to_keep=2) as mgr:
        for i in range(4):
            state, _ = step(state, torch.tensor(1.0))
            assert mgr.save(i, state, force=True)
        mgr.wait_until_finished()
        assert mgr.latest() == 3
        restored = mgr.restore(_to_meta(state), device="cpu")
        assert torch.equal(restored.params["w"], state.params["w"])
        kept = {n for n in os.listdir(tmp_path / "mgr") if n.isdigit()}
        assert kept == {"2", "3"}
    with CheckpointManager(tmp_path / "iv", save_interval_steps=2) as mgr:
        assert [mgr.save(i, state) for i in range(4)] == \
            [True, False, True, False]
        assert mgr.all_steps() == [0, 2]
        with pytest.raises(CheckpointError, match="already saved"):
            mgr.save(2, state)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(state)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    d = tmp_path_factory.mktemp("ck_world2")
    rng = np.random.default_rng(2)
    full_w = np.arange(32, dtype=np.float32).reshape(8, 4)
    save_checkpoint(d / "full", {"w": torch.from_numpy(full_w),
                                 "step": torch.tensor(7, dtype=torch.int32)})
    inputs = dict(full_w=full_w, full_step=np.int32(7),
                  w=rng.normal(size=(5, 3)).astype(np.float32),
                  b=rng.normal(size=(2,)).astype(np.float32),
                  gw=rng.normal(size=(2, 5, 3)).astype(np.float32),
                  gb=rng.normal(size=(2, 2)).astype(np.float32))
    res = launch(torch_dist_ranks.checkpoint_cases, 2, inputs, str(d),
                 backend="gloo", timeout=120)
    return dict(dir=d, res=res, inputs=inputs)


def test_restore_onto_mesh_equals_place(world2):
    for r, got in enumerate(world2["res"]):
        m = got["mesh"]
        np.testing.assert_array_equal(m["local"], m["want_local"])
        np.testing.assert_array_equal(
            m["local"], world2["inputs"]["full_w"][4 * r:4 * (r + 1)])
        np.testing.assert_array_equal(m["host_local"], m["local"])
        assert m["same_placements"]


def test_zero_state_saves_the_padded_global_buffer(world2):
    from apex1_tpu_torch.parallel.distributed_optimizer import (
        shard_padded_len)
    saved = restore_checkpoint(world2["dir"] / "zero", device="cpu")
    n = 5 * 3 + 2
    for f in ("exp_avg_shard", "exp_avg_sq_shard"):
        flat = saved["opt"][f].numpy()
        assert flat.shape == (shard_padded_len(n, 2),) == (18,)
        key = "exp_avg" if f == "exp_avg_shard" else "exp_avg_sq"
        np.testing.assert_array_equal(
            flat, np.concatenate([got["zero"][key]
                                  for got in world2["res"]]))
        assert not flat[n:].any()
    assert world2["res"][0]["zero"]["global_len"] == 18
    for k in ("w", "b"):
        np.testing.assert_array_equal(saved["params"][k].numpy(),
                                      world2["res"][0]["zero"]["params"][k])
    assert int(saved["opt"]["step"]) == 2


def test_sentinel_flag_agrees_over_the_group(world2):
    """`health_flag(axis_names=...)`: a MIN all-reduce of the flag over
    the named group (JAX's ``pmin``), counted in ``mappings``."""
    got = [r["flag"] for r in world2["res"]]
    assert [g["local"] for g in got] == [True, False]
    assert [g["agreed"] for g in got] == [False, False]
    assert [g["all_reduces"] for g in got] == [1, 1]


class TestCheckpointErrors:
    def test_missing_path_is_typed(self, tmp_path):
        with pytest.raises(CheckpointError, match="missing") as ei:
            restore_checkpoint(tmp_path / "nope", device="cpu")
        assert "nope" in ei.value.path and "missing" in ei.value.reason

    def test_partial_tmp_dir_is_typed(self, tmp_path):
        half = tmp_path / "ck.tmp-1234"
        half.mkdir()
        with pytest.raises(CheckpointError, match="partial"):
            restore_checkpoint(half, device="cpu")

    def test_wrong_structure_is_typed(self, tmp_path):
        save_checkpoint(tmp_path / "ck", {"w": torch.arange(8.0)})
        with pytest.raises(CheckpointError, match="restore failed"):
            restore_checkpoint(tmp_path / "ck",
                               template={"nope": torch.zeros(3, 3)})

    @pytest.mark.parametrize("template,match", [
        ({"w": torch.zeros(4)}, "template asks float32\\[4\\]"),
        ({"w": torch.zeros(8, dtype=torch.float16)}, "float16"),
    ])
    def test_shape_or_dtype_mismatch_is_typed(self, tmp_path, template,
                                              match):
        save_checkpoint(tmp_path / "ck", {"w": torch.arange(8.0)})
        with pytest.raises(CheckpointError, match=match):
            restore_checkpoint(tmp_path / "ck", template=template)

    def test_short_leaf_file_is_typed(self, tmp_path):
        save_checkpoint(tmp_path / "ck", {"w": torch.arange(8.0)})
        leaf = tmp_path / "ck" / "leaves" / "0.bin"
        with open(leaf, "r+b") as f:
            f.truncate(12)
        with pytest.raises(CheckpointError, match="truncated"):
            restore_checkpoint(tmp_path / "ck",
                               template={"w": torch.zeros(8)})

    def test_save_leaves_no_tmp_debris_and_overwrites(self, tmp_path):
        save_checkpoint(tmp_path / "ck", {"w": torch.ones(4)})
        save_checkpoint(tmp_path / "ck", {"w": torch.zeros(4)})
        assert os.listdir(tmp_path) == ["ck"]
        got = restore_checkpoint(tmp_path / "ck",
                                 template={"w": torch.ones(4)})
        assert torch.equal(got["w"], torch.zeros(4))
        with pytest.raises(CheckpointError, match="force=False"):
            save_checkpoint(tmp_path / "ck", {"w": torch.ones(4)},
                            force=False)

    def test_unwritable_payload_is_typed(self, tmp_path):
        with pytest.raises(CheckpointError, match="save failed"):
            save_checkpoint(tmp_path / "ck", {"w": object()})
        assert os.listdir(tmp_path) == []
