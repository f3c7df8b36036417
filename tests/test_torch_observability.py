"""`utils.observability` (``Timers``, ``trace``, ``cost_analysis`` /
``flops_per_step``), the pytree helpers against the JAX package's on the
same trees, and the testing helpers of `apex1_tpu_torch.testing`.

FLOPs are counted on the plain path on meta tensors, without the
recomputation of flash attention's and the fused head's backward: a
dense layer's forward is 2·M·N·K and its training step 6·M·N·K; a tiny
GPT-2 step (flash attention, fused head) is the model count, 6 per
weight (head included) and token plus 12·L·S·H per token for
attention."""

import datetime
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from apex1_tpu.core import pytree as jpt
from apex1_tpu.testing import print_separator as jax_print_separator
from apex1_tpu_torch import Amp, GPT2Config, fused_adam, get_policy
from apex1_tpu_torch import testing as tt
from apex1_tpu_torch.core import pytree as pt
from apex1_tpu_torch.models.gpt2 import GPT2, gpt2_loss_fn
from apex1_tpu_torch.obs import read_events
from apex1_tpu_torch.utils.observability import (Timers, cost_analysis,
                                                 flops_per_step, trace)


def test_timers_accumulate_and_log_to_the_spine(tmp_path, monkeypatch):
    monkeypatch.setenv("APEX1_OBS_DIR", str(tmp_path))
    timers = Timers()
    for _ in range(3):
        timers("fwd").start()
        timers("fwd").stop(sync=torch.ones(2))
    timers("bwd").start().stop()
    assert timers("fwd").count == 3
    got = timers.log()
    assert set(got) == {"fwd", "bwd"} and got["fwd"] > 0
    assert timers("fwd").count == 0 and timers.log(["nope"]) == {}
    from apex1_tpu_torch.obs import default_run
    path = default_run().path
    monkeypatch.delenv("APEX1_OBS_DIR")
    default_run()
    recs = read_events(path, kinds=("counter",))
    assert [(r["name"], r["count"]) for r in recs] == [("timer.fwd", 3),
                                                      ("timer.bwd", 1)]


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "tr")
    assert any("mm" in e.get("name", "") for e in events)


def test_dense_layer_flops_forward_and_training_step():
    M, K, N = 8, 16, 32
    x, w = torch.randn(M, K), torch.randn(K, N)
    assert cost_analysis(lambda a, b: a @ b, x, w) == {"flops": 2 * M * N * K}

    def train_step(a, b):
        b = b.detach().requires_grad_()
        a = a.detach().requires_grad_()
        loss = (a @ b).square().sum()
        return torch.autograd.grad(loss, (a, b))

    assert flops_per_step(train_step, x, w) == 6 * M * N * K
    # meta copies: the real tensors are never read or written
    assert not w.requires_grad


def gpt2_step_flops(cfg: GPT2Config, B: int, S: int) -> int:
    """The model FLOPs of a GPT-2 training step on B x S tokens: 6 x
    (matmul weights, head included) x tokens + 12 x L x S x H x
    tokens."""
    H, L, V = cfg.hidden_size, cfg.num_layers, cfg.padded_vocab
    weights = L * (3 * H * H + H * H + 2 * cfg.mlp_ratio * H * H) + V * H
    return 6 * weights * B * S + 12 * L * S * H * B * S


def test_tiny_gpt2_step_flops_match_the_analytic_count():
    cfg = GPT2Config.tiny(policy=get_policy("O2"))
    model = GPT2(cfg, device="cpu")
    amp = Amp(fused_adam(3e-4), opt_level="O2", max_grad_norm=1.0)
    state = amp.init(dict(model.named_parameters()))
    before = {k: v.clone() for k, v in state.params.items()}
    B, S = 2, 32
    tokens = torch.zeros(B, S, dtype=torch.int64)
    got = flops_per_step(amp.make_train_step(gpt2_loss_fn(model)), state,
                         tokens)
    want = gpt2_step_flops(cfg, B, S)
    assert abs(got - want) <= 0.05 * want, (got, want)
    assert all(torch.equal(before[k], v) for k, v in state.params.items())


def _values_and_grads(fn, *xs):
    xs = [x.detach().requires_grad_() for x in xs]
    out = fn(*xs)
    return [out.detach(), *torch.autograd.grad(out.square().sum(), xs)]


@pytest.mark.parametrize("op", ["flash_attention", "linear_cross_entropy"])
def test_autodiff_plain_path_equals_the_plain_path(rng, op):
    """What `cost_analysis` counts is the same function, with the same
    gradients, as the plain path the CPU runs."""
    from apex1_tpu_torch import ops
    if op == "flash_attention":
        xs = [torch.from_numpy(rng.normal(size=(2, 4, 16, 8))
                               .astype(np.float32)) for _ in range(3)]

        def fn(q, k, v):
            return ops.flash_attention(q, k, v, causal=True)
    else:
        labels = torch.from_numpy(rng.integers(0, 50, (12,)))
        xs = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
              for s in ((12, 16), (50, 16))]

        def fn(x, w):
            return ops.linear_cross_entropy(x, w, labels, smoothing=0.1)
    with ops.force_impl("torch"):
        want = _values_and_grads(fn, *xs)
    with ops.force_impl("autodiff"):
        got = _values_and_grads(fn, *xs)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def _tree(rng):
    return {"b": [rng.normal(size=(2, 3)).astype(np.float32),
                  rng.integers(0, 9, (4,)).astype(np.int32)],
            "a": {"x": rng.normal(size=(5,)).astype(np.float16),
                  "s": np.float32(2.5)},
            "c": (rng.normal(size=(3,)).astype(np.float32),)}


def _torch_tree(tree):
    return pt.tree_map_with_path(lambda _, x: torch.from_numpy(np.asarray(x)),
                                 tree)


def test_pytree_helpers_equal_jax(rng):
    tree = _tree(rng)
    other = _tree(np.random.default_rng(5))
    tt_tree, tt_other = _torch_tree(tree), _torch_tree(other)
    got = pt.tree_float_leaves(tt_tree)
    want = jpt.tree_float_leaves(tree)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for out_dtype, jdt in ((None, None), (torch.float32, jnp.float32)):
        got = pt.tree_axpby(0.5, tt_tree, -2.0, tt_other, out_dtype)
        want = jpt.tree_axpby(0.5, tree, -2.0, other, jdt)
        for (p, g), (_, w) in zip(pt.tree_flatten_with_path(got),
                                  pt.tree_flatten_with_path(want)):
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype, pt.keystr(p)
            np.testing.assert_array_equal(g.numpy(), w)
    cast = pt.tree_cast_like(tt_tree, tt_other)
    assert [x.dtype for _, x in pt.tree_flatten_with_path(cast)] == [
        x.dtype for _, x in pt.tree_flatten_with_path(tt_other)]
    jcast = jpt.tree_cast_like(tree, other)
    for (_, g), (_, w) in zip(pt.tree_flatten_with_path(cast),
                              pt.tree_flatten_with_path(jcast)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    names = pt.named_tree_map(lambda n, x: n, tt_tree, sep=".")
    jnames = jpt.named_tree_map(lambda n, x: n, tree, sep=".")
    assert names == jnames
    assert names["b"] == ["b.0", "b.1"] and names["c"] == ("c.0",)


def test_random_seed_and_devices():
    g = tt.set_random_seed(7)
    assert isinstance(g, torch.Generator)
    a = torch.randn(3, generator=g)
    assert torch.equal(a, torch.randn(3, generator=tt.set_random_seed(7)))
    assert np.random.rand() == (np.random.seed(7), np.random.rand())[1]
    assert tt.assert_devices(0) == []
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tt.assert_devices(1)


def test_distributed_mesh_sets_up_and_tears_down(tmp_path):
    from apex1_tpu_torch.transformer import parallel_state as ps
    with pytest.raises(RuntimeError, match="init_distributed"):
        with tt.distributed_mesh():
            pass
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/st",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=30))
    try:
        with tt.distributed_mesh(dp=1) as mesh:
            assert ps.model_parallel_is_initialized()
            assert mesh.size("dp") == 1
        assert not ps.model_parallel_is_initialized()
        with pytest.raises(RuntimeError, match="2"):
            with tt.distributed_mesh(tp=2):
                pass
    finally:
        dist.destroy_process_group()


def test_global_args_and_standalone_models(capsys):
    assert tt.get_args() == tt.TestArgs()
    args = tt.TestArgs(seq_length=16, num_layers=1, hidden_size=32)
    tt.set_global_args(args)
    try:
        assert tt.get_args() is args
        for make in (tt.standalone_gpt, tt.standalone_bert):
            model, batch, params, loss_fn = make(device="cpu")
            assert model.cfg.policy.name == "O1"
            assert torch.isfinite(loss_fn(params, batch))
    finally:
        tt.set_global_args(None)
    tt.print_separator("port")
    jax_print_separator("port")
    port, jax_line = capsys.readouterr().out.splitlines()
    assert port == jax_line and len(port) == 72
