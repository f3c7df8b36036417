"""The port's `utils.debug` on the CPU (the JAX package's
``utils/debug.py`` hashes a jaxpr; the port hashes the ATen ops a call
dispatches and its kernel launches).

- `program_fingerprint` is stable for one program and arguments (a
  63-bit int, like JAX's), independent of the argument values, and
  changes with a shape, a dtype or an op; it does not touch the
  caller's tensors; a GPT-2 train step's fingerprint repeats;
- `assert_same_program_across_processes` returns the fingerprint on one
  process and at gloo world 2 (`parallel.launch`, body in
  tests/torch_dist_ranks.py), and raises on every rank when rank 1 runs
  another shape;
- `assert_donation_safe` passes a pure step and a train step, and
  catches a step that writes into its input and a nondeterministic one;
- `enable_deterministic` sets PyTorch's flags (restored afterwards).
"""

import numpy as np
import pytest
import torch

from apex1_tpu_torch.parallel import launch
from apex1_tpu_torch.utils.debug import (assert_donation_safe,
                                         assert_same_program_across_processes,
                                         enable_deterministic,
                                         program_fingerprint,
                                         program_record)

import torch_dist_ranks


def f(x, w):
    return torch.tanh(x @ w).sum()


X, W = torch.ones(4, 8), torch.ones(8, 3)


def test_fingerprint_stable_and_value_free():
    a = program_fingerprint(f, X, W)
    assert a == program_fingerprint(f, X, W)
    assert a == program_fingerprint(f, torch.randn(4, 8), torch.randn(8, 3))
    assert 0 <= a < 2 ** 63
    assert program_record(f, X, W) == [
        "aten.mm.default((T(4, 8):torch.float32,T(8, 3):torch.float32);{})",
        "aten.tanh.default((T(4, 3):torch.float32);{})",
        "aten.sum.default((T(4, 3):torch.float32);{})"]


@pytest.mark.parametrize("other", [
    lambda: program_fingerprint(f, torch.ones(5, 8), W),
    lambda: program_fingerprint(f, X.double(), W.double()),
    lambda: program_fingerprint(lambda x, w: torch.relu(x @ w).sum(), X, W),
    lambda: program_fingerprint(lambda x, w: (x @ w).mean(), X, W)])
def test_fingerprint_changes_with_shape_dtype_or_op(other):
    assert other() != program_fingerprint(f, X, W)


def test_fingerprint_runs_on_copies():
    x = torch.ones(3)
    program_fingerprint(lambda t: t.add_(1.0), x)
    assert torch.equal(x, torch.ones(3))


def _gpt2_step():
    from apex1_tpu_torch import (Amp, GPT2Config, fused_adam, get_policy,
                                 gpt2_loss_fn, gpt2_params_from_jax)
    from apex1_tpu_torch.models.gpt2 import init_params
    cfg = GPT2Config.tiny(num_layers=1, hidden_size=64, max_seq_len=16,
                          use_flash=False, policy=get_policy("O0"))
    model = gpt2_params_from_jax(init_params(cfg, 0), cfg, "cpu")
    amp = Amp(fused_adam(1e-3), opt_level="O0")
    state = amp.init(dict(model.named_parameters()))
    step = amp.make_train_step(gpt2_loss_fn(model, fuse_head=False))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 16)))
    return step, state, tokens


def test_train_step_fingerprint_and_donation_safety():
    step, state, tokens = _gpt2_step()
    assert program_fingerprint(step, state, tokens) == \
        program_fingerprint(step, state, tokens)
    assert_donation_safe(step, state, tokens)


def test_single_process_returns_the_fingerprint():
    assert assert_same_program_across_processes(f, X, W) == \
        program_fingerprint(f, X, W)


def test_same_program_across_gloo_ranks():
    rng = np.random.default_rng(0)
    inputs = dict(x=rng.normal(size=(4, 8)).astype(np.float32),
                  w=rng.normal(size=(8, 3)).astype(np.float32))
    res = launch(torch_dist_ranks.debug_cases, 2, inputs, backend="gloo",
                 timeout=120)
    assert res[0]["fp"] == res[1]["fp"] == program_fingerprint(f, X, W)
    for got in res:
        assert got["err"].startswith("AssertionError: program divergence")


def test_donation_safe_passes_a_pure_step():
    assert_donation_safe(lambda x, w: (x @ w, {"n": x.sum()}), X, W)


def test_donation_safe_catches_a_mutating_step():
    with pytest.raises(AssertionError, match="wrote into its arguments"):
        assert_donation_safe(lambda x: x.mul_(2.0), torch.ones(3))
    assert_donation_safe(lambda x: x.mul(2.0), torch.ones(3))


def test_donation_safe_catches_nondeterminism():
    calls = []

    def step(x):
        calls.append(1)
        return x + len(calls)

    with pytest.raises(AssertionError, match="diverged"):
        assert_donation_safe(step, torch.ones(3))


def test_enable_deterministic_sets_the_flags(monkeypatch):
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    try:
        enable_deterministic()
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.backends.cudnn.deterministic
        assert not torch.backends.cudnn.benchmark
        import os
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    finally:
        torch.use_deterministic_algorithms(before[0])
        torch.backends.cudnn.deterministic = before[1]
        torch.backends.cudnn.benchmark = before[2]
