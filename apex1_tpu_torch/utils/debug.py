"""Race, divergence and aliasing debug tools (the port of
``apex1_tpu/utils/debug.py``; reference
``tests/distributed/DDP/ddp_race_condition_test.py``).

- Cross-process program divergence (ranks running different programs
  issue mismatched collectives and hang): `program_fingerprint` hashes
  what a function dispatches, and `assert_same_program_across_processes`
  compares the hash over the default process group before the real run:
  a hang turned into an assertion. The JAX package hashes the jaxpr;
  eager PyTorch has none, so the port records each ATen op the call
  dispatches (``TorchDispatchMode``: the op, its tensors' shapes and
  dtypes, its other arguments) and the port's kernel launches by name
  (`ops.launch_counts`), and hashes that record.
- Aliasing corruption (a step writing into a buffer the caller still
  holds): `assert_donation_safe` runs a step from fresh clones of its
  arguments, twice or more, and asserts the outputs agree and the
  clones it was handed are unchanged.
- Nondeterminism: `enable_deterministic` sets PyTorch's deterministic
  flags.
"""

from __future__ import annotations

import hashlib
import os
from typing import Callable

import numpy as np
import torch


def _clone_tree(tree):
    from apex1_tpu_torch.core.pytree import tree_map_with_path
    return tree_map_with_path(
        lambda p, x: x.detach().clone() if isinstance(x, torch.Tensor)
        else x, tree)


def _describe(x) -> str:
    """A dispatched argument as the record keeps it: a tensor by shape
    and dtype (not its values or device), containers by their items,
    anything else by its repr."""
    if isinstance(x, torch.Tensor):
        return f"T{tuple(x.shape)}:{x.dtype}"
    if isinstance(x, (list, tuple)):
        return "(" + ",".join(_describe(v) for v in x) + ")"
    if isinstance(x, dict):
        return "{" + ",".join(f"{k}={_describe(v)}"
                              for k, v in sorted(x.items())) + "}"
    if isinstance(x, torch.device):
        return "device"
    return repr(x)


def program_record(fn: Callable, *args, **kwargs) -> list:
    """The lines `program_fingerprint` hashes: one a dispatched ATen op
    (``op(args; kwargs)``), then ``kernel name xN`` for each of the
    port's kernels the call launched. ``fn`` runs once on clones of the
    arguments."""
    from torch.utils._python_dispatch import TorchDispatchMode

    import apex1_tpu_torch.ops as ops

    lines: list = []

    class _Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), kw=None):
            kw = kw or {}
            lines.append(f"{func}({_describe(a)};{_describe(kw)})")
            return func(*a, **kw)

    a, k = _clone_tree(args), _clone_tree(kwargs)
    before = ops.launch_counts()
    with _Record():
        fn(*a, **k)
    after = ops.launch_counts()
    lines += [f"kernel {n} x{after[n] - before[n]}" for n in sorted(after)
              if after[n] != before[n]]
    return lines


def program_fingerprint(fn: Callable, *args, **kwargs) -> int:
    """Stable 63-bit hash of what ``fn`` dispatches for these arguments
    (`program_record`): the ops, their operands' shapes and dtypes and
    the port's kernel launches. The same function on same-shaped
    arguments gives the same fingerprint; another shape, dtype or op
    another."""
    text = "\n".join(program_record(fn, *args, **kwargs))
    digest = hashlib.sha256(text.encode()).digest()
    return int.from_bytes(digest[:8], "big") >> 1


def assert_same_program_across_processes(fn: Callable, *args,
                                         **kwargs) -> int:
    """Every process of the default group must run the same program:
    the fingerprints are all-gathered (as two 32-bit halves) and
    compared. One process: the fingerprint, no collective."""
    import torch.distributed as dist
    fp = program_fingerprint(fn, *args, **kwargs)
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return fp
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    halves = torch.tensor([fp >> 32, fp & 0xFFFFFFFF], dtype=torch.int64,
                          device=dev)
    got = [torch.empty_like(halves) for _ in range(dist.get_world_size())]
    dist.all_gather(got, halves)
    joined = [(int(h[0]) << 32) | int(h[1]) for h in got]
    if any(j != joined[0] for j in joined):
        raise AssertionError(
            f"program divergence across processes: fingerprints "
            f"{[hex(j) for j in joined]} (rank {dist.get_rank()} has "
            f"{hex(fp)}) — ranks would issue mismatched collectives and "
            f"hang")
    return fp


def _host_leaves(tree) -> list:
    from apex1_tpu_torch.core.pytree import tree_flatten_with_path
    out = []
    for _, x in tree_flatten_with_path(tree):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu()
            out.append(x.float().numpy() if x.dtype == torch.bfloat16
                       else x.numpy())
        else:
            out.append(np.asarray(x))
    return out


def assert_donation_safe(step: Callable, *args, n_checks: int = 2,
                         rtol: float = 0.0, atol: float = 0.0) -> None:
    """Run ``step`` ``n_checks`` times, each from fresh clones of
    ``args``. A run whose outputs differ from the first (nondeterminism,
    or a step reading a buffer something else wrote), or a step that
    writes into the arguments it was handed (the caller's live buffers,
    in a real loop), fails."""
    want = _host_leaves(args)
    ref = None
    for i in range(n_checks):
        copies = _clone_tree(args)
        out = _host_leaves(step(*copies))
        for a, b in zip(want, _host_leaves(copies)):
            if not np.array_equal(a, b, equal_nan=a.dtype.kind == "f"):
                raise AssertionError(
                    f"run {i}: the step wrote into its arguments (a "
                    "buffer the caller still holds would be corrupted)")
        if ref is None:
            ref = out
            continue
        for a, b in zip(ref, out):
            if not np.allclose(a, b, rtol=rtol, atol=atol):
                raise AssertionError(
                    "aliasing corruption (or nondeterminism): run "
                    f"{i} diverged from run 0 by "
                    f"{np.max(np.abs(a.astype(np.float64) - b.astype(np.float64)))}")


def enable_deterministic() -> None:
    """Deterministic-run flags for tests:

    - ``torch.use_deterministic_algorithms(True)``: an op with only a
      nondeterministic CUDA implementation (an atomics-based
      ``index_add_`` or scatter) raises instead of running, and the ops
      with a deterministic alternative take it;
    - ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (unless set): cuBLAS's
      deterministic workspace, which the flag above requires on CUDA;
    - ``torch.backends.cudnn.deterministic = True`` and ``benchmark =
      False``: cuDNN picks deterministic convolution algorithms and does
      not autotune (autotuning may pick another algorithm per run).

    The port's own kernels sum in a fixed order (no atomics), so they
    repeat their bits under any flag."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
