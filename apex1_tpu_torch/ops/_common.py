"""Shared kernel-dispatch machinery for `apex1_tpu_torch.ops`.

Every op ships two implementations:

- a **CUDA C++ kernel for Hopper** (``csrc/``, built by `ops._build`),
  launched whenever the op is handed CUDA tensors;
- a **plain PyTorch version** of the same function, used when the op
  is handed CPU tensors (the CPU tests) and by ``chip_smoke.py`` as the
  yardstick the kernel is held against on the card.

Dispatch is decided by the tensor's device alone: a CUDA tensor
launches the kernel or raises, a CPU tensor takes the plain version.
There is no fallback from a failed kernel. ``force_impl("torch")``
routes CUDA tensors to the plain version for comparisons only;
``force_impl("kernel")`` makes a CPU tensor an error instead of a
silent plain run.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

_IMPL = "auto"  # "auto" | "kernel" | "torch"

NEG_INF = -1e30  # finite mask value, as in the JAX package


def set_impl(mode: str) -> None:
    global _IMPL
    if mode not in ("auto", "kernel", "torch"):
        raise ValueError(f"impl must be auto|kernel|torch, got {mode!r}")
    _IMPL = mode


def get_impl() -> str:
    return _IMPL


@contextlib.contextmanager
def force_impl(mode: str):
    prev = _IMPL
    set_impl(mode)
    try:
        yield
    finally:
        set_impl(prev)


def use_kernel(x: torch.Tensor) -> bool:
    """True when ``x`` must go through the CUDA kernel."""
    if _IMPL == "torch":
        return False
    if x.is_cuda:
        return True
    if _IMPL == "kernel":
        raise RuntimeError(
            f"force_impl('kernel') needs CUDA tensors, got {x.device}")
    return False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Asking for CUDA where there is none raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def pad_to(x: torch.Tensor, axis: int, multiple: int, value=0.0):
    """Pad ``axis`` up to a multiple; returns (padded, original_size)."""
    size = x.shape[axis]
    rem = (-size) % multiple
    if rem == 0:
        return x, size
    axis = axis % x.ndim
    pads = [0, 0] * (x.ndim - axis - 1) + [0, rem]
    return F.pad(x, pads, value=value), size


def check_cuda(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Shared wrapper checks: every operand on one CUDA device and
    contiguous (the kernels index raw pointers with dense strides)."""
    dev = None
    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name}: every operand must be on CUDA, "
                             f"got {t.device}")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: operands on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


#: kernel dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.int8: 3}
