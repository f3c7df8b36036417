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
silent plain run. ``force_impl("autodiff")`` is the plain version too,
except that the ops whose plain backward forms products again (flash
attention, the fused linear cross-entropy) differentiate their plain
forward with autograd instead: each product is then formed once forward
and differentiated once, the count a model FLOP figure assumes
(`utils.observability.cost_analysis`).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.distributed.tensor import DTensor

_IMPL = "auto"  # "auto" | "kernel" | "torch" | "autodiff"

NEG_INF = -1e30  # finite mask value, as in the JAX package


def set_impl(mode: str) -> None:
    global _IMPL
    if mode not in ("auto", "kernel", "torch", "autodiff"):
        raise ValueError(f"impl must be auto|kernel|torch|autodiff, got "
                         f"{mode!r}")
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
    if _IMPL in ("torch", "autodiff"):
        return False
    if x.is_cuda:
        return True
    if _IMPL == "kernel":
        raise RuntimeError(
            f"force_impl('kernel') needs CUDA tensors, got {x.device}")
    return False


def plain_autodiff() -> bool:
    """True under ``force_impl("autodiff")``."""
    return _IMPL == "autodiff"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Asking for CUDA where there is none raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


_SMS: dict = {}


def sm_count(device: torch.device) -> int:
    """The SM count of a CUDA ``device``, read once: grids that split
    their work to fill the card size themselves by it."""
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def check_cuda(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Shared wrapper checks: every operand a plain tensor (a DTensor's
    ``data_ptr`` is not its data: gather it first, `core.mesh.gathered`),
    on one CUDA device and contiguous (the kernels index raw pointers
    with dense strides)."""
    dev = None
    for t in tensors:
        if t is None:
            continue
        if isinstance(t, DTensor):
            raise TypeError(f"{name}: got a DTensor; the kernel takes plain "
                            f"tensors (gather it with core.mesh.gathered)")
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
