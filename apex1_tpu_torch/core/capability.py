"""The card's capability row (the port of ``apex1_tpu/core/capability.py``):
the per-generation hardware facts the planner prices with and the
``require`` guard contrib modules call.

The JAX package's table has a row per TPU generation; this one has a row
per GPU the port runs on, today one: ``"h100"``, NVIDIA's H100 SXM5.
Its figures are NVIDIA's data-sheet figures for that card (dense rates,
without sparsity, at the full 700 W power limit), the ones
``chip_smoke.py`` bounds every kernel with. They are spec figures, not
measurements and not TPU figures. One field is measured: the HBM the
CUDA context and the kernel library hold back (``hbm_reserve_bytes``,
read on the card with ``python -m apex1_tpu_torch.planner
--measure-reserve``).

Detection reads ``torch.cuda.get_device_name`` and
``get_device_capability``. With no card (the CPU tests, planning tools
run on a laptop) the default row is h100; on a card that no row
describes, `get_capability` raises naming the known rows: a price at
the wrong card's peaks is worse than none.
"""

from __future__ import annotations

import dataclasses

#: the feature names `require` knows: the JAX package's names
FEATURES = ("fp8", "sparsecore", "ici_3d", "megacore")


@dataclasses.dataclass(frozen=True)
class GpuCapability:
    """Per-generation facts that gate or price the port's behaviour."""

    generation: str            # canonical row name: "h100"
    device_name: str           # what torch.cuda.get_device_name says
    compute_capability: tuple  # (major, minor): (9, 0) is sm_90
    sms: int                   # streaming multiprocessors
    smem_sm_bytes: int         # shared memory an SM
    smem_block_bytes: int      # the most shared memory one block may use
    hbm_bytes: int             # device memory
    hbm_gbps: float            # device memory rate (GB/s)
    bf16_tflops: float         # dense bf16/fp16 on the tensor cores
    fp32_tflops: float         # fp32 outside the tensor cores
    link_gbps: float           # one peer's link rate, one direction (GB/s)
    hbm_reserve_bytes: int     # held back from hbm_bytes (see module doc)
    features: tuple = ()       # the `FEATURES` the card has
    platform: str = "gpu"      # the tag of its banked measurements
    regs_sm: int = 65536       # 32-bit registers an SM
    regs_thread: int = 255     # the most registers one thread may use
    threads_block: int = 1024  # the most threads a block
    threads_sm: int = 2048     # resident threads an SM
    blocks_sm: int = 32        # resident blocks an SM


#: bytes of ``hbm_bytes`` the planner may not plan into on an H100: 80
#: GiB less what ``torch.cuda.mem_get_info`` reports free once the CUDA
#: context and the kernel library are loaded (the card reports 85017493504
#: bytes in all and 84366524416 free; read on an NVIDIA H100 80GB HBM3 at
#: a 700.00 W power limit with ``python -m apex1_tpu_torch.planner
#: --measure-reserve``)
H100_HBM_RESERVE = 1_530_724_352

_TABLE = {
    # NVIDIA H100 SXM5 data sheet: 132 SMs, 228 KiB shared memory an SM
    # (227 KiB to one block), 80 GiB HBM3 at 3.35 TB/s, 989 TFLOP/s dense
    # bf16/fp16, 67 TFLOP/s fp32, fp8 on the tensor cores, NVLink 4 at
    # 900 GB/s both directions together: 450 GB/s a direction to a peer;
    # the register file and thread limits of compute capability 9.0 (the
    # data sheet and the CUDA programming guide's table for sm_90): 65,536
    # 32-bit registers an SM, 255 a thread, 1,024 threads a block, 2,048
    # resident threads and 32 resident blocks an SM
    "h100": GpuCapability(
        "h100", "NVIDIA H100 80GB HBM3", (9, 0), 132, 228 * 1024,
        227 * 1024, 80 * 2**30, 3350.0, 989.0, 67.0, 450.0,
        H100_HBM_RESERVE, features=("fp8",), regs_sm=65536,
        regs_thread=255, threads_block=1024, threads_sm=2048,
        blocks_sm=32),
}


def _canonical(name: str, capability: tuple) -> str | None:
    if "H100" in name.upper() and tuple(capability) == (9, 0):
        return "h100"
    return None


def detect_generation() -> str | None:
    """The attached card's row name; None with no card. A card that no
    row describes raises `ValueError` naming the known rows."""
    import torch
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(0)
    cc = tuple(torch.cuda.get_device_capability(0))
    gen = _canonical(name, cc)
    if gen is None:
        raise ValueError(
            f"no capability row for the attached card {name!r} (compute "
            f"capability {cc[0]}.{cc[1]}); known: {sorted(_TABLE)}")
    return gen


def default_generation() -> str:
    """The detected card's row, h100 when no card is attached."""
    return detect_generation() or "h100"


def get_capability(generation: str | None = None) -> GpuCapability:
    """Capability row for ``generation`` (default: the detected card;
    h100 with no card)."""
    gen = generation or default_generation()
    try:
        return _TABLE[gen]
    except KeyError:
        raise ValueError(
            f"unknown GPU generation {gen!r}; known: {sorted(_TABLE)}"
        ) from None


def known_generation(generation) -> bool:
    return generation in _TABLE


class CapabilityError(RuntimeError):
    """The card lacks a feature a module needs (the JAX package's
    counterpart of apex's "requires compute capability >= sm80")."""


def require(feature: str, *, generation: str | None = None) -> None:
    """Raise `CapabilityError` unless the card has ``feature`` (one of
    `FEATURES`: "fp8" holds on an H100; "sparsecore", "ici_3d" and
    "megacore" are TPU parts no GPU row has)."""
    if feature not in FEATURES:
        raise ValueError(f"unknown feature {feature!r}; known: "
                         f"{sorted(FEATURES)}")
    cap = get_capability(generation)
    if feature not in cap.features:
        raise CapabilityError(
            f"feature {feature!r} is not available on {cap.device_name} "
            f"(the {cap.generation} row)")


def smem_budget(generation: str | None = None) -> int:
    """Shared-memory bytes one block may use: the budget a kernel's tile
    planner sizes against (the role of the JAX package's
    ``vmem_budget``)."""
    return get_capability(generation).smem_block_bytes


def regs_budget(generation: str | None = None) -> int:
    """32-bit registers one block may hold: the SM's register file (a
    block of ``threads`` threads at ``r`` registers each needs ``threads
    * r`` of them to launch). `vmem_model`'s register checks price
    against it, as its shared-memory checks price against
    `smem_budget`."""
    return get_capability(generation).regs_sm


def link_gbps(generation: str | None = None) -> float:
    """One peer's link rate in one direction (GB/s): the rate a ring hop
    (one neighbour transfer) sees, the denominator of the planner's
    exposed-communication term. 0.0 when the row carries none."""
    return get_capability(generation).link_gbps
