"""Tunable-kernel registry (the port of ``apex1_tpu/tuning/registry.py``):
the schema half of the tuning layer.

One :class:`KernelSpec` for each of the JAX package's 15 names declares

- which **launch parameters** the CUDA launcher takes that have a
  choice (``params``, in canonical order);
- which **padded dims** key its table entries (``dims``: the dims that
  change the launch problem, never raw batch counts);
- the **alignment** every parameter must meet; and
- the **budget check**: `apex1_tpu_torch.vmem_model`'s gate of the
  launch's shared memory and registers a block, against which a table
  entry is held at lookup (an entry past the recorded row's budget is a
  miss, and the launcher's heuristic takes over).

Seven kernels have launch parameters with a choice, each chosen today
by a heuristic in code: ``int8_matmul`` (``bm``, ``bt``, ``splits``,
``kc``: `ops.quantized._tile` and ``_split_k``), ``fused_sample``
(``splits``: `ops.paged_decode.sample_splits`), ``paged_decode``
(``per``, the 64-position key blocks a split of
`ops.paged_decode.paged_geometry`, from which the split count follows),
``lora_epilogue`` (``rows``: `ops.lora_epilogue.lora_rows`),
``fused_swiglu`` (``tile_n``, the 64- or 128-column tile of
``csrc/glu.cu``'s ``tile_n``), ``fused_collective_matmul`` (``block_m``,
``block_n``: one of the tiles ``csrc/chunk_matmul.cu``'s ``tile_of``
chooses among) and ``chunked_loss`` (``chunk_v``). A table only chooses
among what the library builds: no table entry compiles a new tile.

The other eight take no table entry (``fixed=True``): flash attention
and the all-gather flash step (``block_q``/``block_k``, and the JAX
package's ``APEX1_ATTN_BLOCK_Q/K`` override, which the port does not
read), ``linear_xent`` (``block_t``/``block_v``) and the row kernels
(``block_rows``). Their CUDA tiles are compile-time constants; the
JAX-named block arguments keep today's meaning in the ops (accepted,
no effect on the CUDA grid), and their checks price the fixed frames so
that every kernel has a gate.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

from apex1_tpu_torch.vmem_model import CHECKS


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Declarative description of one kernel's launch choices."""

    name: str
    params: tuple[str, ...]       # launch parameters, in canonical order
    dims: tuple[str, ...]         # padded dims that key table entries
    align: int                    # every parameter a multiple of this
    # (blocks, dims, esize, budget_bytes) -> (fits, vmem_model.Estimate)
    check: Callable[[Mapping[str, int], Mapping[str, int], int, int],
                    tuple]
    fixed: bool = False           # CUDA tiles fixed: no table entry


SPECS: dict[str, KernelSpec] = {spec.name: spec for spec in (
    # fixed tiles: the JAX package's block names, priced at the CUDA
    # kernels' own frames (Sb: the power-of-two seq bucket)
    KernelSpec("flash_attention", ("block_q", "block_k"), ("Dp", "Sb"),
               16, CHECKS["flash_attention"], fixed=True),
    KernelSpec("fused_softmax", ("block_rows",), ("lanes",), 8,
               CHECKS["fused_softmax"], fixed=True),
    KernelSpec("layer_norm", ("block_rows",), ("lanes",), 8,
               CHECKS["layer_norm"], fixed=True),
    KernelSpec("rope", ("block_rows",), ("lanes",), 8,
               CHECKS["rope"], fixed=True),
    KernelSpec("xentropy", ("block_rows",), ("lanes",), 8,
               CHECKS["xentropy"], fixed=True),
    KernelSpec("bias_dropout_add", ("block_rows",), ("lanes",), 8,
               CHECKS["bias_dropout_add"], fixed=True),
    KernelSpec("linear_xent", ("block_t", "block_v"), ("Hp",), 16,
               CHECKS["linear_xent"], fixed=True),
    KernelSpec("fused_ag_flash", ("block_q", "block_k"), ("Dp", "Sb"),
               16, CHECKS["fused_ag_flash"], fixed=True),
    # the chunk product: one of the library's tiles, keyed on padded K
    KernelSpec("fused_collective_matmul", ("block_m", "block_n"),
               ("Kp",), 64, CHECKS["fused_collective_matmul"]),
    # int8_mm: the tile (weight rows, tokens) and the K split; keyed on
    # the weight's N and K and the decode step's token bucket (Tb)
    KernelSpec("int8_matmul", ("bm", "bt", "splits", "kc"),
               ("N", "K", "Tb"), 1, CHECKS["int8_matmul"]),
    # paged attention: the key blocks a split; keyed on the head dim and
    # the query rows a kv head (G·S; 1 at a GPT-2 decode step)
    KernelSpec("paged_decode", ("per",), ("Dp", "Rq"), 1,
               CHECKS["paged_decode"]),
    # the sampler: the vocab splits of a row; keyed on the padded vocab
    # and the rows of the step
    KernelSpec("fused_sample", ("splits",), ("Vp", "R"), 1,
               CHECKS["fused_sample"]),
    # the chunked losses: the vocab chunk (the kernels are linear_xent's)
    KernelSpec("chunked_loss", ("chunk_v",), ("Hp",), 128,
               CHECKS["chunked_loss"]),
    # the fused GLU: the output tile's columns; keyed on the padded
    # hidden and the token bucket (Tb)
    KernelSpec("fused_swiglu", ("tile_n",), ("Hp", "Tb"), 64,
               CHECKS["fused_swiglu"]),
    # the LoRA delta: rows a block of the stream kernel
    KernelSpec("lora_epilogue", ("rows",), ("Hp", "Vp"), 1,
               CHECKS["lora_epilogue"]),
)}
