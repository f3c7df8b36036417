"""Multi-tenant LoRA logit delta through adapter pages (the port of
``apex1_tpu/ops/lora_epilogue.py``).

One deployed base model, many tenants: each tenant's low-rank LM-head
adapter (A (H, r), B (r, V), the scale folded into B) lives as ``r``
pages of a pool beside the KV pool (`serving.lora.LoraAdapterStore`),
and each serving row names its pages through a rank-length block-table
row. The delta is

    delta[n] = Σ_j (h[n] · A_pages[bt[n, j]]) * B_pages[bt[n, j]]

added to the base head's logits as an epilogue (`serving.engine`).
Page 0 is the zero page, so a row with no adapter gets exactly 0.0.

CUDA tensors launch ``csrc/lora_delta.cu`` (TPU row 23): the (N, R)
coefficients once, a warp each, then B streamed by blocks of
`LORA_TILE` columns (`lora_tiles`) of one row or a few (`lora_plan`:
an explicit ``rows``, else the tuning table's, else `lora_rows`);
a row's result depends on that row's operands alone, so a mixed-tenant
batch equals each row run alone, bit for bit. CPU tensors take the plain version, the JAX
package's ``_lora_delta_ref``.
"""

from __future__ import annotations

import torch

from apex1_tpu_torch import tuning
from apex1_tpu_torch.core.capability import smem_budget
from apex1_tpu_torch.ops import _build
from apex1_tpu_torch.ops._common import (DTYPE_CODES, check_cuda, sm_count,
                                         use_kernel)
from apex1_tpu_torch.vmem_model import lora_epilogue_check

#: shared memory a block of the kernel may use: the h100 row's 227 KB
_SMEM_LIMIT = smem_budget("h100")
_H_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
#: vocab columns a block of the stream kernel takes: a float4 for each of
#: its 128 threads
LORA_TILE = 512
#: rows a block of the stream kernel takes at most, and the blocks an SM
#: its grid keeps before it groups rows
LORA_MAX_ROWS, LORA_BLOCKS_PER_SM = 8, 4


def lora_tiles(vocab: int) -> int:
    """The stream kernel's vocab tiles a row: tile i takes the columns
    [i·`LORA_TILE`, min(vocab, (i + 1)·`LORA_TILE`)), so every column
    lies in one tile and none is empty."""
    return -(-vocab // LORA_TILE)


def lora_rows(n: int, vocab: int, rank: int, sms: int) -> int:
    """Rows a block of the stream kernel takes, one after another: as
    many as keep its (tiles, ceil(n / rows)) grid at `LORA_BLOCKS_PER_SM`
    blocks on each of the ``sms`` SMs or more, at most `LORA_MAX_ROWS`
    and within the block's shared memory (8·rank bytes a row). A block
    reads B once for a run of its rows that name the same pages (a
    verify step's K + 1 rows of a slot), where each row would otherwise
    read it again through L2."""
    rows = n * lora_tiles(vocab) // (LORA_BLOCKS_PER_SM * sms)
    return max(1, min(rows, LORA_MAX_ROWS, _SMEM_LIMIT // (8 * rank)))


def lora_plan(n: int, hidden: int, vocab: int, rank: int, dtype, sms: int,
              rows=None) -> int:
    """Rows a block of the stream kernel: ``rows`` (what the sweep
    passes) > the tuning table's ``lora_epilogue`` entry for the padded
    hidden and vocab > `lora_rows`; a table's rows are cut to what the
    block's shared memory holds at this rank."""
    got, src = tuning.resolve(
        "lora_epilogue", None if rows is None else {"rows": rows},
        lambda: {"Hp": tuning.padded_lanes(hidden),
                 "Vp": tuning.padded_lanes(vocab)}, dtype, lambda: None)
    if src == "heuristic":
        return lora_rows(n, vocab, rank, sms)
    if src == "table":
        return max(1, min(got["rows"], _SMEM_LIMIT // (8 * rank)))
    return got["rows"]


def check_lora_geometry(rank: int, hidden: int, vocab: int) -> int:
    """Validate the LoRA epilogue's geometry loudly: ``rank >= 1`` and
    the stream kernel's block at one row within the card's budget under
    `vmem_model.lora_epilogue_check` (the rank's coefficients and page
    ids, 8 bytes each, and the kernels' threads and registers); returns
    the row's shared-memory bytes (a block takes `lora_plan` rows)."""
    if rank < 1:
        raise ValueError(f"lora_epilogue: rank={rank} must be >= 1")
    if hidden < 1 or vocab < 1:
        raise ValueError(f"lora_epilogue: hidden={hidden} and vocab={vocab} "
                         f"must be >= 1")
    smem = 8 * rank
    fits, _est = lora_epilogue_check(
        {"rows": 1}, {"Hp": hidden, "Vp": vocab, "R": rank}, 4, _SMEM_LIMIT)
    if not fits:
        raise ValueError(f"lora_epilogue: rank={rank} needs {smem} B of "
                         f"shared memory > the block limit {_SMEM_LIMIT} B")
    return smem


def _lora_delta_ref(h, a_pages, b_pages, block_table):
    """Gather the pages dense, then the two fp32 rank products."""
    bt = block_table.long()
    coef = torch.einsum("nh,nrh->nr", h.float(), a_pages[bt].float())
    return torch.einsum("nr,nrv->nv", coef, b_pages[bt].float())


def lora_delta(h: torch.Tensor, a_pages: torch.Tensor, b_pages: torch.Tensor,
               block_table: torch.Tensor, *, rows=None) -> torch.Tensor:
    """Per-row paged LoRA logit delta: ``h`` (N, H) hidden rows,
    ``a_pages`` (P, H) / ``b_pages`` (P, V) fp32 page pools,
    ``block_table`` (N, R) int32 page ids. Returns (N, V) fp32. CUDA
    tensors launch the kernel (``lora_delta.launches`` counts the
    launches; ``rows``: rows a block, else `lora_plan`'s), CPU tensors
    take the plain version."""
    N, H = h.shape
    R = block_table.shape[1]
    V = b_pages.shape[1]
    check_lora_geometry(R, H, V)
    if not use_kernel(h):
        return _lora_delta_ref(h, a_pages, b_pages, block_table)
    if h.dtype not in _H_DTYPES:
        raise ValueError(f"lora_delta: unsupported hidden dtype {h.dtype}")
    if a_pages.dtype != torch.float32 or b_pages.dtype != torch.float32:
        raise ValueError(f"lora_delta: the page pools must be fp32, got "
                         f"{a_pages.dtype}, {b_pages.dtype}")
    if a_pages.shape[1] != H or a_pages.shape[0] != b_pages.shape[0] \
            or block_table.shape[0] != N or block_table.dtype != torch.int32:
        raise ValueError(f"lora_delta: h {tuple(h.shape)}, a_pages "
                         f"{tuple(a_pages.shape)}, b_pages "
                         f"{tuple(b_pages.shape)} and block_table "
                         f"{tuple(block_table.shape)} {block_table.dtype} do "
                         f"not fit")
    h, bt = h.contiguous(), block_table.contiguous()
    a_pages, b_pages = a_pages.contiguous(), b_pages.contiguous()
    check_cuda("lora_delta", h, a_pages, b_pages, bt)
    out = torch.empty(N, V, dtype=torch.float32, device=h.device)
    coef = torch.empty(N, R, dtype=torch.float32, device=h.device)
    hvec = (H % 8 == 0 and h.data_ptr() % 16 == 0
            and a_pages.data_ptr() % 16 == 0)
    vec4 = V % 4 == 0 and b_pages.data_ptr() % 16 == 0
    rows = lora_plan(N, H, V, R, h.dtype, sm_count(h.device), rows)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    _build.launch("apex1_lora_delta", h.data_ptr(), a_pages.data_ptr(),
                  b_pages.data_ptr(), bt.data_ptr(), coef.data_ptr(),
                  out.data_ptr(), N, H, V, R, rows, int(hvec), int(vec4),
                  DTYPE_CODES[h.dtype], stream)
    lora_delta.launches += 1
    return out


lora_delta.launches = 0
