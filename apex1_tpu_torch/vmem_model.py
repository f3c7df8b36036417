"""The one per-kernel budget model of the port's CUDA kernels (the port of
``apex1_tpu/vmem_model.py``; the name is kept so that a reader finds the
counterpart).

The JAX package prices each Pallas kernel's VMEM frame: double-buffered
operand blocks and scratch against the TPU generation's VMEM budget. A
Hopper block has two scarce resources instead, shared memory (227 KB a
block on an H100) and the register file (65,536 32-bit registers an SM,
255 a thread). Each check here prices, for one of the JAX package's
kernel names, every CUDA kernel that name's launcher may start at the
given dims and element size:

- **shared memory a block**: the static ``__shared__`` arrays the
  source declares plus the dynamic shared memory its launcher passes
  (the ``cp.async``/TMA ring's stages and the 1,024 bytes that align
  the ring for the 128-byte swizzle), read from the source and cited by
  file and line in each check's docstring; `STATIC_ALLOWANCE` bytes on
  top for what the compiler adds;
- **registers a block**: the threads a block times the most registers
  a thread may hold, which ``__launch_bounds__(threads, 1)`` caps at
  ``min(255, 65536 / threads)`` (rounded down to the 8-register
  allocation unit) and which, without launch bounds, is what a block of
  that many threads can get.

A check is ``(blocks, dims, es, budget) -> (fits, est)``: ``blocks``
the launch parameters (the JAX package's block names where the CUDA
tiles are fixed: accepted and priced at the kernel's own tiles),
``dims`` the padded dims that key the tuning table, ``es`` the operand
element size, ``budget`` the shared-memory bytes a block may use
(`budget_bytes`). ``est`` is an `Estimate`: one `Frame` a kernel, and
``fits`` holds when every frame's shared memory is within ``budget``,
its threads within the card's 1,024 a block and its threads times its
register ceiling within `core.capability.regs_budget`.

These are gating models, as in JAX: coarse, monotone in the launch
parameters, generous enough that every choice the launchers' heuristics
make passes, tight enough that a tuning-table entry past the card's
shared memory never reaches a launch. ``chip_smoke.py``'s ``tune``
phase holds every frame against ``cudaFuncGetAttributes`` and the
dynamic shared memory the launcher really passed, on the card.

Stdlib only, as in JAX: nothing here imports torch.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

from apex1_tpu_torch.core.capability import (get_capability, regs_budget,
                                             smem_budget)

#: bytes beside the declared static arrays a frame allows for what the
#: compiler adds (alignment of the static arrays)
STATIC_ALLOWANCE = 1024
#: the 128-byte-swizzled rings are aligned to 1,024 bytes inside the
#: dynamic shared memory (``csrc/gemm_wg.cuh:80``, ``flash_wg.cuh:71``)
RING_ALIGN = 1024


@dataclasses.dataclass(frozen=True)
class Frame:
    """One CUDA kernel's price: shared memory a block (static + dynamic),
    threads a block and the most registers a thread may hold."""

    kernel: str
    smem: int
    threads: int
    regs: int

    @property
    def block_regs(self) -> int:
        return self.threads * self.regs

    def fits(self, budget: int, generation: str | None = None) -> bool:
        cap = get_capability(generation)
        return (self.smem <= budget and self.threads <= cap.threads_block
                and self.regs <= cap.regs_thread
                and self.block_regs <= regs_budget(generation))

    def bounds(self, record: Mapping[str, int]) -> bool:
        """True when this frame bounds what the card reported for one
        launch: ``static_smem + dyn_smem``, ``regs`` and ``threads``
        (the keys of ``ops._build.launch_records``)."""
        return (record["threads"] == self.threads
                and record["static_smem"] + record["dyn_smem"] <= self.smem
                and record["regs"] <= self.regs
                and record["threads"] <= record["max_threads"])


class Estimate(tuple):
    """The frames of one launcher (a tuple of `Frame`); ``smem`` is the
    largest block's shared memory, ``block_regs`` the largest block's
    registers."""

    @property
    def smem(self) -> int:
        return max(f.smem for f in self)

    @property
    def block_regs(self) -> int:
        return max(f.block_regs for f in self)


def budget_bytes(generation: str | None = None) -> int:
    """``core.capability.smem_budget``: the shared memory one block may
    use, re-exported so every consumer prices against one figure."""
    return smem_budget(generation)


def reg_ceiling(threads: int) -> int:
    """The registers a thread may hold in a block of ``threads`` threads:
    ``__launch_bounds__(threads, 1)``'s cap (every kernel's bound asks
    one resident block at least), or without launch bounds what a block
    of that size can get."""
    cap = get_capability()
    per = regs_budget() // max(1, threads)
    return max(0, min(cap.regs_thread, per // 8 * 8 if per < 256 else per))


def frame(kernel: str, threads: int, *, dyn: int = 0,
          static: int = 0) -> Frame:
    return Frame(kernel, dyn + static + STATIC_ALLOWANCE, threads,
                 reg_ceiling(threads))


def _estimate(frames, budget: int):
    est = Estimate(frames)
    return all(f.fits(budget) for f in est), est


def wg_gemm_smem(bn: int, stages: int, nb: int = 1) -> int:
    """``wg::Gemm<T, BN, STAGES, ., ., NB>::SMEM`` (``csrc/gemm_wg.cuh:
    75-80``): a ring of STAGES stages, each a 128 x 64 A tile and NB
    64 x BN B tiles of 2-byte elements, and the 1,024-byte alignment."""
    return RING_ALIGN + stages * (128 * 64 * 2 + nb * bn * 64 * 2)


def mma_gemm_smem(bm: int, bn: int, nacc: int, a_kc: bool,
                  b_kc: bool) -> int:
    """``Gemm<float, BM, BN, NACC, A_KC, B_KC>::SMEM`` (``csrc/mma.cuh:
    66-78``): three stages of a 16-deep fp32 A tile and NACC B tiles, each
    row padded by 4 floats."""
    bk, epv = 16, 4
    a_r, a_c = (bm, bk) if a_kc else (bk, bm)
    b_r, b_c = (bn, bk) if b_kc else (bk, bn)
    stage = a_r * (a_c + epv) + nacc * b_r * (b_c + epv)
    return 3 * stage * 4


# ---------------------------------------------------------------------------
# flash attention (rows 3-6, 26)
# ---------------------------------------------------------------------------


def _flash_dp(dims) -> int:
    d = int(dims["Dp"])
    return 64 if d <= 64 else 128 if d <= 128 else 0


def _wg_geom(dp: int) -> dict:
    """``WgGeom<DP>`` (``csrc/flash_wg.cuh:57-92``)."""
    stages = 3 if dp == 64 else 2
    f_q = f_kv = 64 * dp * 2
    f_bias = 64 * (64 + 8) * 4
    fwd = RING_ALIGN + f_q + stages * 2 * f_kv + stages * 64 * 4
    b_q = b_kv = 64 * dp * 2
    b_bias = 64 * (64 + 4) * 4
    dkv = (RING_ALIGN + 2 * b_kv + stages * 2 * b_q
           + stages * 5 * 64 * 4)
    db_stage = -(-(4 * f_q + 5 * 64 * 4) // 1024) * 1024
    return {"fwd": fwd + stages * f_bias,
            "dq": fwd + f_q + stages * f_bias,
            "dkv": dkv + stages * b_bias,
            "dbias": RING_ALIGN + 3 * db_stage}


def _f32_flash_geom(dp: int) -> dict:
    """``Geom<float, DP>`` (``csrc/flash_attn.cuh:23-42``): 32-row tiles,
    operand rows padded by 16 bytes, every region 128-byte aligned."""
    def a128(n):
        return -(-n // 128) * 128
    bt = 32
    op = a128(bt * (dp + 4) * 4)
    sf = a128(bt * (bt + 4) * 4)
    acc = a128(bt * (dp + 4) * 4)
    row = a128(bt * 4)
    return {"fwd": 3 * op + sf + acc + row, "dq": 4 * op + 2 * sf + acc + row,
            "dkv": 4 * op + 2 * sf + 2 * acc + row,
            "dbias": 4 * op + 2 * sf + row}


def flash_check(blocks, dims, es, budget):
    """Flash attention's four kernels (rows 3-6). ``block_q``/``block_k``
    are the TPU's tiles and price nothing: the CUDA tiles are fixed. Half
    types run ``csrc/flash_wg.cuh`` (a warpgroup of 128 threads a block,
    ``__launch_bounds__(128)``, :260, :428, :671, :822): the forward's Q
    tile and STAGES K/V stages with their key segments, dq's with dO
    beside Q, dk/dv's K and V with STAGES Q/dO stages and five row
    statistics a stage, dbias's three sweep stages; each with the fp32
    bias tiles where a bias rides (the launcher's ``most``, :1044-1052).
    fp32 runs ``csrc/flash_attn.cuh`` (128 threads, :226-:583) on its
    ``Geom`` (:23-42). The head dim pads to 64 or 128; past 128 nothing
    launches."""
    dp = _flash_dp(dims)
    if not dp:
        return False, Estimate((Frame("flash", 1 << 30, 128, 255),))
    geom = _wg_geom(dp) if es <= 2 else _f32_flash_geom(dp)
    return _estimate([frame(f"flash_{k}", 128, dyn=v)
                      for k, v in geom.items()], budget)


def agf_check(blocks, dims, es, budget):
    """The all-gather flash step (row 26): flash's forward with the merge
    epilogue (``flash_fwd_wg_kernel<T, DP, false, true>``, the same frame
    as the forward: the carried fp32 (out, lse) stay in device memory and
    registers, ``csrc/flash_wg.cuh:260``)."""
    ok, est = flash_check(blocks, dims, es, budget)
    est = Estimate(f for f in est if f.kernel == "flash_fwd") or est
    return all(f.fits(budget) for f in est) and ok, est


# ---------------------------------------------------------------------------
# the row kernels (rows 1-2, 12, 14-19)
# ---------------------------------------------------------------------------


def layer_norm_check(blocks, dims, es, budget):
    """The norm forward (``csrc/layer_norm.cu:101, :163``: a warp a row,
    4 rows a block, no shared memory) and backward
    (``csrc/layer_norm_bwd.cu``): the register kernel (:114, 4 warps)
    keeps the partials of its GPB = 4 / RW row groups, two (dγ, dβ) for
    LN, as ``4 · GPB · 2 · H`` bytes of dynamic shared memory (``reg_plan``
    :453-459) beside ``red[GPB][2][2][RW]``, with RW = 1 up to 8 chunks
    of 16 bytes a lane and 2 up to 16 (:466-476); past that the fallback's
    stats kernel (:285, 256 threads, ``red[2][8]``) and tile kernel (:345,
    64 threads); then the column pass (:416, 32·S threads for S = 8 or 32,
    ``red[32][33]``). ``block_rows`` is the TPU's and prices nothing."""
    h = int(dims["lanes"])
    nch = -(-h // (16 // es))
    rw = 1 if nch <= 32 * 8 else 2
    frames = [frame("ln_fwd", 128),
              frame("ln_bwd_stats", 256, static=2 * 8 * 4),
              frame("ln_bwd_tile", 64),
              frame("ln_bwd_cols", 256, static=32 * 33 * 4),
              frame("ln_bwd_cols", 1024, static=32 * 33 * 4)]
    if nch <= 32 * 16:
        gpb = 4 // rw
        frames.append(frame("ln_bwd_reg", 128, dyn=4 * gpb * 2 * h,
                            static=gpb * 2 * 2 * rw * 4))
    return _estimate(frames, budget)


def softmax_check(blocks, dims, es, budget):
    """The softmax forward (``csrc/softmax.cu:120``: 4 rows a block, a
    warp a row, the row in registers) and backward (:293, 8 warps a
    block); neither holds shared memory."""
    return _estimate([frame("softmax_fwd", 128), frame("softmax_bwd", 256)],
                     budget)


def rope_check(blocks, dims, es, budget):
    """RoPE (``csrc/rope.cu:60``, 256 threads, no shared memory)."""
    return _estimate([frame("rope", 256)], budget)


def xentropy_check(blocks, dims, es, budget):
    """The cross-entropy forward and backward (``csrc/xentropy.cu:159,
    :289``: a block of 256 threads a row; the forward's ``red[3][8]``
    floats, :201)."""
    return _estimate([frame("xent_fwd", 256, static=3 * 8 * 4),
                      frame("xent_bwd", 256)], budget)


def bda_check(blocks, dims, es, budget):
    """Bias-dropout-add (``csrc/bias_dropout_add.cu``): the forward and
    the backward without dbias (:63, :93, 256 threads, no shared memory);
    with dbias the rows kernel (:121) sums a run of rows' dbias into
    ``h`` floats of dynamic shared memory (:211, refused past 48 KB) and
    the column kernel (:218, 256 threads) folds the runs."""
    h = int(dims["lanes"])
    return _estimate([frame("bda_fwd", 256), frame("bda_bwd", 256),
                      frame("bda_bwd_rows", 256, dyn=4 * h),
                      frame("bda_dbias", 256)], budget)


# ---------------------------------------------------------------------------
# the tiled products (rows 7-11, 13, 20, 24-25, 27)
# ---------------------------------------------------------------------------


def linear_xent_check(blocks, dims, es, budget):
    """The fused LM head (rows 7-11). Half types: the forward
    (``csrc/linear_xent_fwd.cu:144``, 256 threads,
    ``__launch_bounds__(256, 1)``) on ``wg::Gemm<T, 256, 4>`` (:71, :216)
    with its rows' labels ``s_lab[128]`` (:154), and the fold kernel
    (:184, 128 threads); the backward's G, dx and dW products
    (``csrc/linear_xent_bwd.cu:77, :133, :165``) on the same ring (:43,
    :194). fp32 (``csrc/linear_xent.cu``): the resident kernels (:240,
    :306, 256 threads, ``Geo::smem(hp)``, :92) up to H 768, else the wide
    path's products on ``mma.cuh`` 128 x 128 tiles (:589, :705, :739) and
    the merge (128 threads). ``block_t``/``block_v`` are the TPU's."""
    hp = int(dims["Hp"])
    if es <= 2:
        ring = wg_gemm_smem(256, 4)
        frames = [frame("lxent_fwd", 256, dyn=ring, static=128 * 4),
                  frame("lxent_fold", 128),
                  frame("lxent_bwd", 256, dyn=ring)]
    else:
        def a128(n):
            return -(-n // 128) * 128

        def geo(h, bwd):
            ld = h + 4
            return (2 * a128(32 * ld * 4) + a128(32 * 36 * 4)
                    + (a128(32 * 36 * 4) if bwd else 0) + a128(3 * 32 * 4))
        frames = [frame("lxent_fwd", 256, dyn=geo(min(hp, 768), False)),
                  frame("lxent_bwd", 256, dyn=geo(min(hp, 768), True)),
                  frame("lxent_wide_scores", 256, dyn=max(
                      mma_gemm_smem(128, 128, 1, True, True),
                      128 * 132 * 4)),
                  frame("lxent_wide_dx", 256,
                        dyn=mma_gemm_smem(128, 128, 1, True, False)),
                  frame("lxent_wide_dw", 256,
                        dyn=mma_gemm_smem(128, 128, 1, False, False)),
                  frame("lxent_wide_merge", 128)]
    return _estimate(frames, budget)


def cm_check(blocks, dims, es, budget):
    """The chunk product (rows 24-25, 27; ``csrc/chunk_matmul.cu``):
    half types on ``wg::Gemm<T, BN, 4, false, true>`` (:87, 256 threads,
    ``__launch_bounds__(256, 1)``) with ``block_n`` = BN of 128 or 256
    and ``block_m`` = 128; fp32 on ``Gemm<float, BM, BN, 1, true,
    false>`` (:127) at 128 x 128, 128 x 64 or 64 x 64. ``Kp`` runs through
    the ring and never enters the frame."""
    bm, bn = int(blocks["block_m"]), int(blocks["block_n"])
    if es <= 2:
        if bm != 128 or bn not in (128, 256):
            return False, Estimate((frame("chunk_matmul", 256),))
        dyn = wg_gemm_smem(bn, 4)
    else:
        if (bm, bn) not in ((128, 128), (128, 64), (64, 64)):
            return False, Estimate((frame("chunk_matmul", 256),))
        dyn = mma_gemm_smem(bm, bn, 1, True, False)
    return _estimate([frame("chunk_matmul", 256, dyn=dyn)], budget)


def fused_swiglu_check(blocks, dims, es, budget):
    """The fused GLU (row 13; ``csrc/glu.cu``): half types on
    ``wg::Gemm<T, BN, STAGES, false, true, 2>`` (:76-80, 256 threads,
    ``__launch_bounds__(256, 1)``), the Wg and Wu tiles sharing each x
    tile, with ``tile_n`` = BN of 128 (4 stages) or 64 (6 stages, :71);
    fp32 on ``Gemm<float, 128, 64, 2, true, false>`` (:114), whose only
    tile is 64 columns wide."""
    bn = int(blocks["tile_n"])
    if es <= 2:
        if bn not in (64, 128):
            return False, Estimate((frame("glu", 256),))
        dyn = wg_gemm_smem(bn, 4 if bn == 128 else 6, nb=2)
    else:
        if bn != 64:
            return False, Estimate((frame("glu", 256),))
        dyn = mma_gemm_smem(128, 64, 2, True, False)
    return _estimate([frame("glu", 256, dyn=dyn)], budget)


def int8_check(blocks, dims, es, budget):
    """int8_mm (row 20; ``csrc/int8_matmul.cu``): ``I8Tile<NWG, BT>``
    (:79-97) with NWG = ``bm`` / 64 warpgroups (``__launch_bounds__(128 ·
    NWG, 1)``, :198) and BT = ``bt`` tokens: a ring of STAGES stages of a
    BT x 64 bf16 x tile and a BM x 64 int8 weight tile, the 1,024-byte
    alignment, the TMA barriers ``full[STAGES]`` (:203) and the split's
    ticket ``last`` (:363). ``splits`` and ``kc`` change the grid only:
    ``kc`` must be a multiple of the 64-deep K step."""
    bm, bt = int(blocks["bm"]), int(blocks["bt"])
    splits, kc = int(blocks["splits"]), int(blocks["kc"])
    tiles = {64: (8, 16, 32, 64, 128), 128: (128, 192, 256)}
    k = int(dims.get("K", kc * splits))
    if bt not in tiles.get(bm, ()) or not 1 <= splits <= 16 or (
            splits > 1 and (kc < 64 or kc % 64 or (splits - 1) * kc >= k)):
        return False, Estimate((frame("int8_mm", 128),))
    nwg = bm // 64
    stages = (5 if bt == 256 else 6 if bt == 192 else
              8 if nwg == 2 or bt <= 32 else 6 if bt == 64 else 5)
    dyn = RING_ALIGN + stages * (bt * 64 * 2 + bm * 64)
    return _estimate([frame("int8_mm", 128 * nwg, dyn=dyn,
                            static=8 * stages + 4)], budget)


# ---------------------------------------------------------------------------
# decode (rows 21-23)
# ---------------------------------------------------------------------------

#: ``csrc/paged_attend.cu:63-64``
PAGED_THREADS, PAGED_KEYS = 128, 64


def paged_decode_check(blocks, dims, es, budget):
    """Paged attention (row 21; ``csrc/paged_attend.cu``). ``per`` key
    blocks of 64 positions a split (and the split count ``splits`` that
    follows from it, `ops.paged_decode.paged_geometry`) change the grid
    and the fp32 workspace in device memory, never a block's frame. The
    CUDA-core kernel (:203, 128 threads) holds a ring of two (one where two
    do not fit) K/V key blocks of the row's 16-byte chunks, or the reduce
    buffer where that is larger (``core_ring_bytes``, :171), beside RT
    rows' q, scores and statistics (:682-685) for RT = 1, 4 or 16 by
    ``Rq`` = G·S; the tensor-core kernel (:436, Rq > 4, D 64 or 128) a ring
    of 4 · 64 · chunks bytes (:699) in 32-128 threads; the merge (:641,
    128 threads) none. ``es`` is the page dtype's size. A head dim past
    512 launches nothing (a row's 4-element groups exceed the 128
    threads, :713)."""
    per = int(blocks.get("per", 1))
    d, rows = int(dims["Dp"]), int(dims["Rq"])
    if per < 1 or -(-d // (16 // es)) * (16 // es) // 4 > PAGED_THREADS:
        return False, Estimate((frame("paged_attend", PAGED_THREADS),))
    vw = 16 // es
    cpr = -(-d // vw)
    dp = cpr * vw
    rt = 1 if rows <= 1 else 4 if rows <= 4 else 16

    def core(nbuf):
        ring = nbuf * 2 * PAGED_KEYS * cpr * 16
        red = (PAGED_THREADS // max(1, dp // 4)) * rt * dp * 4
        return max(ring, red)
    rest = 4 * (rt * dp + rt * PAGED_KEYS + 3 * rt)
    nbuf = 2 if core(2) + rest <= 232448 else 1
    frames = [frame("paged_core", PAGED_THREADS, dyn=core(nbuf) + rest),
              frame("paged_merge", PAGED_THREADS)]
    if rows > 4 and d in (64, 128):
        frames.append(frame("paged_mma", 32 * min(4, -(-rows // 16)),
                            dyn=4 * PAGED_KEYS * cpr * 16))
    return _estimate(frames, budget)


def fused_sample_check(blocks, dims, es, budget):
    """The sampler (row 22; ``csrc/fused_sample.cu:148``, 256 threads):
    the block's warp maxima ``wv[8]``, ``wi[8]`` (:119-120) and the
    ticket ``last`` (:199). ``splits`` changes the grid only: at least 1,
    at most a split a 4 columns of the padded vocab."""
    splits = int(blocks["splits"])
    if splits < 1 or splits > max(1, int(dims["Vp"]) // 4):
        return False, Estimate((frame("fused_sample", 256),))
    return _estimate([frame("fused_sample", 256, static=8 * 4 * 2 + 4)],
                     budget)


def lora_epilogue_check(blocks, dims, es, budget):
    """The LoRA delta (row 23; ``csrc/lora_delta.cu``): the coefficient
    kernel (:71, 4 warps) and the stream kernel (:113, 128 threads),
    whose ``rows`` rows a block keep their rank's coefficients and page
    ids, ``rows · R · 8`` bytes of dynamic shared memory (:188); ``R``
    (the rank, from ``dims`` where given, else 1) is a grid length in
    the TPU kernel but a block's size here."""
    rows, rank = int(blocks["rows"]), int(dims.get("R", 1))
    if rows < 1:
        return False, Estimate((frame("lora_stream", 128),))
    return _estimate([frame("lora_coef", 128),
                      frame("lora_stream", 128, dyn=rows * rank * 8)],
                     budget)


def chunked_loss_check(blocks, dims, es, budget):
    """The chunked losses (``ops/chunked_loss.py``) launch no kernel of
    their own: each chunk of ``chunk_v`` vocab rows rides the linear-xent
    kernels (rows 9-11), whose frames do not depend on the chunk. The
    chunk must be a multiple of 128 (the JAX package's lane rule, which
    the port keeps); the frame is `linear_xent_check`'s."""
    cv = int(blocks["chunk_v"])
    ok, est = linear_xent_check(blocks, dims, es, budget)
    return ok and cv >= 128 and cv % 128 == 0, est


# ---------------------------------------------------------------------------
# the RDMA reduce-scatter's device memory (row 27)
# ---------------------------------------------------------------------------


def rdma_slot_bytes(chunk: int, n_cols: int) -> int:
    """The four fp32 (chunk, N) slots of
    ``ops.fused_collective.matmul_reduce_scatter_rdma``'s NCCL ring: two
    receive slots and the two sums in flight to the downstream rank,
    ``16 · chunk · N`` bytes. They live in device memory, not in shared
    memory: the ring's transfers are NCCL's, outside the kernel, and the
    kernel reads the received fp32 ``acc_in`` from device memory."""
    return 4 * 4 * chunk * n_cols


def rdma_check(chunk: int, k: int, n_cols: int, es: int,
               budget: int) -> tuple[bool, int]:
    """The ring's device memory: `rdma_slot_bytes` beside the (chunk, K)
    x slice and the (K, N) weight in ``es`` bytes, against ``budget``
    bytes of device memory (the card's HBM less its reserve, not shared
    memory: the product's own frame is `cm_check`'s)."""
    est = rdma_slot_bytes(chunk, n_cols) + es * (chunk * k + k * n_cols)
    return est <= budget, est


#: the registry-facing name -> check table: the JAX package's 15 names
CHECKS: dict[str, object] = {
    "flash_attention": flash_check,
    "fused_softmax": softmax_check,
    "layer_norm": layer_norm_check,
    "rope": rope_check,
    "xentropy": xentropy_check,
    "bias_dropout_add": bda_check,
    "linear_xent": linear_xent_check,
    "fused_collective_matmul": cm_check,
    "fused_ag_flash": agf_check,
    "int8_matmul": int8_check,
    "paged_decode": paged_decode_check,
    "fused_sample": fused_sample_check,
    "chunked_loss": chunked_loss_check,
    "fused_swiglu": fused_swiglu_check,
    "lora_epilogue": lora_epilogue_check,
}
