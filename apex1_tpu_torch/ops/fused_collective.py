"""Fused computation-collective forms (the port of
``apex1_tpu/ops/fused_collective.py``).

- `fused_matmul_reduce_scatter` / `fused_all_gather_matmul`: the
  sequence-parallel boundary matmuls over `mappings`' rings (the same
  hops, the same travelling-accumulator add order) with each chunk
  product in the hand-written kernel `chunk_matmul`
  (``csrc/chunk_matmul.cu``, TPU rows 24-25). On the CPU the kernel's
  plain version is the decomposed forms' own product, so the fused and
  decomposed forms agree bit for bit there. Each one's backward is its
  dual's ring, as in JAX.
- `fused_all_gather_matmul_serial`: the hop-then-multiply schedule,
  every hop exposed (the A/B floor); the same numbers.
- `all_gather_flash_attention`: ring attention whose per-step merge of
  the partial output rides the flash forward kernel's epilogue
  (`ops.attention.flash_fwd_merge`, TPU row 26) instead of a separate
  read-modify-write of the (B, H, S, D) output; the backward is
  `parallel.ring_attention`'s ring. No dropout (a ``dropout_p`` argument
  is a TypeError, as in JAX).
- `fused_vocab_parallel_merge`: the vocab-parallel cross-entropy's
  cross-shard merge of packed (T, 4) statistics in two all-reduces (one
  MAX, one SUM of a (T, 3) pack) where the decomposed merge takes four.
- `matmul_reduce_scatter_rdma`: the TPU's one-kernel matmul →
  reduce-scatter with in-kernel remote DMA (row 27). On Hopper the
  remote copies are NCCL's: each ring step's `chunk_matmul` adds the
  upstream accumulator in its epilogue (``acc_in``) and the sum goes
  downstream by ``isend`` on a side stream into one of two fp32 receive
  slots. Its numbers equal `fused_matmul_reduce_scatter`'s bit for bit.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.distributed as dist

from apex1_tpu_torch import tuning
from apex1_tpu_torch.ops import _build
from apex1_tpu_torch.ops._common import (DTYPE_CODES, NEG_INF, check_cuda,
                                         use_kernel)
from apex1_tpu_torch.ops.attention import flash_fwd_merge, merge_partials
from apex1_tpu_torch.transformer.tensor_parallel import mappings as mp

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


# ---- the chunk product (TPU rows 24-25, and row 27's product) -----------


def _plain_chunk_matmul(rows, w, acc):
    out = torch.matmul(rows.float(), w.float())
    return out if acc is None else acc + out


def chunk_plan(K: int, dtype: torch.dtype, tile=None) -> int:
    """The tile `chunk_matmul` asks of the library, as rows·1000 +
    columns: ``tile`` ((block_m, block_n), what the sweep passes) > the
    tuning table's ``fused_collective_matmul`` entry for the padded K >
    0, which leaves the library's ``tile_of`` choice (`chunk_tile`)."""
    got, _src = tuning.resolve(
        "fused_collective_matmul", None if tile is None else
        {"block_m": tile[0], "block_n": tile[1]},
        lambda: {"Kp": tuning.padded_lanes(K)}, dtype,
        lambda: {"block_m": 0, "block_n": 0})
    return got["block_m"] * 1000 + got["block_n"]


def chunk_matmul(rows: torch.Tensor, w: torch.Tensor,
                 acc: Optional[torch.Tensor] = None, *,
                 tile=None) -> torch.Tensor:
    """``[acc +] rows @ w`` in fp32: ``rows`` (..., K) with its leading
    dimensions kept, ``w`` (K, N), ``acc`` fp32 like the result or None.
    Operands of two types are promoted to one. CUDA tensors launch the
    kernel (``chunk_matmul.launches``; a fixed summation order, the same
    bits on every launch; `chunk_plan`'s tile); CPU tensors take the
    plain version, ``torch.matmul`` of the operands widened to fp32."""
    if rows.dtype != w.dtype:
        dt = torch.promote_types(rows.dtype, w.dtype)
        rows, w = rows.to(dt), w.to(dt)
    if w.dim() != 2 or rows.shape[-1] != w.shape[0]:
        raise ValueError(f"chunk_matmul: rows {tuple(rows.shape)} and w "
                         f"{tuple(w.shape)} do not fit")
    lead, K, N = rows.shape[:-1], w.shape[0], w.shape[1]
    if acc is not None and (acc.shape != lead + (N,)
                            or acc.dtype != torch.float32):
        raise ValueError(f"chunk_matmul: acc must be fp32 "
                         f"{tuple(lead + (N,))}, got {acc.dtype} "
                         f"{tuple(acc.shape)}")
    if not use_kernel(rows):
        return _plain_chunk_matmul(rows, w, acc)
    if rows.dtype not in _DTYPES:
        raise ValueError(f"chunk_matmul: operands must be f32/bf16/f16, "
                         f"got {rows.dtype}")
    a = rows.reshape(math.prod(lead), K).contiguous()
    b = w.contiguous()
    acc2 = None if acc is None else acc.reshape(-1, N).contiguous()
    check_cuda("chunk_matmul", a, b, acc2)
    out = torch.empty(a.shape[0], N, dtype=torch.float32, device=a.device)
    epv = 16 // a.element_size()
    vec = (K % epv == 0 and N % epv == 0 and a.data_ptr() % 16 == 0
           and b.data_ptr() % 16 == 0)
    _build.launch("apex1_chunk_matmul", a.data_ptr(), b.data_ptr(),
                  None if acc2 is None else acc2.data_ptr(), out.data_ptr(),
                  a.shape[0], N, K, int(vec), DTYPE_CODES[a.dtype],
                  chunk_plan(K, a.dtype, tile),
                  torch.cuda.current_stream(a.device).cuda_stream)
    chunk_matmul.launches += 1
    return out.reshape(lead + (N,))


chunk_matmul.launches = 0


def chunk_tile(M: int, N: int, dtype: torch.dtype) -> tuple:
    """The output tile (rows, columns) the kernel launches for an
    ``M x N`` product with operands of ``dtype`` (it needs the built
    library, so the card)."""
    t = _build.library().apex1_chunk_matmul_tile(M, N, DTYPE_CODES[dtype])
    return t // 1000, t % 1000


def _chunk_matmul(rows, w, block_m=None, block_n=None):
    """The JAX package's entry: ``rows @ w`` in fp32. ``block_m`` and
    ``block_n`` are the TPU kernel's tile sizes: accepted and ignored
    (the Hopper kernel picks its own tile)."""
    del block_m, block_n
    return chunk_matmul(rows, w)


# ---- fused SP matmuls ---------------------------------------------------


def fused_matmul_reduce_scatter(x, w, group=None, seq_dim: int = 0,
                                block_m=None, block_n=None):
    """``reduce_scatter(x @ w, seq_dim)`` over `mappings`' travelling-
    accumulator ring with each chunk product in `chunk_matmul`: this
    rank's sequence chunk, fp32. Equal to `mappings.matmul_reduce_scatter`
    bit for bit wherever the kernel's product is (the CPU); the
    backward routes dx through `fused_all_gather_matmul`'s ring."""
    del block_m, block_n
    return mp._MatmulReduceScatter.apply(x, w, mp._group(group), seq_dim,
                                         chunk_matmul)


def fused_all_gather_matmul(x, w, group=None, seq_dim: int = 0,
                            block_m=None, block_n=None):
    """``all_gather(x, seq_dim) @ w`` over `mappings`' overlapped ring
    with each chunk product in `chunk_matmul`, fp32; the backward routes
    dx through `fused_matmul_reduce_scatter`'s ring."""
    del block_m, block_n
    return mp._AllGatherMatmul.apply(x, w, mp._group(group), seq_dim,
                                     chunk_matmul)


def fused_all_gather_matmul_serial(x, w, group=None, seq_dim: int = 0,
                                   block_m=None, block_n=None):
    """The serialized rotate-then-multiply all-gather matmul: each chunk
    product waits on the hop that brought its chunk, so all n - 1 hops
    are exposed. The negative control and A/B floor; forward only, the
    same numbers as the overlapped form."""
    del block_m, block_n
    with torch.no_grad():
        return mp._agm_loop(x, w, mp._group(group), seq_dim, chunk_matmul,
                            serialize=True)


# ---- all-gather flash attention (TPU row 26) ----------------------------


def all_gather_flash_attention(q, k, v, group, *, causal: bool = False,
                               sm_scale: Optional[float] = None,
                               segment_ids=None, block_q=None, block_k=None):
    """Ring (context-parallel) flash attention with the per-step merge in
    the flash kernel's epilogue. ``q`` (B, Hq, S_local, D) and ``k``/``v``
    (B, Hkv, S_local, D) are this rank's sequence shards over ``group``
    (e.g. `parallel_state.get_context_parallel_group()`), the global
    sequence laid out in group order; ``segment_ids`` the local
    (B, S_local) shard. Each step's K/V hop is posted before the step's
    attend; a causal step whose shard lies wholly in the future merges a
    (zeros, NEG_INF) partial without a launch, as the decomposed ring
    does. Returns the local output shard; differentiable through
    `ring_attention`'s ring backward. ``block_q``/``block_k`` are
    accepted and ignored."""
    from apex1_tpu_torch.parallel.ring_attention import _ring_apply
    del block_q, block_k
    return _ring_apply(q, k, v, group, causal=causal, sm_scale=sm_scale,
                       segment_ids=segment_ids, fused=True)


def agf_attend(q, qseg, scale, causal):
    """The fused ring's step: ``(k, v, kseg, q_off, k_off, out, lse) ->
    (out, lse)``, one `flash_fwd_merge` launch, or the plain merge of a
    (zeros, NEG_INF) partial where a causal shard is wholly masked."""
    Sq = q.shape[2]

    def attend(k_cur, v_cur, kseg_cur, q_off, k_off, out, lse):
        if causal and k_off > q_off + Sq - 1:
            return merge_partials(out, lse, torch.zeros_like(q),
                                  torch.full_like(lse, NEG_INF))
        return flash_fwd_merge(q, k_cur, v_cur, qseg, kseg_cur, scale,
                               causal, q_off, k_off, out, lse)

    return attend


# ---- the vocab-parallel merge -------------------------------------------


def fused_vocab_parallel_merge(stats: torch.Tensor, group=None):
    """The cross-shard merge of packed per-shard statistics (T, 4)
    ``[m, l, tgt, sumx]`` (`ops.linear_xent.shard_stats_packed`): one MAX
    all-reduce for the global max, one SUM all-reduce of the (T, 3) pack
    ``[l·exp(m - gmax), tgt, sumx]``. Returns (lse, tgt, sumx), each
    (T,) fp32."""
    group = mp._group(group)
    m = stats[:, 0]
    gmax = mp.all_reduce(m, group, dist.ReduceOp.MAX)
    packed = torch.stack([stats[:, 1] * torch.exp(m - gmax),
                          stats[:, 2], stats[:, 3]], dim=-1)
    red = mp.all_reduce(packed, group)
    return gmax + torch.log(red[:, 0]), red[:, 1], red[:, 2]


# ---- matmul -> reduce-scatter with the ring outside the kernel (row 27) --


def matmul_reduce_scatter_rdma(x: torch.Tensor, w: torch.Tensor,
                               group=None) -> torch.Tensor:
    """``reduce_scatter(x @ w, 0)`` by the TPU kernel's protocol: ``x``
    (S, K) 2-D, ``S`` a multiple of the ring size n >= 2; returns this
    rank's fp32 (S/n, N) chunk. Step t computes chunk (i - 1 - t) mod n
    through `chunk_matmul` with ``acc`` the accumulator received in step
    t - 1 (none at t = 0) and, before the last step, sends the sum
    downstream while receiving the upstream's into one of two fp32
    slots (on CUDA from a side stream); a slot's previous receive and
    send are waited on before it is reused, as the TPU kernel's credit
    semaphore orders them. The last step's sum is the result. Forward
    only. The same partials in the same order as
    `fused_matmul_reduce_scatter`, so the same bits."""
    if x.dim() != 2:
        raise ValueError(f"x must be (S, K), got {tuple(x.shape)}")
    group = mp._group(group)
    n = dist.get_world_size(group)
    if n < 2:
        raise ValueError("matmul_reduce_scatter_rdma needs a ring of >= 2 "
                         "devices; use fused_matmul_reduce_scatter for the "
                         "single-device case")
    S = x.shape[0]
    if S % n:
        raise ValueError(f"S={S} not divisible by ring size {n}")
    chunk, idx = S // n, dist.get_rank(group)
    ranks = dist.get_process_group_ranks(group)
    dst, src = ranks[(idx + 1) % n], ranks[(idx - 1) % n]
    comm = torch.cuda.Stream(x.device) if x.is_cuda else None
    slots = [torch.empty(chunk, w.shape[1], dtype=torch.float32,
                         device=x.device) for _ in range(2)]
    # per slot: the step's posted send and receive, and the sent tensor,
    # kept alive until its send is waited on
    works, sent = [[], []], [None, None]

    def drain(s):
        for wk in works[s]:
            wk.wait()
        works[s], sent[s] = [], None

    acc = None
    with torch.no_grad():
        for t in range(n):
            if t > 0:
                drain((t - 1) % 2)   # the upstream accumulator has landed
                acc = slots[(t - 1) % 2]
            c = (idx - 1 - t) % n
            ship = chunk_matmul(x[c * chunk:(c + 1) * chunk], w, acc)
            if t == n - 1:
                break
            s = t % 2
            drain(s)   # the slot's send of step t - 2 has left
            ctx = contextlib.nullcontext()
            if comm is not None:
                # the side stream starts after this step's product (and
                # the last read of the slot) on the compute stream
                comm.wait_stream(torch.cuda.current_stream(x.device))
                ctx = torch.cuda.stream(comm)
            with ctx:
                works[s] = dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, ship, dst, group),
                    dist.P2POp(dist.irecv, slots[s], src, group)])
            sent[s] = ship
            mp.COLLECTIVES["send_recv"] += 1
        drain(0)
        drain(1)
    return ship
