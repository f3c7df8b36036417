// LayerNorm / RMSNorm backward for Hopper (sm_90a).
//
// Replaces: apex1_tpu/ops/layer_norm.py::_bwd_kernel (launched by
// _pallas_bwd), the Pallas TPU kernel that writes dx for a (rows, H)
// block from the saved fp32 mean/rstd and accumulates dgamma/dbeta into
// one output block across the sequential grid.
//
//   dx = (w - c2 - xhat * c1) * rstd   (RMS: c2 = 0, xhat = x * rstd)
//   w = dy * gamma, c1 = mean(xhat * w), c2 = mean(w)
//   dgamma = sum_rows dy * xhat, dbeta = sum_rows dy
//
// Bound on the H100: memory. x and dy are read and dx written once,
// about a dozen flops per element (far below the ~20 flops per byte at
// which the fp32 CUDA cores would become the limit). At GPT-2's training
// shape (16384 x 768 bf16) that is ~75 MB, ~23 us at 3.35 TB/s; at the
// Llama step's (8192 x 4096 bf16) ~201 MB, ~60 us.
//
// Design. Hopper blocks run in no order, so the TPU kernel's running
// dgamma/dbeta sum over a sequential grid becomes two passes, with no
// atomics, so the result is the same bits on every run:
//   1. The rows pass. A row group holds a row, and each group walks a
//      fixed run of rows (row g, g + S, ... for S groups in all): a warp
//      up to 8 chunks a lane (H 2048 in bf16/fp16, 1024 in fp32), two
//      warps past that up to 16 (H 4096, 2048), four warps a block. (A
//      warp a row at H 4096 needs 178 registers a lane, so an SM holds
//      eight warps, each with a long stretch of arithmetic between its
//      rows' loads; two warps a row halve both.)
//      Thread t of the group holds the row's 16-byte chunks t, t + 32·RW,
//      ... of x and dy in registers (VPL of them, a template on H's
//      range), every load of the row issued before any arithmetic, so
//      each element of x and dy is read from device memory once. gamma
//      is read in its own dtype (fp32, or x's half type under the amp
//      policies' compute params) in 16-byte pieces and widened in
//      registers (it stays in L1 across the rows). sum(xhat * w) and
//      sum(w) over the thread's chunks in order, then a butterfly over
//      the warp and, for two warps, the two in order through shared
//      memory (every thread ends with the same bits), and dx is written
//      from the registers in 16-byte stores. The thread's dgamma/dbeta
//      partials for its own columns live in registers where they and x,
//      dy take at most 96 a thread (GPT-2's, BERT's and T5's widths),
//      else in the group's slice of shared memory (the Llama step's H
//      4096), laid out so a warp's 16-byte accesses are consecutive. At
//      the end of its run each block adds its groups' partials in order
//      and writes one fp32 row of dgamma (and one of dbeta) to the (NP,
//      G, H) workspace. G fills the SMs at the kernel's occupancy and
//      keeps the workspace under 10 % of x + dy + dx's bytes.
//   2. The column pass. A block takes 32 columns with 32 slices of the
//      G partial rows (8 where G <= 64): each thread sums its slice's
//      rows in order, then a warp sums a column's slices by butterfly,
//      a fixed tree. dgamma (and dbeta) are written in gamma's dtype, as
//      the JAX package casts them. It is launched as a programmatic
//      dependent of the rows pass, so its launch overlaps that pass's
//      end.
// Rows that do not take the register path (H past 16 chunks a thread,
// H not a multiple of a chunk, a pointer not 16-byte aligned) take two
// kernels, by 16-byte chunks where aligned, else value by value: a block
// a row sums c1 and c2 into the workspace, then a thread takes a chunk
// (or a column) of G runs of rows, writing dx and its dgamma/dbeta sums
// to the workspace row of its run (runs of 4 rows or more, the workspace
// up to 4 MB where 10 % is less: it stays in L2, and a few wide rows
// still spread over the SMs). x and dy are read twice, no shared memory
// grows with H, and every width the JAX package takes runs here.

#include <algorithm>
#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

#include "chunks.cuh"

namespace {

constexpr int kWarps = 4;          // warps a block in the rows pass
constexpr int kStatThreads = 256;  // the fallback's stats: a row a block
constexpr int kTileThreads = 64;   // the fallback's tiles: chunks a block

struct BwdArgs {
  const void* x;
  const void* gamma;
  const float* mean;
  const float* rstd;
  const void* dy;
  void* dx;
  float* part;   // (NP, groups, h) fp32
  float* stats;  // the fallback's (2, rows) fp32: c1, c2 of each row
  int rows, h, groups;  // groups: set by launch_rows
};

// the shared-memory slot of value i of chunk c: float4 piece j = i / 4
// of every chunk of the row side by side, so the 32 lanes' 16-byte
// accesses to one piece are consecutive
__device__ __forceinline__ int slot(int c, int i, int nch) {
  return ((i / 4) * nch + c) * 4 + i % 4;
}

// xhat, w and dx of one element, op for op as the plain version (no
// contraction into an fma): at H = 1 an RMS row's dx is a cancellation,
// w - xhat * c1 with xhat^2 near 1, that any other rounding changes
__device__ __forceinline__ float xhat_of(float x, float mu, float rs) {
  return __fmul_rn(__fsub_rn(x, mu), rs);
}

template <bool RMS>
__device__ __forceinline__ float dx_of(float xh, float w, float c1,
                                       float c2, float rs) {
  const float t = __fmul_rn(xh, c1);
  return __fmul_rn(RMS ? __fsub_rn(w, t) : __fsub_rn(__fsub_rn(w, c2), t),
                   rs);
}

// the register path: RW warps hold a row, VPL chunks a lane
template <typename T, typename G, int VPL, bool RMS, int RW>
__global__ void __launch_bounds__(kWarps * 32)
    ln_bwd_reg_kernel(const BwdArgs a) {
  static_assert(kWarps % RW == 0, "whole row groups a block");
  constexpr int N = Chunk<T>::N;
  constexpr int NP = RMS ? 1 : 2;  // dgamma (and dbeta) partials
  constexpr int GT = 32 * RW;      // threads a row group
  constexpr int GPB = kWarps / RW;  // row groups a block
  // partials in registers where they and x, dy fit in 96 a lane
  constexpr bool PREG = VPL * N * NP + 8 * VPL <= 96;
  using Pc = Pieces<G, N>;
  extern __shared__ float4 smem4[];  // [GPB][NP][h] partials
  __shared__ float red[GPB][2][2][RW];  // a row's sums by warp, by parity
  float* sm = reinterpret_cast<float*>(smem4);
  const int t = threadIdx.x % GT, grp = threadIdx.x / GT;
  const int lane = threadIdx.x % 32, gw = t / 32;  // warp in the group
  const int h = a.h, nch = h / N;
  float* wp = sm + grp * NP * h;  // this group's slice
  float pg[PREG ? VPL : 1][N], pb[PREG && !RMS ? VPL : 1][N];
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int c = k * GT + t;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if constexpr (PREG) {
        pg[k][i] = 0.f;
        if constexpr (!RMS) pb[k][i] = 0.f;
      } else if (c < nch) {
#pragma unroll
        for (int p = 0; p < NP; ++p) wp[p * h + slot(c, i, nch)] = 0.f;
      }
    }
  }
  const G* gamma = static_cast<const G*>(a.gamma);
  const float inv_h = 1.f / static_cast<float>(h);
  const int stride = gridDim.x * GPB;
  int parity = 0;
  for (int row = blockIdx.x * GPB + grp; row < a.rows; row += stride) {
    const uint4* xr =
        static_cast<const uint4*>(a.x) + static_cast<size_t>(row) * nch;
    const uint4* dyr =
        static_cast<const uint4*>(a.dy) + static_cast<size_t>(row) * nch;
    uint4 rx[VPL], rd[VPL];
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int c = k * GT + t;
      rx[k] = c < nch ? xr[c] : make_uint4(0, 0, 0, 0);
      rd[k] = c < nch ? dyr[c] : make_uint4(0, 0, 0, 0);
    }
    const float mu = RMS ? 0.f : a.mean[row];
    const float rs = a.rstd[row];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int c = k * GT + t;
      if (c < nch) {
        float xv[N], dv[N], gv[N];
        Chunk<T>::widen(rx[k], xv);
        Chunk<T>::widen(rd[k], dv);
        uint4 gr[Pc::P];
        Pc::load(gamma + c * N, gr);
        Pc::widen(gr, gv);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float xh = xhat_of(xv[i], mu, rs);
          const float w = __fmul_rn(dv[i], gv[i]);
          s1 += xh * w;
          s2 += w;
          if constexpr (PREG) {
            pg[k][i] += dv[i] * xh;
            if constexpr (!RMS) pb[k][i] += dv[i];
          } else {
            xv[i] = dv[i] * xh;  // this row's dgamma term
          }
        }
        if constexpr (!PREG) {
#pragma unroll
          for (int j = 0; j < N / 4; ++j) {
            float4* sg = reinterpret_cast<float4*>(wp + slot(c, 4 * j, nch));
            float4 u = *sg;
            u.x += xv[4 * j];
            u.y += xv[4 * j + 1];
            u.z += xv[4 * j + 2];
            u.w += xv[4 * j + 3];
            *sg = u;
            if constexpr (!RMS) {
              float4* sb = reinterpret_cast<float4*>(
                  wp + h + slot(c, 4 * j, nch));
              float4 v = *sb;
              v.x += dv[4 * j];
              v.y += dv[4 * j + 1];
              v.z += dv[4 * j + 2];
              v.w += dv[4 * j + 3];
              *sb = v;
            }
          }
        }
      }
    }
    s1 = warp_sum(s1);
    if constexpr (!RMS) s2 = warp_sum(s2);
    if constexpr (RW > 1) {
      // the group's warps in order (every thread the same bits); the
      // sums alternate between two buffers, so one barrier a row will do
      if (lane == 0) {
        red[grp][parity][0][gw] = s1;
        red[grp][parity][1][gw] = s2;
      }
      asm volatile("bar.sync %0, %1;" ::"r"(1 + grp), "r"(GT) : "memory");
      s1 = s2 = 0.f;
#pragma unroll
      for (int w = 0; w < RW; ++w) {
        s1 += red[grp][parity][0][w];
        s2 += red[grp][parity][1][w];
      }
      parity ^= 1;
    }
    const float c1 = s1 * inv_h;
    const float c2 = RMS ? 0.f : s2 * inv_h;
    uint4* dxr = static_cast<uint4*>(a.dx) + static_cast<size_t>(row) * nch;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int c = k * GT + t;
      if (c < nch) {
        float xv[N], dv[N], gv[N];
        Chunk<T>::widen(rx[k], xv);
        Chunk<T>::widen(rd[k], dv);
        uint4 gr[Pc::P];
        Pc::load(gamma + c * N, gr);
        Pc::widen(gr, gv);
#pragma unroll
        for (int i = 0; i < N; ++i)
          xv[i] = dx_of<RMS>(xhat_of(xv[i], mu, rs),
                             __fmul_rn(dv[i], gv[i]), c1, c2, rs);
        dxr[c] = Chunk<T>::narrow(xv);
      }
    }
  }
  let_next_start();
  if constexpr (PREG) {
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int c = k * GT + t;
      if (c < nch) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
          wp[slot(c, i, nch)] = pg[k][i];
          if constexpr (!RMS) wp[h + slot(c, i, nch)] = pb[k][i];
        }
      }
    }
  }
  __syncthreads();
  // the block's partials: its row groups added in order, a column a
  // thread
  for (int p = 0; p < NP; ++p) {
    float* out = a.part + (static_cast<size_t>(p) * a.groups + blockIdx.x) *
                              static_cast<size_t>(h);
    for (int col = threadIdx.x; col < h; col += blockDim.x) {
      const int at = p * h + slot(col / N, col % N, nch);
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < GPB; ++g) s += sm[g * NP * h + at];
      out[col] = s;
    }
  }
}

// the fallback, first kernel: c1 and c2 of each row (a block a row, by
// 16-byte chunks (VEC) or value by value) into stats[row], stats[rows +
// row]
template <typename T, typename G, bool RMS, bool VEC>
__global__ void __launch_bounds__(kStatThreads)
    ln_bwd_stats_kernel(const BwdArgs a) {
  constexpr int N = Chunk<T>::N;
  constexpr int M = VEC ? N : 1;  // values a step
  using Pc = Pieces<G, N>;
  __shared__ float red[2][kStatThreads / 32];
  let_next_start();
  const int row = blockIdx.x, h = a.h;
  const T* xr = static_cast<const T*>(a.x) + static_cast<size_t>(row) * h;
  const T* dyr = static_cast<const T*>(a.dy) + static_cast<size_t>(row) * h;
  const G* gamma = static_cast<const G*>(a.gamma);
  const float mu = RMS ? 0.f : a.mean[row];
  const float rs = a.rstd[row];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
  for (int u = threadIdx.x; u < h / M; u += kStatThreads) {
    float xv[M], dv[M], gv[M];
    if constexpr (VEC) {
      Chunk<T>::widen(reinterpret_cast<const uint4*>(xr)[u], xv);
      Chunk<T>::widen(reinterpret_cast<const uint4*>(dyr)[u], dv);
      uint4 gr[Pc::P];
      Pc::load(gamma + u * N, gr);
      Pc::widen(gr, gv);
    } else {
      xv[0] = to_f32(xr[u]);
      dv[0] = to_f32(dyr[u]);
      gv[0] = to_f32(gamma[u]);
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const float w = __fmul_rn(dv[i], gv[i]);
      s1 += xhat_of(xv[i], mu, rs) * w;
      s2 += w;
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (threadIdx.x % 32 == 0) {
    red[0][threadIdx.x / 32] = s1;
    red[1][threadIdx.x / 32] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    s1 = s2 = 0.f;
#pragma unroll
    for (int w = 0; w < kStatThreads / 32; ++w) {
      s1 += red[0][w];
      s2 += red[1][w];
    }
    const float inv_h = 1.f / static_cast<float>(h);
    a.stats[row] = s1 * inv_h;
    a.stats[a.rows + row] = RMS ? 0.f : s2 * inv_h;
  }
}

// the fallback, second kernel: block (x, g) takes kTileThreads chunks
// (VEC) or columns of run g of the rows, a thread's own across the run:
// it writes their dx and its sums to part row g (no shared memory, so
// every width runs)
template <typename T, typename G, bool RMS, bool VEC>
__global__ void __launch_bounds__(kTileThreads)
    ln_bwd_tile_kernel(const BwdArgs a) {
  constexpr int N = Chunk<T>::N;
  constexpr int M = VEC ? N : 1;  // values a thread
  using Pc = Pieces<G, N>;
  const int u = blockIdx.x * kTileThreads + threadIdx.x;
  const int h = a.h;
  if (u >= h / M) return;
  const int run = (a.rows + a.groups - 1) / a.groups;
  const int r0 = blockIdx.y * run;
  const int r1 = min(r0 + run, a.rows);
  const G* gamma = static_cast<const G*>(a.gamma);
  float gv[M], pg[M], pb[M];
  if constexpr (VEC) {
    uint4 gr[Pc::P];
    Pc::load(gamma + u * N, gr);
    Pc::widen(gr, gv);
  } else {
    gv[0] = to_f32(gamma[u]);
  }
#pragma unroll
  for (int i = 0; i < M; ++i) pg[i] = pb[i] = 0.f;
  wait_prior();  // the row sums
#pragma unroll 4
  for (int r = r0; r < r1; ++r) {
    const size_t at = static_cast<size_t>(r) * (h / M) + u;
    float xv[M], dv[M];
    if constexpr (VEC) {
      Chunk<T>::widen(static_cast<const uint4*>(a.x)[at], xv);
      Chunk<T>::widen(static_cast<const uint4*>(a.dy)[at], dv);
    } else {
      xv[0] = to_f32(static_cast<const T*>(a.x)[at]);
      dv[0] = to_f32(static_cast<const T*>(a.dy)[at]);
    }
    const float mu = RMS ? 0.f : a.mean[r];
    const float rs = a.rstd[r];
    const float c1 = a.stats[r], c2 = a.stats[a.rows + r];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const float xh = xhat_of(xv[i], mu, rs);
      pg[i] += dv[i] * xh;
      pb[i] += dv[i];
      xv[i] = dx_of<RMS>(xh, __fmul_rn(dv[i], gv[i]), c1, c2, rs);
    }
    if constexpr (VEC)
      static_cast<uint4*>(a.dx)[at] = Chunk<T>::narrow(xv);
    else
      static_cast<T*>(a.dx)[at] = from_f32<T>(xv[0]);
  }
  let_next_start();
  float* outg = a.part + static_cast<size_t>(blockIdx.y) * h + u * M;
  float* outb = a.part + (static_cast<size_t>(a.groups) + blockIdx.y) * h +
                u * M;
  if constexpr (VEC) {
#pragma unroll
    for (int j = 0; j < M / 4; ++j) {
      reinterpret_cast<float4*>(outg)[j] =
          make_float4(pg[4 * j], pg[4 * j + 1], pg[4 * j + 2], pg[4 * j + 3]);
      if constexpr (!RMS)
        reinterpret_cast<float4*>(outb)[j] = make_float4(
            pb[4 * j], pb[4 * j + 1], pb[4 * j + 2], pb[4 * j + 3]);
    }
  } else {
    outg[0] = pg[0];
    if constexpr (!RMS) outb[0] = pb[0];
  }
}

// blockIdx.y 0: dgamma from part[0]; 1: dbeta from part[1]. A block
// takes 32 columns and S slices of the partial rows
template <typename P, int S>
__global__ void __launch_bounds__(32 * S)
    ln_bwd_cols_kernel(const float* __restrict__ part, P* __restrict__ dg,
                       P* __restrict__ db, int groups, int h) {
  __shared__ float red[32][33];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + tx;
  const float* p = part + static_cast<size_t>(blockIdx.y) * groups * h;
  float s = 0.f;
  wait_prior();  // the partials
  if (col < h) {
#pragma unroll 8
    for (int g = ty; g < groups; g += S)
      s += p[static_cast<size_t>(g) * h + col];
  }
  red[ty][tx] = s;
  __syncthreads();
  // warp w sums columns w, w + S, ... over their S slices, lane l
  // holding slice l (0 past S): a butterfly, a fixed tree
  for (int j = ty; j < 32; j += S) {
    const float v = warp_sum(tx < S ? red[tx][j] : 0.f);
    const int c = blockIdx.x * 32 + j;
    if (tx == 0 && c < h) (blockIdx.y == 0 ? dg : db)[c] = from_f32<P>(v);
  }
}

using RowsKernel = void (*)(const BwdArgs);

// what a launch runs: the register kernel (null: the fallback), its
// shared memory, its row groups a block and the most shared memory it
// takes at any width
struct Plan {
  RowsKernel kern;
  size_t smem;
  int gpb;
  size_t most;
};

template <typename T, typename G, int VPL, bool RMS, int RW>
Plan reg_plan(int h) {
  constexpr int gpb = kWarps / RW;
  constexpr size_t per_col = static_cast<size_t>(gpb) * (RMS ? 1 : 2) *
                             sizeof(float);
  return {ln_bwd_reg_kernel<T, G, VPL, RMS, RW>, per_col * h, gpb,
          per_col * VPL * 32 * RW * Chunk<T>::N};
}

// the register kernel for `nch` chunks a row of `h` values, or a null
// kernel past 16 chunks a lane: one warp a row up to 8 chunks a lane,
// two past that (half the registers a lane: twice the warps an SM, each
// row's work split between two)
template <typename T, typename G, bool RMS>
Plan reg_kernel(int nch, int h) {
  const int v1 = (nch + 31) / 32, v2 = (nch + 63) / 64;
  return v1 <= 1    ? reg_plan<T, G, 1, RMS, 1>(h)
         : v1 <= 2  ? reg_plan<T, G, 2, RMS, 1>(h)
         : v1 <= 3  ? reg_plan<T, G, 3, RMS, 1>(h)
         : v1 <= 4  ? reg_plan<T, G, 4, RMS, 1>(h)
         : v1 <= 6  ? reg_plan<T, G, 6, RMS, 1>(h)
         : v1 <= 8  ? reg_plan<T, G, 8, RMS, 1>(h)
         : v1 <= 16 ? (v2 <= 6 ? reg_plan<T, G, 6, RMS, 2>(h)
                                : reg_plan<T, G, 8, RMS, 2>(h))
                     : Plan{nullptr, 0, 0, 0};
}

template <typename T, typename G>
Plan plan(int h, bool rms, bool aligned) {
  constexpr int N = Chunk<T>::N;
  if (!aligned || h % N != 0) return {nullptr, 0, 0, 0};
  return rms ? reg_kernel<T, G, true>(h / N, h)
             : reg_kernel<T, G, false>(h / N, h);
}

// the register kernel's blocks on the whole current device at the plan's
// shared memory, asked of the runtime once per kernel, size and device
// (the kernel's shared-memory ceiling raised to its most on the first
// ask where that passes 48 KB)
long long resident_blocks(const Plan& pl) {
  static std::mutex mu;
  static std::map<std::tuple<uintptr_t, size_t, int>, long long> seen;
  int dev = 0;
  cudaGetDevice(&dev);
  const std::lock_guard<std::mutex> hold(mu);
  const auto key =
      std::make_tuple(reinterpret_cast<uintptr_t>(pl.kern), pl.smem, dev);
  const auto it = seen.find(key);
  if (it != seen.end()) return it->second;
  if (pl.most > 48 * 1024)
    cudaFuncSetAttribute(pl.kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(pl.most));
  int sms = 1, occ = 1;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, pl.kern, kWarps * 32,
                                                pl.smem);
  return seen[key] = static_cast<long long>(std::max(occ, 1)) * sms;
}

// blocks of the rows pass (the workspace's rows), at most `cap`: the
// register kernel fills the SMs at its occupancy with the workspace
// under 10 % of x + dy + dx's bytes
template <typename T>
int groups_for(const Plan& pl, int rows, int h, bool rms, long long cap) {
  const int np = rms ? 1 : 2;
  const long long ws = static_cast<long long>(0.075 * rows * sizeof(T) / np);
  if (pl.kern == nullptr) {
    // runs of 4 rows or more, in a workspace of up to 4 MB where 10 % is
    // less (it stays in L2): a few wide rows still spread over the SMs
    const long long l2 = (4LL << 20) / (4LL * np * h);
    return static_cast<int>(std::max(
        1LL, std::min({std::max(ws, l2), (rows + 3LL) / 4, 65535LL, cap})));
  }
  const long long gpb = pl.gpb;
  const long long most = std::max(
      1LL, std::min({ws, resident_blocks(pl), (rows + gpb - 1) / gpb, cap}));
  // the same run of rows for every row group where the rows allow
  const long long run = (rows + most * gpb - 1) / (most * gpb);
  return static_cast<int>((rows + run * gpb - 1) / (run * gpb));
}

template <typename T, typename G>
int launch_rows(BwdArgs& a, bool rms, int cap, cudaStream_t st) {
  constexpr int N = Chunk<T>::N;
  const bool aligned = aligned16(a.x) && aligned16(a.dy) &&
                       aligned16(a.dx) && aligned16(a.gamma);
  const Plan pl = plan<T, G>(a.h, rms, aligned);
  a.groups = groups_for<T>(pl, a.rows, a.h, rms, cap);
  if (pl.kern != nullptr) {
    note_launch(pl.kern, pl.smem, kWarps * 32);
    pl.kern<<<a.groups, kWarps * 32, pl.smem, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const bool vec = aligned && a.h % N == 0;
  RowsKernel stats, tile;
  if (rms) {
    stats = vec ? ln_bwd_stats_kernel<T, G, true, true>
                : ln_bwd_stats_kernel<T, G, true, false>;
    tile = vec ? ln_bwd_tile_kernel<T, G, true, true>
               : ln_bwd_tile_kernel<T, G, true, false>;
  } else {
    stats = vec ? ln_bwd_stats_kernel<T, G, false, true>
                : ln_bwd_stats_kernel<T, G, false, false>;
    tile = vec ? ln_bwd_tile_kernel<T, G, false, true>
               : ln_bwd_tile_kernel<T, G, false, false>;
  }
  note_launch(stats, 0, kStatThreads);
  stats<<<a.rows, kStatThreads, 0, st>>>(a);
  const int units = vec ? a.h / N : a.h;
  const dim3 grid((units + kTileThreads - 1) / kTileThreads, a.groups);
  const cudaError_t err = launch_after(tile, grid, dim3(kTileThreads), st, a);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// γ in fp32 or in x's own half type
template <typename T>
int launch_g(BwdArgs& a, bool rms, int cap, int gdtype, int dtype,
             cudaStream_t st) {
  if (gdtype == kF32) return launch_rows<T, float>(a, rms, cap, st);
  if (gdtype == dtype) return launch_rows<T, T>(a, rms, cap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename P>
cudaError_t launch_cols(const float* part, void* dg, void* db, int groups,
                        int h, int with_beta, cudaStream_t st) {
  const dim3 grid((h + 31) / 32, with_beta ? 2 : 1);
  // 32 slices of the partial rows a column, 8 where there are few
  P* g = static_cast<P*>(dg);
  P* b = static_cast<P*>(db);
  return groups > 64 ? launch_after(ln_bwd_cols_kernel<P, 32>, grid,
                                    dim3(32 * 32), st, part, g, b, groups, h)
                     : launch_after(ln_bwd_cols_kernel<P, 8>, grid,
                                    dim3(32 * 8), st, part, g, b, groups, h);
}

}  // namespace

// x, dy, dx: (rows, h) in `dtype`; gamma (h,) in `gdtype` (fp32 or
// `dtype`); mean, rstd (rows,) fp32; part: fp32 workspace of NP * cap *
// h floats (NP 1 for RMS, else 2; the partials of at most `cap` row
// blocks, cap >= max(1, 0.075 * rows * sizeof(dtype) / NP,
// 4 MiB / (4 * NP * h)) lets the kernel take the blocks it plans), then
// 2 * rows more (the fallback's row sums); dg, db: (h,) in `param_dtype`
// (db null without beta).
extern "C" int apex1_layer_norm_bwd(const void* x, const void* gamma,
                                    const void* mean, const void* rstd,
                                    const void* dy, void* dx, void* part,
                                    void* dg, void* db, int rows, int h,
                                    int cap, int rms, int with_beta,
                                    int dtype, int gdtype, int param_dtype,
                                    void* stream) {
  if (rows <= 0 || h <= 0) return 0;
  if (cap <= 0) return static_cast<int>(cudaErrorInvalidValue);
  float* ws = static_cast<float*>(part);
  BwdArgs a{x,
                  gamma,
                  static_cast<const float*>(mean),
                  static_cast<const float*>(rstd),
                  dy,
                  dx,
                  ws,
                  ws + static_cast<size_t>(rms ? 1 : 2) * cap * h,
                  rows,
                  h,
                  0};
  cudaStream_t st = as_stream(stream);
  int err;
  switch (dtype) {
    case kF32:
      err = launch_g<float>(a, rms, cap, gdtype, dtype, st);
      break;
    case kBF16:
      err = launch_g<__nv_bfloat16>(a, rms, cap, gdtype, dtype, st);
      break;
    case kF16:
      err = launch_g<__half>(a, rms, cap, gdtype, dtype, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  switch (param_dtype) {
    case kF32:
      err = launch_cols<float>(a.part, dg, db, a.groups, h, with_beta, st);
      break;
    case kBF16:
      err = launch_cols<__nv_bfloat16>(a.part, dg, db, a.groups, h,
                                       with_beta, st);
      break;
    case kF16:
      err = launch_cols<__half>(a.part, dg, db, a.groups, h, with_beta,
                                st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
