// A tiled bf16/fp16 product for Hopper (sm_90a) on wgmma.cuh's parts: a
// block of two warpgroups (256 threads) computes the 128 x BN tile at
// (m0, n0) of C_j = A·B_j over all of K for NB products that share their A
// operand (NB = 1: one product; 2: the fused GLU's gate and up), each
// warpgroup 64 rows as wgmma m64nBNk16 products with both operands in
// shared memory and its NB sets of 64 x BN fp32 accumulators in registers
// (BN / 2 a thread a set), which the caller's epilogue reads through
// `for_each` (NB = 1) or `for_each_pair` (NB = 2).
//
// Operands as they lie in device memory (row strides lda, ldb):
//   A_MN false: A(m, k) = a[m·lda + k] (K-major; x, or G read along rows)
//   A_MN true:  A(m, k) = a[k·lda + m] (M-major; G read down its columns,
//               wgmma's transpose bit on A)
//   B_MN false: B(k, n) = b[n·ldb + k] (K-major; W rows in x·Wᵀ)
//   B_MN true:  B(k, n) = b[k·ldb + n] (N-major; W in G·W, x in Gᵀ·x, the
//               GLU's (in, out) weights)
// Every tile is stored in 128B-swizzled 64-wide blocks (wgmma.cuh): K-major
// tiles as R rows of 64 depth values, MN-major tiles as 64 depth rows of
// 128 or BN values, which one m64nBN product reads across all its blocks.
//
// K runs in steps of BK = 64 through a ring of STAGES stages (one A tile
// and NB B tiles each) filled by cp.async from all 256 threads, STAGES - 2
// stages ahead, and each warpgroup keeps one step's products in flight
// while the next is issued: one __syncthreads a step, after which step k
// has landed and every product of step k - 2 is done, so its stage is
// refilled.
//
// Ragged M, N and K edges are zero-filled in shared memory; nothing is
// padded in device memory. vec (the row stride a multiple of 8 values, the
// pointer 16-byte aligned): 16-byte cp.async copies of every 8-value chunk
// that starts inside the operand, so the rows' storage must run to the
// chunk's end; else plain loads, value by value (a BERT MLM head row of
// 769 values, 1538 bytes).
#pragma once

#include "wgmma.cuh"

namespace wg {

// Rows [0, rows) and columns [0, cols) of a row-major device matrix (row
// stride ld) into the R x CP swizzled tile at `dst`, by NTHR threads; the
// rest zero (see the vec rule above).
template <typename T, int R, int CP, int NTHR>
__device__ __forceinline__ void load_tile_ld(unsigned char* dst, const T* src,
                                             long long ld, int rows,
                                             int cols, bool vec) {
  constexpr int CPR = CP / 8, N = R * CPR;
  static_assert(CP % 64 == 0, "loader geometry");
  if (vec) {
#pragma unroll
    for (int it = 0; it < (N + NTHR - 1) / NTHR; ++it) {
      const int i = threadIdx.x + it * NTHR, r = i / CPR, c = i % CPR;
      if (N % NTHR != 0 && i >= N) break;
      const bool in = r < rows && c * 8 < cols;
      cp_async16(dst + sw_offset(R, r, c), in ? src + r * ld + c * 8 : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < N; i += NTHR) {
      const int r = i / CPR, c = i % CPR;
      alignas(16) T v[8];
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int e = c * 8 + x;
        v[x] = (r < rows && e < cols) ? src[r * ld + e] : from_f32<T>(0.f);
      }
      *reinterpret_cast<uint4*>(dst + sw_offset(R, r, c)) =
          *reinterpret_cast<uint4*>(v);
    }
  }
}

template <typename T, int BN_, int STAGES, bool A_MN, bool B_MN, int NB = 1>
struct Gemm {
  static constexpr int NTHR = 256, BM = 128, BN = BN_, BK = 64;
  static constexpr size_t A_TILE = size_t(BM) * BK * 2;
  static constexpr size_t B_TILE = size_t(BN) * BK * 2;
  static constexpr size_t STAGE = A_TILE + NB * B_TILE;
  // the ring, and 1024 bytes to align it for the swizzle
  static constexpr size_t SMEM = 1024 + STAGES * STAGE;
  static_assert(BN == 64 || BN == 128 || BN == 256,
                "m64n64, m64n128 or m64n256 products");
  static_assert(NB == 1 || NB == 2, "one or two products sharing A");
  static_assert(STAGES >= 3 && SMEM <= 232448, "ring geometry");

  float acc[NB][BN / 2];

  static __device__ __forceinline__ unsigned char* ring(unsigned char* smem) {
    const uint32_t s0 = smem_u32(smem);
    return smem + (((s0 + 1023u) & ~1023u) - s0);
  }

  static __device__ __forceinline__ void load_stage(
      unsigned char* st, const T* a, long long lda, const T* const* b,
      long long ldb, int M, int N, int K, int m0, int n0, int k0, bool va,
      bool vb) {
    unsigned char* sA = st;
    if constexpr (A_MN)
      load_tile_ld<T, BK, BM, NTHR>(sA, a + size_t(k0) * lda + m0, lda,
                                    K - k0, M - m0, va);
    else
      load_tile_ld<T, BM, BK, NTHR>(sA, a + size_t(m0) * lda + k0, lda,
                                    M - m0, K - k0, va);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      unsigned char* sB = st + A_TILE + j * B_TILE;
      if constexpr (B_MN)
        load_tile_ld<T, BK, BN, NTHR>(sB, b[j] + size_t(k0) * ldb + n0, ldb,
                                      K - k0, N - n0, vb);
      else
        load_tile_ld<T, BN, BK, NTHR>(sB, b[j] + size_t(n0) * ldb + k0, ldb,
                                      N - n0, K - k0, vb);
    }
  }

  // warpgroup w's products of one K step: its 64 rows x all BN columns of
  // each product, the A descriptor shared; the first step's first product
  // overwrites the accumulators (`first`), so no other instruction ever
  // writes them before the epilogue
  __device__ __forceinline__ void mma_stage(const unsigned char* st, int w,
                                            bool first) {
    const unsigned char* sA = st;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da =
          A_MN ? desc_mn(sA, BK, w, kk) : desc_k(sA, BM, 64 * w, kk);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const unsigned char* sB = st + A_TILE + j * B_TILE;
        const uint64_t db =
            B_MN ? desc_mn_wide(sB, BK, kk) : desc_k(sB, BN, 0, kk);
        mma_ss<T, BN, A_MN ? 1 : 0, B_MN ? 1 : 0>(acc[j], da, db,
                                                  !(first && kk == 0));
      }
    }
  }

  __device__ __forceinline__ void keep_acc() {
#pragma unroll
    for (int j = 0; j < NB; ++j) keep(acc[j]);
  }

  // the products over all of K (K > 0) into acc; `smem` is free again
  // after it. b: NB pointers, one row stride
  __device__ __forceinline__ void run(unsigned char* smem, const T* a,
                                      long long lda, const T* const* b,
                                      long long ldb, int M, int N, int K,
                                      int m0, int n0, bool va, bool vb) {
    unsigned char* r = ring(smem);
    const int w = threadIdx.x / 128;
    const int KT = (K + BK - 1) / BK;  // at least 1: K > 0
#pragma unroll
    for (int s = 0; s < STAGES - 2; ++s) {
      if (s < KT)
        load_stage(r + s * STAGE, a, lda, b, ldb, M, N, K, m0, n0, s * BK,
                   va, vb);
      cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
      cp_async_wait_group<STAGES - 3>();
      fence_async_smem();
      __syncthreads();  // step kt has landed; step kt - 2's stage is free
      const int nxt = kt + STAGES - 2;
      if (nxt < KT)
        load_stage(r + (nxt % STAGES) * STAGE, a, lda, b, ldb, M, N, K, m0,
                   n0, nxt * BK, va, vb);
      cp_async_commit();
      // the accumulators pinned on both sides of the in-flight products,
      // so the compiler moves no access to them across the wgmmas
      keep_acc();
      fence();
      mma_stage(r + (kt % STAGES) * STAGE, w, kt == 0);
      commit();
      wait<1>();
      keep_acc();
    }
    wait<0>();
    keep_acc();
    cp_async_wait_all();
    __syncthreads();
  }

  // one product (NB = 1)
  __device__ __forceinline__ void run(unsigned char* smem, const T* a,
                                      long long lda, const T* b,
                                      long long ldb, int M, int N, int K,
                                      int m0, int n0, bool va, bool vb) {
    static_assert(NB == 1, "one B operand");
    const T* bs[1] = {b};
    run(smem, a, lda, bs, ldb, M, N, K, m0, n0, va, vb);
  }

  // f(r, c, hh, v0, v1): tile elements (r, c) and (r, c + 1), c even, for
  // every pair this thread holds: its row hh of two (rows r and r + 8 of
  // its warp's 16), the columns of its quad in each n8 block (NB = 1)
  template <typename F>
  __device__ __forceinline__ void for_each(F f) const {
    static_assert(NB == 1, "for_each_pair reads two products");
    const int tid = threadIdx.x, lane = tid % 32;
    const int r0 = 64 * (tid / 128) + 16 * ((tid / 32) % 4) + lane / 4;
    const int c0 = 2 * (lane % 4);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        f(r0 + 8 * hh, c0 + 8 * j, hh, acc[0][4 * j + 2 * hh],
          acc[0][4 * j + 2 * hh + 1]);
  }

  // f(r, c, g0, g1, u0, u1): `for_each` over two products (NB = 2), the
  // pair of each at the same two elements
  template <typename F>
  __device__ __forceinline__ void for_each_pair(F f) const {
    static_assert(NB == 2, "for_each reads one product");
    const int tid = threadIdx.x, lane = tid % 32;
    const int r0 = 64 * (tid / 128) + 16 * ((tid / 32) % 4) + lane / 4;
    const int c0 = 2 * (lane % 4);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int i = 4 * j + 2 * hh;
        f(r0 + 8 * hh, c0 + 8 * j, acc[0][i], acc[0][i + 1], acc[1][i],
          acc[1][i + 1]);
      }
  }
};

}  // namespace wg
