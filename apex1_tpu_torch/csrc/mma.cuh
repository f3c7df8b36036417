// Building blocks shared by the port's product kernels: cp.async copies,
// the L2-aware tile order, paired stores, and the fp32 block-level tiled
// product (`Gemm`: linear_xent.cu's wide path, glu.cu's and
// chunk_matmul.cu's fp32 paths) whose accumulators stay in registers for
// the caller's epilogue. wgmma.cuh takes its cp.async copies and paired
// stores from here.
#pragma once

#include "common.cuh"

#include <type_traits>

namespace {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One (M x K) · (K x N) operand as it lies in device memory: element (row,
// col) of the stored matrix at p[row · ld + col]. For A the stored rows are
// m (KC: k contiguous) or k; for B they are n (KC) or k.
template <typename T>
struct Operand {
  const T* p;
  long long ld;
};

// The tile order of a product grid: groups of 8 row tiles walk the column
// tiles together, so the blocks in flight share their operand tiles in L2.
__device__ __forceinline__ void swizzle(int pid, int tiles_m, int tiles_n,
                                        int& tm, int& tn) {
  constexpr int kGroup = 8;
  const int group = kGroup * tiles_n;
  const int first = (pid / group) * kGroup;
  const int size = min(tiles_m - first, kGroup);
  tm = first + (pid % group) % size;
  tn = (pid % group) / size;
}

// A block of 256 threads computes the BM x BN tile at (m0, n0) of NACC
// fp32 products A · B_j that share their A operand, each summed in fp32 over
// all of K. K is streamed in BK-deep steps through a STAGES-deep ring of
// shared tiles filled by cp.async (16-byte copies; `vec`: every stored row
// length and the operands' strides are multiples of 16 bytes and the
// pointers 16-byte aligned, else plain loads). Ragged M, N and K edges are
// zero-filled in shared memory; nothing is padded in device memory. Plain
// FMA on the CUDA cores (no TF32), thread (tm, tn) of a 16 x 16 grid owning
// rows tm + 16i and column pairs 2·tn + 32j + {0, 1}. (bf16/fp16 products
// run on wgmma: gemm_wg.cuh.)
template <typename T, int BM, int BN, int NACC, bool A_KC, bool B_KC>
struct Gemm {
  static_assert(sizeof(T) == 4, "fp32 operands (bf16/fp16: gemm_wg.cuh)");
  static constexpr int kThreads = 256;
  static constexpr int BK = 16;
  static constexpr int STAGES = 3;
  static constexpr int EPV = 4;  // elements a 16-byte copy
  static constexpr int A_R = A_KC ? BM : BK, A_C = A_KC ? BK : BM;
  static constexpr int B_R = B_KC ? BN : BK, B_C = B_KC ? BK : BN;
  static constexpr int LDA = A_C + EPV, LDB = B_C + EPV;
  static constexpr int A_ELEMS = A_R * LDA, B_ELEMS = B_R * LDB;
  static constexpr int STAGE = A_ELEMS + NACC * B_ELEMS;
  static constexpr size_t SMEM = size_t(STAGES) * STAGE * sizeof(T);
  // thread tiles
  static constexpr int TM = BM / 16, TJ = BN / 32;
  static_assert(BM % 32 == 0 && BN % 32 == 0, "tile geometry");

  float acc[NACC][TM][TJ][4];

  // R x C elements at rows r0.., columns c0.. of the stored matrix (limits
  // rlim, clim) into a shared tile with row stride lds
  template <int R, int C>
  static __device__ __forceinline__ void load_tile(T* s, int lds,
                                                   const Operand<T>& g,
                                                   int r0, int c0, int rlim,
                                                   int clim, int vec) {
    if (vec) {
      constexpr int CPR = C / EPV, N = R * CPR;
      static_assert(N % kThreads == 0, "loader geometry");
#pragma unroll
      for (int it = 0; it < N / kThreads; ++it) {
        const int i = threadIdx.x + it * kThreads;
        const int r = i / CPR, c = (i % CPR) * EPV;
        const bool in = r0 + r < rlim && c0 + c < clim;
        cp_async16(s + r * lds + c,
                   in ? g.p + (r0 + r) * g.ld + (c0 + c) : g.p, in ? 16 : 0);
      }
    } else {
      for (int i = threadIdx.x; i < R * C; i += kThreads) {
        const int r = i / C, c = i % C;
        const bool in = r0 + r < rlim && c0 + c < clim;
        s[r * lds + c] =
            in ? g.p[(r0 + r) * g.ld + (c0 + c)] : from_f32<T>(0.f);
      }
    }
  }

  __device__ __forceinline__ void load_stage(T* st, const Operand<T>& A,
                                             const Operand<T> (&B)[NACC],
                                             int M, int N, int K, int m0,
                                             int n0, int k0, int vec) {
    if constexpr (A_KC)
      load_tile<A_R, A_C>(st, LDA, A, m0, k0, M, K, vec);
    else
      load_tile<A_R, A_C>(st, LDA, A, k0, m0, K, M, vec);
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
      T* sb = st + A_ELEMS + j * B_ELEMS;
      if constexpr (B_KC)
        load_tile<B_R, B_C>(sb, LDB, B[j], n0, k0, N, K, vec);
      else
        load_tile<B_R, B_C>(sb, LDB, B[j], k0, n0, K, N, vec);
    }
  }

  __device__ __forceinline__ void compute(const T* st) {
    const T* sA = st;
    const int tm = threadIdx.x / 16, tn = threadIdx.x % 16;
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int m = tm + 16 * i;
        a[i] = A_KC ? sA[m * LDA + k] : sA[k * LDA + m];
      }
#pragma unroll
      for (int j = 0; j < NACC; ++j) {
        const T* sB = st + A_ELEMS + j * B_ELEMS;
#pragma unroll
        for (int jj = 0; jj < TJ; ++jj) {
          const int n = 2 * tn + 32 * jj;
          const float b0 = B_KC ? sB[n * LDB + k] : sB[k * LDB + n];
          const float b1 = B_KC ? sB[(n + 1) * LDB + k] : sB[k * LDB + n + 1];
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            acc[j][i][jj][0] = fmaf(a[i], b0, acc[j][i][jj][0]);
            acc[j][i][jj][1] = fmaf(a[i], b1, acc[j][i][jj][1]);
          }
        }
      }
    }
  }

  // the product over all of K; leaves `smem` free for the epilogue
  __device__ __forceinline__ void run(T* smem, const Operand<T>& A,
                                      const Operand<T> (&B)[NACC], int M,
                                      int N, int K, int m0, int n0, int vec) {
#pragma unroll
    for (int j = 0; j < NACC; ++j)
#pragma unroll
      for (int x = 0; x < TM; ++x)
#pragma unroll
        for (int y = 0; y < TJ; ++y)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][x][y][e] = 0.f;
    const int KT = (K + BK - 1) / BK;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < KT) load_stage(smem + s * STAGE, A, B, M, N, K, m0, n0, s * BK,
                             vec);
      cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
      cp_async_wait_group<STAGES - 2>();
      __syncthreads();  // stage kt has landed; stage kt - 1 is consumed
      const int nxt = kt + STAGES - 1;
      if (nxt < KT)
        load_stage(smem + (nxt % STAGES) * STAGE, A, B, M, N, K, m0, n0,
                   nxt * BK, vec);
      cp_async_commit();
      compute(smem + (kt % STAGES) * STAGE);
    }
    cp_async_wait_all();
    __syncthreads();
  }

  // f(r, c, v): v[j][h] is product j at tile row r, tile column c + h
  // (c even), for every element this thread holds
  template <typename F>
  __device__ __forceinline__ void for_each(F f) const {
    float v[NACC][2];
    const int tm = threadIdx.x / 16, tn = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int jj = 0; jj < TJ; ++jj) {
#pragma unroll
        for (int j = 0; j < NACC; ++j) {
          v[j][0] = acc[j][i][jj][0];
          v[j][1] = acc[j][i][jj][1];
        }
        f(tm + 16 * i, 2 * tn + 32 * jj, v);
      }
  }
};

// store elements (c, c + 1) of a row: one 2-element store where both are
// inside (c < n - 1) and `pair` (the row is 2-element aligned), else one
// at a time
template <typename T>
__device__ __forceinline__ void store_pair(T* row, int c, int n, float v0,
                                           float v1, bool pair) {
  if (pair && c + 1 < n) {
    if constexpr (std::is_same<T, float>::value) {
      *reinterpret_cast<float2*>(row + c) = make_float2(v0, v1);
    } else if constexpr (std::is_same<T, __half>::value) {
      *reinterpret_cast<__half2*>(row + c) = __floats2half2_rn(v0, v1);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(v0, v1);
    }
  } else {
    if (c < n) row[c] = from_f32<T>(v0);
    if (c + 1 < n) row[c + 1] = from_f32<T>(v1);
  }
}

}  // namespace
