// The chunk product of the fused collective matmuls for Hopper (sm_90a):
// C (M x N, fp32) = [acc_in +] A (M x K) · B (K x N).
//
// Replaces: apex1_tpu/ops/fused_collective.py::_chunk_matmul, both of its
// Pallas kernels (_cm_whole_kernel, pallas_call :158, the interpret
// mode's one-tile anchor; _cm_tile_kernel, pallas_call :177, the compiled
// (M, N)-tiled form), and the product of _mrs_rdma_kernel (pallas_call
// :883), whose epilogue adds the travelling fp32 accumulator that arrived
// from the upstream rank: ship = acc_in + partial (:760). The rdma ring's
// transfers are NCCL's, outside the kernel (ops/fused_collective.py).
//
//   A (M, K) and B (K, N) row-major in one type (bf16, fp16 or fp32);
//   C (M, N) fp32; acc_in (M, N) fp32 or null. Each C element is the
//   fp32 sum over k in a fixed order; with acc_in, C = acc_in + sum,
//   one IEEE addition (commutative, so equal to the ring's acc + pend
//   whenever the sum is). K = 0 gives the empty sum, 0 (acc_in + 0).
//
// Bound on the H100: operations. The SP boundary product at world 1
// (8192 x 2048 · 2048 x 8192, bf16) is 275 GFLOP against 101 MB of
// operands and fp32 output: 0.278 ms at 989 TFLOP/s.
//
// Design. The TPU kernel keeps K whole in VMEM and tiles (M, N). A block
// here owns one output tile and streams K through a ring of shared tiles
// filled by cp.async; K runs in one block in order: no split-K, no
// atomics, the same bits on every launch. Ragged M, N and K are
// zero-filled in shared memory, nothing is padded in device memory.
// Blocks walk the output in groups of 8 row tiles (L2 reuse).
// - bf16/fp16: gemm_wg.cuh's wgmma product (A K-major, B N-major: the
//   transpose bit on B), 128 x 256 tiles when that gives every SM a tile,
//   else 128 x 128 (a tensor-parallel rank's small chunk), K in steps of
//   64 through a four-stage ring; the epilogue reads the fp32 accumulators
//   from registers.
// - fp32: mma.cuh's `Gemm` (plain FMA on the CUDA cores, no TF32) in
//   16-deep K steps, 128 x 128 when that gives two tiles an SM, else
//   128 x 64, else 64 x 64.
// Not yet: TMA, a persistent grid.

#include "gemm_wg.cuh"

namespace {

constexpr int kSMs = 132;  // the H100 SXM's
constexpr int kStages = 4;

struct ChunkArgs {
  const void* a;
  const void* b;
  const float* acc;  // null: no accumulator
  float* c;
  int M, N, K;
  int vec;
};

int n_tiles(int M, int N, int bm, int bn) {
  return ((M + bm - 1) / bm) * ((N + bn - 1) / bn);
}

// the output tile (bm x bn) for an M x N product in `dtype`
void tile_of(int M, int N, int dtype, int& bm, int& bn) {
  bm = 128;
  if (dtype != kF32) {
    bn = n_tiles(M, N, 128, 256) >= kSMs ? 256 : 128;
  } else if (n_tiles(M, N, 128, 128) >= 2 * kSMs) {
    bn = 128;
  } else if (n_tiles(M, N, 128, 64) >= kSMs) {
    bn = 64;
  } else {
    bm = bn = 64;
  }
}

// C's element pair (row, col), (row, col + 1) of the tile at n0: the
// accumulator added with one rounding, stored where inside C
__device__ __forceinline__ void store_c(const ChunkArgs& a, int row, int n0,
                                        int c, float v0, float v1,
                                        bool pair) {
  if (row >= a.M) return;
  const size_t base = size_t(row) * a.N + n0;
  if (a.acc != nullptr) {
    if (n0 + c < a.N) v0 = __fadd_rn(a.acc[base + c], v0);
    if (n0 + c + 1 < a.N) v1 = __fadd_rn(a.acc[base + c + 1], v1);
  }
  store_pair<float>(a.c + base, c, a.N - n0, v0, v1, pair);
}

template <typename T, int BN>
__global__ void __launch_bounds__(256, 1) chunk_matmul_wg_kernel(
    const ChunkArgs a) {
  using P = wg::Gemm<T, BN, kStages, false, true>;
  extern __shared__ __align__(1024) unsigned char cm_smem[];
  int tm, tn;
  swizzle(blockIdx.x, (a.M + P::BM - 1) / P::BM, (a.N + BN - 1) / BN, tm,
          tn);
  const int m0 = tm * P::BM, n0 = tn * BN;
  P p;
  if (a.K > 0) {
    p.run(cm_smem, static_cast<const T*>(a.a), a.K,
          static_cast<const T*>(a.b), a.N, a.M, a.N, a.K, m0, n0,
          a.vec != 0, a.vec != 0);
  } else {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) p.acc[0][i] = 0.f;
  }
  const bool pair = a.N % 2 == 0;
  p.for_each([&](int r, int c, int, float v0, float v1) {
    store_c(a, m0 + r, n0, c, v0, v1, pair);
  });
}

template <typename T, int BN>
int launch_wg(const ChunkArgs& a, cudaStream_t st) {
  constexpr size_t smem = wg::Gemm<T, BN, kStages, false, true>::SMEM;
  static bool attr_set = false;
  auto kern = chunk_matmul_wg_kernel<T, BN>;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  note_launch(kern, smem, 256);
  kern<<<n_tiles(a.M, a.N, 128, BN), 256, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN>
__global__ void __launch_bounds__(256, 1) chunk_matmul_f32_kernel(
    const ChunkArgs a) {
  using G = Gemm<float, BM, BN, 1, true, false>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  int tm, tn;
  swizzle(blockIdx.x, (a.M + BM - 1) / BM, (a.N + BN - 1) / BN, tm, tn);
  const int m0 = tm * BM, n0 = tn * BN;
  const Operand<float> A{static_cast<const float*>(a.a), a.K};
  const Operand<float> B[1] = {{static_cast<const float*>(a.b), a.N}};
  G g;
  g.run(smem, A, B, a.M, a.N, a.K, m0, n0, a.vec);
  const bool pair = a.N % 2 == 0;
  g.for_each([&](int r, int c, const float (&v)[1][2]) {
    store_c(a, m0 + r, n0, c, v[0][0], v[0][1], pair);
  });
}

template <int BM, int BN>
int launch_f32_tile(const ChunkArgs& a, cudaStream_t st) {
  using G = Gemm<float, BM, BN, 1, true, false>;
  static bool attr_set = false;
  auto kern = chunk_matmul_f32_kernel<BM, BN>;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(G::SMEM));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  note_launch(kern, G::SMEM, 256);
  kern<<<n_tiles(a.M, a.N, BM, BN), 256, G::SMEM, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the tile as rows·1000 + columns: 0 takes tile_of's; else one of those
// the library builds (bf16/fp16 128 x 128 or 128 x 256; fp32 128 x 128,
// 128 x 64 or 64 x 64), or false
bool pick_tile(int M, int N, int dtype, int tile, int& bm, int& bn) {
  if (tile == 0) {
    tile_of(M, N, dtype, bm, bn);
    return true;
  }
  bm = tile / 1000;
  bn = tile % 1000;
  if (dtype != kF32) return bm == 128 && (bn == 128 || bn == 256);
  return (bm == 128 && (bn == 128 || bn == 64)) || (bm == 64 && bn == 64);
}

int launch(const ChunkArgs& a, int dtype, int tile, cudaStream_t st) {
  int bm, bn;
  if (!pick_tile(a.M, a.N, dtype, tile, bm, bn))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case kF32:
      return bn == 128  ? launch_f32_tile<128, 128>(a, st)
             : bm == 128 ? launch_f32_tile<128, 64>(a, st)
                         : launch_f32_tile<64, 64>(a, st);
    case kBF16:
      return bn == 256 ? launch_wg<__nv_bfloat16, 256>(a, st)
                       : launch_wg<__nv_bfloat16, 128>(a, st);
    case kF16:
      return bn == 256 ? launch_wg<__half, 256>(a, st)
                       : launch_wg<__half, 128>(a, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// a (M, K), b (K, N) contiguous in `dtype`; acc (M, N) fp32 or null; c
// (M, N) fp32, not aliasing acc. vec: K and N are multiples of 16 bytes of
// elements and a, b 16-byte aligned. tile: bm·1000 + bn of a tile the
// library builds, or 0 for tile_of's.
extern "C" int apex1_chunk_matmul(const void* a, const void* b,
                                  const void* acc, void* c, int M, int N,
                                  int K, int vec, int dtype, int tile,
                                  void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K < 0) return static_cast<int>(cudaErrorInvalidValue);
  ChunkArgs args{a, b, static_cast<const float*>(acc),
                 static_cast<float*>(c), M, N, K, vec};
  return launch(args, dtype, tile, as_stream(stream));
}

// the output tile apex1_chunk_matmul launches for an M x N product in
// `dtype`, as rows·1000 + columns
extern "C" int apex1_chunk_matmul_tile(int M, int N, int dtype) {
  int bm, bn;
  tile_of(M, N, dtype, bm, bn);
  return bm * 1000 + bn;
}
