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
//   whenever the sum is).
//
// Bound on the H100: operations. The SP boundary product at world 1
// (8192 x 2048 · 2048 x 8192, bf16) is 275 GFLOP against 101 MB of
// operands and fp32 output: 0.278 ms at 989 TFLOP/s.
//
// Design. The TPU kernel keeps K whole in VMEM and tiles (M, N). A block
// here owns one BM x BN output tile and streams K in 32-deep steps (16 in
// fp32) through a three-stage ring of shared tiles filled by cp.async
// (`Gemm` in mma.cuh, shared with glu.cu and linear_xent.cu: ldmatrix +
// mma.sync m16n8k16 with fp32 accumulators for the half types, .trans
// fragments for B whose N is contiguous; plain FMA on the CUDA cores for
// fp32, no TF32). K runs in one block in order: no split-K, no atomics,
// the same bits on every launch. Ragged M, N and K are zero-filled in
// shared memory, nothing is padded in device memory. The tile follows the
// shape so that a tensor-parallel rank's small chunk still fills the
// card: 128 x 128 when that gives two tiles an SM, else 128 x 64, else
// 64 x 64. Blocks walk the output in groups of 8 row tiles (L2 reuse).
// Not yet: wgmma, TMA, a persistent grid.

#include "mma.cuh"

namespace {

struct ChunkArgs {
  const void* a;
  const void* b;
  const float* acc;  // null: no accumulator
  float* c;
  int M, N, K;
  int vec;
};

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(256, 1) chunk_matmul_kernel(
    const ChunkArgs a) {
  using G = Gemm<T, BM, BN, 1, true, false>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  int tm, tn;
  swizzle(blockIdx.x, (a.M + BM - 1) / BM, (a.N + BN - 1) / BN, tm, tn);
  const int m0 = tm * BM, n0 = tn * BN;
  const Operand<T> A{static_cast<const T*>(a.a), a.K};
  const Operand<T> B[1] = {{static_cast<const T*>(a.b), a.N}};
  G g;
  g.run(smem, A, B, a.M, a.N, a.K, m0, n0, a.vec);
  const bool pair = a.N % 2 == 0;
  g.for_each([&](int r, int c, const float (&v)[1][2]) {
    const int row = m0 + r;
    if (row >= a.M) return;
    const size_t base = size_t(row) * a.N + n0;
    float v0 = v[0][0], v1 = v[0][1];
    if (a.acc != nullptr) {
      if (n0 + c < a.N) v0 = __fadd_rn(a.acc[base + c], v0);
      if (n0 + c + 1 < a.N) v1 = __fadd_rn(a.acc[base + c + 1], v1);
    }
    store_pair<float>(a.c + base, c, a.N - n0, v0, v1, pair);
  });
}

template <typename T, int BM, int BN>
int launch_tile(const ChunkArgs& a, cudaStream_t st) {
  using G = Gemm<T, BM, BN, 1, true, false>;
  static bool attr_set = false;
  auto kern = chunk_matmul_kernel<T, BM, BN>;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(G::SMEM));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int tiles = ((a.M + BM - 1) / BM) * ((a.N + BN - 1) / BN);
  kern<<<tiles, 256, G::SMEM, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int n_tiles(int M, int N, int bm, int bn) {
  return ((M + bm - 1) / bm) * ((N + bn - 1) / bn);
}

template <typename T>
int launch(const ChunkArgs& a, cudaStream_t st) {
  constexpr int kSMs = 132;  // the H100 SXM's
  if (n_tiles(a.M, a.N, 128, 128) >= 2 * kSMs)
    return launch_tile<T, 128, 128>(a, st);
  if (n_tiles(a.M, a.N, 128, 64) >= kSMs)
    return launch_tile<T, 128, 64>(a, st);
  return launch_tile<T, 64, 64>(a, st);
}

}  // namespace

// a (M, K), b (K, N) contiguous in `dtype`; acc (M, N) fp32 or null; c
// (M, N) fp32, not aliasing acc. vec: K and N are multiples of 16 bytes of
// elements and a, b 16-byte aligned.
extern "C" int apex1_chunk_matmul(const void* a, const void* b,
                                  const void* acc, void* c, int M, int N,
                                  int K, int vec, int dtype, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K < 0) return static_cast<int>(cudaErrorInvalidValue);
  ChunkArgs args{a, b, static_cast<const float*>(acc),
                 static_cast<float*>(c), M, N, K, vec};
  cudaStream_t st = as_stream(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(args, st);
    case kBF16:
      return launch<__nv_bfloat16>(args, st);
    case kF16:
      return launch<__half>(args, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
