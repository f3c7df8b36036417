// The bf16/fp16 backward of the fused LM-head cross-entropy for Hopper
// (sm_90a): dx and dW of softmax(x·Wᵀ) (linear_xent.cu states the
// function) as three wgmma products a vocab chunk, on gemm_wg.cuh.
//
// Replaces: apex1_tpu/ops/linear_xent.py::_bwd_dx_kernel (shard_grads
// :345) and ::_bwd_dw_kernel (shard_grads :357), for bf16 and fp16 at
// every H; fp32 keeps linear_xent.cu's kernels.
//
// Per vocab chunk of n rows W_c (the wrapper walks the chunks in order):
//   G_c (T, n)  = the chunk's score tiles x·W_cᵀ with the gradient
//                 epilogue: (valid ? exp(s - lse) : 0) - (1-ε)[g == label]
//                 - ε/K, 0 where invalid, times dloss (0 at padding_idx),
//                 rounded to the operand type (as the TPU kernels round
//                 their grad tile), in a buffer of row stride ldg (n
//                 rounded up to 8, the pad columns written 0);
//   dx         += G_c·W_c: an fp32 (T, H) sum in device memory, the first
//                 chunk writing it, the last writing dx in the operand
//                 type (each chunk's product is summed in registers, then
//                 added to the sum);
//   dW_c        = G_cᵀ·x (G read down its columns, M-major).
// The logits are formed once a chunk for both products. Each output
// element is summed by one block in a fixed order: no atomics and no
// split of K, so two runs give the same bits, and dx and dW formed
// together equal each formed alone.
//
// Bound on the H100: operations. At the Llama head (T = 8190, V = 32000,
// H = 4096) each product is 2·T·V·H = 2.15 TFLOP on about 0.3 GB of
// operands; the backward's three are 6.4 TFLOP, 6.5 ms at 989 TFLOP/s.
// The TPU kernels recompute the logits once for dx and once for dW (four
// products); here G costs T·n·2 bytes a chunk of device memory instead.
//
// Tiles: 128 x 256 a block (m64n256 products: 128-column tiles took up to
// a quarter longer for G, whose A operand they read twice as often, and
// gained nothing measurable on dx and dW where they fill the last wave
// better), one block an SM, K in steps of 64 through a four-stage
// cp.async ring (gemm_wg.cuh). Not yet: TMA with mbarriers, warp
// specialisation, a persistent grid.

#include "gemm_wg.cuh"

namespace {

constexpr int kBN = 256, kStages = 4;

template <typename T, bool A_MN, bool B_MN>
using Prod = wg::Gemm<T, kBN, kStages, A_MN, B_MN>;

struct GradArgs {
  const void* x;      // (T, H)
  const void* w;      // (n, H): the chunk's rows
  const int* labels;  // (T,)
  const float* lse;   // (T,)
  const float* dloss;
  void* g;            // (T, ldg)
  int T, n, H, K, off;  // off: global column of the chunk's row 0
  int ldg;
  float smoothing;
  int has_pad, pad, vec;
};

struct ProdArgs {
  const void* g;  // G_c (T, ldg)
  const void* b;  // dx: W_c (n, H); dW: x (T, H)
  float* acc;     // dx: the fp32 (T, H) sum
  void* out;      // dx (T, H), or dW_c (n, H)
  int T, n, H, ldg;
  int first, last, vec;
};

__device__ __forceinline__ unsigned char* dyn_smem() {
  extern __shared__ __align__(1024) unsigned char lxwg_smem[];
  return lxwg_smem;
}

// G_c = the gradient epilogue on x·W_cᵀ: M = T, N = n, K = H
template <typename T>
__global__ void __launch_bounds__(256, 1)
    lxent_wg_grad_kernel(const GradArgs a) {
  using P = Prod<T, false, false>;
  int tm, tn;
  swizzle(blockIdx.x, (a.T + P::BM - 1) / P::BM, (a.n + kBN - 1) / kBN, tm,
          tn);
  const int m0 = tm * P::BM, n0 = tn * kBN;
  P p;
  p.run(dyn_smem(), static_cast<const T*>(a.x), a.H,
        static_cast<const T*>(a.w), a.H, a.T, a.n, a.H, m0, n0, a.vec != 0,
        a.vec != 0);
  const float on = 1.f - a.smoothing;
  const float eps_k = a.smoothing / static_cast<float>(a.K);
  T* out = static_cast<T*>(a.g);
  // a thread's two rows: their label, lse and dloss, read once
  const int lane = threadIdx.x % 32;
  const int r0 = m0 + 64 * (threadIdx.x / 128) +
                 16 * ((threadIdx.x / 32) % 4) + lane / 4;
  int lab[2];
  float lse[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + 8 * hh;
    const bool in = row < a.T;
    lab[hh] = in ? a.labels[row] : -1;
    lse[hh] = in ? a.lse[row] : 0.f;
    dl[hh] = (in && !(a.has_pad && lab[hh] == a.pad)) ? a.dloss[row] : 0.f;
  }
  p.for_each([&](int r, int c, int hh, float v0, float v1) {
    const int row = m0 + r, col = n0 + c;
    const float v[2] = {v0, v1};
    float gv[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int gcol = col + e + a.off;
      const bool valid = col + e < a.n && gcol < a.K;
      const float pr = valid ? expf(v[e] - lse[hh]) : 0.f;
      const float d = pr - on * (gcol == lab[hh] ? 1.f : 0.f) - eps_k;
      gv[e] = valid ? d * dl[hh] : 0.f;
    }
    // ldg and col are even: the pair lies inside the row or past it
    if (row < a.T && col < a.ldg)
      *reinterpret_cast<uint32_t*>(out + size_t(row) * a.ldg + col) =
          wg::pack2<T>(gv[0], gv[1]);
  });
}

// elements (c, c + 1) of an fp32 row: both where c + 1 < n
__device__ __forceinline__ float2 load_pair(const float* row, int c, int n,
                                            bool pair) {
  if (pair && c + 1 < n) return *reinterpret_cast<const float2*>(row + c);
  return make_float2(c < n ? row[c] : 0.f, c + 1 < n ? row[c + 1] : 0.f);
}

// dx += G_c·W_c: M = T, N = H, K = n; A = G_c (K-major), B = W_c (N-major)
template <typename T>
__global__ void __launch_bounds__(256, 1)
    lxent_wg_dx_kernel(const ProdArgs a) {
  using P = Prod<T, false, true>;
  int tm, tn;
  swizzle(blockIdx.x, (a.T + P::BM - 1) / P::BM, (a.H + kBN - 1) / kBN, tm,
          tn);
  const int m0 = tm * P::BM, n0 = tn * kBN;
  P p;
  p.run(dyn_smem(), static_cast<const T*>(a.g), a.ldg,
        static_cast<const T*>(a.b), a.H, a.T, a.H, a.n, m0, n0, true,
        a.vec != 0);
  const bool pair = a.H % 2 == 0;
  const int ncol = a.H - n0;
  p.for_each([&](int r, int c, int, float v0, float v1) {
    const int row = m0 + r;
    if (row >= a.T) return;
    const size_t base = size_t(row) * a.H + n0;
    if (!a.first) {
      const float2 s = load_pair(a.acc + base, c, ncol, pair);
      v0 += s.x;
      v1 += s.y;
    }
    if (a.last)
      store_pair<T>(static_cast<T*>(a.out) + base, c, ncol, v0, v1, pair);
    else
      store_pair<float>(a.acc + base, c, ncol, v0, v1, pair);
  });
}

// dW_c = G_cᵀ·x: M = n, N = H, K = T; A = G_c down its columns (M-major),
// B = x (N-major)
template <typename T>
__global__ void __launch_bounds__(256, 1)
    lxent_wg_dw_kernel(const ProdArgs a) {
  using P = Prod<T, true, true>;
  int tm, tn;
  swizzle(blockIdx.x, (a.n + P::BM - 1) / P::BM, (a.H + kBN - 1) / kBN, tm,
          tn);
  const int m0 = tm * P::BM, n0 = tn * kBN;
  P p;
  p.run(dyn_smem(), static_cast<const T*>(a.g), a.ldg,
        static_cast<const T*>(a.b), a.H, a.n, a.H, a.T, m0, n0, true,
        a.vec != 0);
  const bool pair = a.H % 2 == 0;
  const int ncol = a.H - n0;
  p.for_each([&](int r, int c, int, float v0, float v1) {
    const int row = m0 + r;
    if (row < a.n)
      store_pair<T>(static_cast<T*>(a.out) + size_t(row) * a.H + n0, c, ncol,
                    v0, v1, pair);
  });
}

// the kernel of `dtype` (bf16 or fp16) over the M x N output's tiles
template <typename Args>
int launch_wg(void (*bf16)(const Args), void (*f16)(const Args), int dtype,
              int M, int N, const Args& a, void* stream) {
  void (*kern)(const Args) =
      dtype == kBF16 ? bf16 : dtype == kF16 ? f16 : nullptr;
  if (kern == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  // the ring is the same size for every operand layout and 16-bit type
  constexpr size_t smem = Prod<__half, false, false>::SMEM;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = ((M + 127) / 128) * ((N + kBN - 1) / kBN);
  note_launch(kern, smem, 256);
  kern<<<tiles, 256, smem, as_stream(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// G_c of one vocab chunk: x (T, H), w the chunk's n rows (n, H), labels
// (T,) int32, lse and dloss (T,) fp32; off the global column of the
// chunk's first row; g (T, ldg) in `dtype` (bf16 or fp16), ldg >= n a
// multiple of 8, columns [n, ldg) written 0. vec: H is a multiple of 8
// and x, w are 16-byte aligned.
extern "C" int apex1_lxent_wg_grad(const void* x, const void* w,
                                   const void* labels, const void* lse,
                                   const void* dloss, void* g, int T, int n,
                                   int H, int K, int off, float smoothing,
                                   int has_pad, int pad, int ldg, int vec,
                                   int dtype, void* stream) {
  if (T <= 0 || n <= 0) return 0;
  if (H <= 0 || K <= 0 || ldg < n || ldg % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  GradArgs ga{};
  ga.x = x;
  ga.w = w;
  ga.labels = static_cast<const int*>(labels);
  ga.lse = static_cast<const float*>(lse);
  ga.dloss = static_cast<const float*>(dloss);
  ga.g = g;
  ga.T = T;
  ga.n = n;
  ga.H = H;
  ga.K = K;
  ga.off = off;
  ga.ldg = ldg;
  ga.smoothing = smoothing;
  ga.has_pad = has_pad;
  ga.pad = pad;
  ga.vec = vec;
  return launch_wg(lxent_wg_grad_kernel<__nv_bfloat16>,
                   lxent_wg_grad_kernel<__half>, dtype, T, n, ga, stream);
}

// dx += G_c (T, ldg; n columns) · W_c (n, H): acc the fp32 (T, H) sum
// (unread with first, unwritten with last), dx (T, H) written with last
extern "C" int apex1_lxent_wg_dx(const void* g, const void* w, void* acc,
                                 void* dx, int T, int n, int H, int ldg,
                                 int first, int last, int vec, int dtype,
                                 void* stream) {
  if (T <= 0 || n <= 0 || H <= 0) return 0;
  if (ldg < n || ldg % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const ProdArgs pa{g, w, static_cast<float*>(acc), dx, T, n, H, ldg,
                    first, last, vec};
  return launch_wg(lxent_wg_dx_kernel<__nv_bfloat16>,
                   lxent_wg_dx_kernel<__half>, dtype, T, H, pa, stream);
}

// dW_c (n, H) = G_cᵀ · x, G_c (T, ldg; n columns), x (T, H)
extern "C" int apex1_lxent_wg_dw(const void* g, const void* x, void* dw,
                                 int T, int n, int H, int ldg, int vec,
                                 int dtype, void* stream) {
  if (T <= 0 || n <= 0 || H <= 0) return 0;
  if (ldg < n || ldg % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const ProdArgs pa{g, x, nullptr, dw, T, n, H, ldg, 0, 0, vec};
  return launch_wg(lxent_wg_dw_kernel<__nv_bfloat16>,
                   lxent_wg_dw_kernel<__half>, dtype, n, H, pa, stream);
}
