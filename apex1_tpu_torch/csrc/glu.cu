// Fused gated MLP for Hopper (sm_90a): act(x·Wg) ⊙ (x·Wu) in one pass
// over x (SwiGLU with silu, GeGLU with tanh-gelu).
//
// Replaces: apex1_tpu/ops/fused_dense.py::_glu_kernel (launched by
// _glu_call, pallas_call :213).
//
//   x (T, H); Wg, Wu (H, F) in the (in, out) layout the Llama model stores;
//   out (T, F) = act(g) · u with g = x·Wg, u = x·Wu summed in fp32 and the
//   epilogue in fp32, rounded to x's dtype once.
//
// Bound on the H100: operations. At the Llama-3 8B training shape (T =
// 8192, H = 4096, F = 14336, bf16) the two products are 4·T·H·F = 1.93
// TFLOP against 0.37 GB of operands and output (5 200 flop/byte, far above
// the ~295 ridge): 1.95 ms at 989 TFLOP/s.
//
// Design. The TPU kernel holds a (bt, Hp) x block and both (Hp, bf) weight
// blocks in VMEM and forms each dot over all of H at once. A block here
// owns a 128 x 64 output tile and two fp32 accumulators, gate and up, in
// registers; H is streamed in 32-deep steps through a three-stage ring of
// shared tiles (cp.async), each staged x tile serving both products, so x
// is read once for the pair and g never goes to device memory
// (`Gemm` in mma.cuh: mma.sync m16n8k16 on ldmatrix fragments, .trans for
// the (H, F) weights, whose F is contiguous). The epilogue applies the
// activation in fp32 and writes the tile in x's dtype. Blocks walk the
// output in groups of 8 row tiles so that the x and W tiles in flight
// share L2. Ragged T, F and H are zero-filled in shared memory, nothing is
// padded in device memory. fp32 runs as plain FMA on the CUDA cores (no
// TF32). Not yet: wgmma, TMA, a persistent grid.

#include "mma.cuh"

namespace {

constexpr int kBM = 128, kBN = 64;
enum Act { kSilu = 0, kGelu = 1 };

template <int ACT>
__device__ __forceinline__ float activate(float g) {
  if constexpr (ACT == kSilu) {
    return g * (1.f / (1.f + expf(-g)));
  } else {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * g * (1.f + tanhf(c * (g + 0.044715f * g * g * g)));
  }
}

struct GluArgs {
  const void* x;
  const void* wg;
  const void* wu;
  void* out;
  int T, H, F;
  int vec;
};

template <typename T, int ACT>
__global__ void __launch_bounds__(256, 1) glu_kernel(const GluArgs a) {
  using G = Gemm<T, kBM, kBN, 2, true, false>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  int tm, tn;
  swizzle(blockIdx.x, (a.T + kBM - 1) / kBM, (a.F + kBN - 1) / kBN, tm, tn);
  const int m0 = tm * kBM, n0 = tn * kBN;
  const Operand<T> A{static_cast<const T*>(a.x), a.H};
  const Operand<T> B[2] = {{static_cast<const T*>(a.wg), a.F},
                           {static_cast<const T*>(a.wu), a.F}};
  G g;
  g.run(smem, A, B, a.T, a.F, a.H, m0, n0, a.vec);
  T* out = static_cast<T*>(a.out);
  const bool pair = a.F % 2 == 0;
  g.for_each([&](int r, int c, const float (&v)[2][2]) {
    const int row = m0 + r;
    if (row >= a.T) return;
    store_pair<T>(out + size_t(row) * a.F + n0, c, a.F - n0,
                  activate<ACT>(v[0][0]) * v[1][0],
                  activate<ACT>(v[0][1]) * v[1][1], pair);
  });
}

template <typename T, int ACT>
int launch(const GluArgs& a, cudaStream_t st) {
  using G = Gemm<T, kBM, kBN, 2, true, false>;
  static bool attr_set = false;
  auto kern = glu_kernel<T, ACT>;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(G::SMEM));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int tiles = ((a.T + kBM - 1) / kBM) * ((a.F + kBN - 1) / kBN);
  kern<<<tiles, 256, G::SMEM, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_act(const GluArgs& a, int act, cudaStream_t st) {
  if (act == kSilu) return launch<T, kSilu>(a, st);
  if (act == kGelu) return launch<T, kGelu>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (T, H), wg and wu (H, F), out (T, F), contiguous in `dtype`; act 0 silu,
// 1 tanh-gelu. vec: H and F are multiples of 16 bytes of elements and the
// pointers 16-byte aligned.
extern "C" int apex1_glu_fwd(const void* x, const void* wg, const void* wu,
                             void* out, int T, int H, int F, int act, int vec,
                             int dtype, void* stream) {
  if (T <= 0 || F <= 0) return 0;
  if (H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  GluArgs a{x, wg, wu, out, T, H, F, vec};
  cudaStream_t st = as_stream(stream);
  switch (dtype) {
    case kF32:
      return launch_act<float>(a, act, st);
    case kBF16:
      return launch_act<__nv_bfloat16>(a, act, st);
    case kF16:
      return launch_act<__half>(a, act, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
