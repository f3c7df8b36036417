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
// blocks in VMEM and forms each dot over all of H at once. Here bf16/fp16
// run on gemm_wg.cuh's wgmma product with two B operands sharing A: a
// block of two warpgroups owns a 128 x BN output tile, and each stage of
// its cp.async ring holds one x tile (128 x 64, K-major) and the Wg and Wu
// tiles at the same columns (64 x BN, N-major: wgmma's transpose bit), so
// x is read once for the pair. Each warpgroup keeps two m64nBN fp32
// accumulator sets in registers, gate and up (BN = 128: 128 registers a
// thread); g and u never leave them: the epilogue forms act(g)·u on the
// fragments in fp32 (ACT a template argument: no per-element branch) and
// stores the tile in x's dtype. BN is 128 (four stages of 48 KB) when the
// grid has at least four waves of such tiles on the 132 SMs, else 64 (six
// stages of 32 KB), so a short grid (a serving chunk of 512 rows) leaves
// a smaller last wave. Blocks walk the output in groups of 8 row tiles
// so that the x and W tiles in flight share L2. Ragged T, F and H are
// zero-filled in shared memory, nothing is padded in device memory.
// fp32 runs on mma.cuh's `Gemm` (plain FMA on the CUDA cores, no TF32,
// 128 x 64 tiles, H in 16-deep steps). Not yet: TMA, a persistent grid.

#include "gemm_wg.cuh"

namespace {

constexpr int kSMs = 132;  // the H100 SXM's
constexpr int kBM = 128, kBNF32 = 64;
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

int n_tiles(int T, int F, int bn) {
  return ((T + kBM - 1) / kBM) * ((F + bn - 1) / bn);
}

// the output tile's columns for a T x F output in `dtype`
int tile_n(int T, int F, int dtype) {
  if (dtype == kF32) return kBNF32;
  return n_tiles(T, F, 128) >= 4 * kSMs ? 128 : 64;
}

template <int BN>
constexpr int kWgStages = BN == 128 ? 4 : 6;

template <typename T, int ACT, int BN>
__global__ void __launch_bounds__(256, 1) glu_wg_kernel(const GluArgs a) {
  using P = wg::Gemm<T, BN, kWgStages<BN>, false, true, 2>;
  extern __shared__ __align__(1024) unsigned char glu_smem[];
  int tm, tn;
  swizzle(blockIdx.x, (a.T + kBM - 1) / kBM, (a.F + BN - 1) / BN, tm, tn);
  const int m0 = tm * kBM, n0 = tn * BN;
  const T* b[2] = {static_cast<const T*>(a.wg), static_cast<const T*>(a.wu)};
  P p;
  p.run(glu_smem, static_cast<const T*>(a.x), a.H, b, a.F, a.T, a.F, a.H,
        m0, n0, a.vec != 0, a.vec != 0);
  T* out = static_cast<T*>(a.out);
  const bool pair = a.F % 2 == 0;
  p.for_each_pair([&](int r, int c, float g0, float g1, float u0, float u1) {
    const int row = m0 + r;
    if (row < a.T)
      store_pair<T>(out + size_t(row) * a.F + n0, c, a.F - n0,
                    activate<ACT>(g0) * u0, activate<ACT>(g1) * u1, pair);
  });
}

template <typename T, int ACT, int BN>
int launch_wg(const GluArgs& a, cudaStream_t st) {
  constexpr size_t smem = wg::Gemm<T, BN, kWgStages<BN>, false, true,
                                   2>::SMEM;
  static bool attr_set = false;
  auto kern = glu_wg_kernel<T, ACT, BN>;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  note_launch(kern, smem, 256);
  kern<<<n_tiles(a.T, a.F, BN), 256, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int ACT>
__global__ void __launch_bounds__(256, 1) glu_f32_kernel(const GluArgs a) {
  using G = Gemm<float, kBM, kBNF32, 2, true, false>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  int tm, tn;
  swizzle(blockIdx.x, (a.T + kBM - 1) / kBM, (a.F + kBNF32 - 1) / kBNF32,
          tm, tn);
  const int m0 = tm * kBM, n0 = tn * kBNF32;
  const Operand<float> A{static_cast<const float*>(a.x), a.H};
  const Operand<float> B[2] = {{static_cast<const float*>(a.wg), a.F},
                               {static_cast<const float*>(a.wu), a.F}};
  G g;
  g.run(smem, A, B, a.T, a.F, a.H, m0, n0, a.vec);
  float* out = static_cast<float*>(a.out);
  const bool pair = a.F % 2 == 0;
  g.for_each([&](int r, int c, const float (&v)[2][2]) {
    const int row = m0 + r;
    if (row >= a.T) return;
    store_pair<float>(out + size_t(row) * a.F + n0, c, a.F - n0,
                      activate<ACT>(v[0][0]) * v[1][0],
                      activate<ACT>(v[0][1]) * v[1][1], pair);
  });
}

template <int ACT>
int launch_f32(const GluArgs& a, cudaStream_t st) {
  using G = Gemm<float, kBM, kBNF32, 2, true, false>;
  static bool attr_set = false;
  auto kern = glu_f32_kernel<ACT>;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(G::SMEM));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  note_launch(kern, G::SMEM, 256);
  kern<<<n_tiles(a.T, a.F, kBNF32), 256, G::SMEM, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int ACT>
int launch_half(const GluArgs& a, int bn, cudaStream_t st) {
  return bn == 128 ? launch_wg<T, ACT, 128>(a, st)
                   : launch_wg<T, ACT, 64>(a, st);
}

template <int ACT>
int launch(const GluArgs& a, int dtype, int bn, cudaStream_t st) {
  switch (dtype) {
    case kF32:
      return launch_f32<ACT>(a, st);
    case kBF16:
      return launch_half<__nv_bfloat16, ACT>(a, bn, st);
    case kF16:
      return launch_half<__half, ACT>(a, bn, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (T, H), wg and wu (H, F), out (T, F), contiguous in `dtype`; act 0 silu,
// 1 tanh-gelu. vec: H and F are multiples of 16 bytes of elements and the
// pointers 16-byte aligned. tile: the output tile's columns, 64 or 128
// (bf16/fp16; fp32 has 64 only), or 0 for tile_n's choice.
extern "C" int apex1_glu_fwd(const void* x, const void* wg, const void* wu,
                             void* out, int T, int H, int F, int act, int vec,
                             int dtype, int tile, void* stream) {
  if (T <= 0 || F <= 0) return 0;
  const int bn = tile != 0 ? tile : tile_n(T, F, dtype);
  if (H <= 0 || (dtype == kF32 ? bn != kBNF32 : bn != 64 && bn != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  GluArgs a{x, wg, wu, out, T, H, F, vec};
  cudaStream_t st = as_stream(stream);
  if (act == kSilu) return launch<kSilu>(a, dtype, bn, st);
  if (act == kGelu) return launch<kGelu>(a, dtype, bn, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the output tile apex1_glu_fwd launches for a T x F output in `dtype`, as
// rows·1000 + columns
extern "C" int apex1_glu_tile(int T, int F, int dtype) {
  return kBM * 1000 + tile_n(T, F, dtype);
}
