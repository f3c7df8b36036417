// LayerNorm / RMSNorm forward for Hopper (sm_90a).
//
// Replaces: apex1_tpu/ops/layer_norm.py::_fwd_kernel (launched by
// _pallas_fwd), the Pallas TPU kernel that normalizes (rows, H) blocks
// resident in VMEM with fp32 statistics.
//
// Bound on the H100: memory. Each element is read once and written once
// and costs about eight flops, far below the flops per byte where the
// CUDA cores would become the limit (H100 SXM: 67 TFLOP/s fp32 over
// 3.35 TB/s, about 20). At the serving engine's shapes (8 to 64 rows of
// H=768) the whole op is a few hundred KB, so the launch dominates.
//
// Design: a warp a row, four rows a block, so 8 decode rows, 16368 GPT-2
// rows and 8192 Llama rows all spread over the SMs with no block-wide
// barrier. Lane l holds the row's 16-byte chunks l, l + 32, ... (VPL of
// them, a template on H's range: up to 16, H = 4096 in bf16/fp16 and 2048
// in fp32) in registers: x is read from device memory once, every chunk
// of the lane in flight together, and y is written from the registers in
// 16-byte stores (where γ and β are small, H = 768, they are read
// together with x). sum(x) and sum(x^2) in fp32 over the lane's chunks in
// order, then a butterfly over the warp (every lane ends with the same
// bits); the variance is E[x^2] - mean^2, as the TPU kernel and the plain
// version form it, rstd = rsqrt(var + eps), and y = (x - mean) * rstd *
// gamma + beta in x's dtype. RMS: mean 0, no beta. gamma and beta are read
// in their own dtype (fp32, or x's half type under the amp policies'
// compute params) in 16-byte pieces and widened in registers, which is
// exact: the wrapper launches this one kernel and no cast. Lane 0 writes
// the row's mean and rstd. Rows that do not take the register path (H
// past 16 chunks a lane, H not a multiple of a chunk, a pointer not
// 16-byte aligned) run a warp a row in two passes over the row, the
// second from L2: by chunks where they are aligned, else value by value.

#include "chunks.cuh"

namespace {

constexpr int kRows = 4;  // rows (warps) a block

struct NormArgs {
  const void* x;
  const void* gamma;
  const void* beta;  // nullptr: none
  void* y;
  float* mean;
  float* rstd;
  int rows, h, rms;
  float eps;
};

// mean and rstd of a row from its fp32 sums (every lane the same bits)
__device__ __forceinline__ void row_stats(float s, float ss, int h, int rms,
                                          float eps, float& mean,
                                          float& rstd) {
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float inv_h = 1.f / static_cast<float>(h);
  mean = rms ? 0.f : s * inv_h;
  const float var = ss * inv_h - mean * mean;
  rstd = rsqrtf(var + eps);
}

// y's chunk (N values from v) = (v - mean) * rstd * gamma + beta, γ and β
// as their 16-byte pieces
template <typename T, typename G>
__device__ __forceinline__ uint4 norm_chunk(
    float (&v)[Chunk<T>::N], const uint4 (&gr)[Pieces<G, Chunk<T>::N>::P],
    const uint4 (&br)[Pieces<G, Chunk<T>::N>::P], bool beta, float mean,
    float rstd) {
  constexpr int N = Chunk<T>::N;
  float g[N];
  Pieces<G, N>::widen(gr, g);
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = (v[i] - mean) * rstd * g[i];
  if (beta) {
    float b[N];
    Pieces<G, N>::widen(br, b);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += b[i];
  }
  return Chunk<T>::narrow(v);
}

// y's chunk c, γ and β read from device memory
template <typename T, typename G>
__device__ __forceinline__ uint4 norm_chunk_at(float (&v)[Chunk<T>::N],
                                               const G* gamma, const G* beta,
                                               int c, float mean,
                                               float rstd) {
  using Pc = Pieces<G, Chunk<T>::N>;
  uint4 gr[Pc::P], br[Pc::P];
  Pc::load(gamma + c * Chunk<T>::N, gr);
  if (beta != nullptr) Pc::load(beta + c * Chunk<T>::N, br);
  return norm_chunk<T, G>(v, gr, br, beta != nullptr, mean, rstd);
}

// the register path: VPL chunks a lane, H a multiple of a chunk, every
// pointer 16-byte aligned. Where γ and β take at most 256 bytes a lane
// (H = 768: VPL 3 in bf16/fp16, 6 in fp32), they are read together with x,
// so a short launch waits for one round of loads, not two.
template <typename T, typename G, int VPL>
__global__ void __launch_bounds__(kRows * 32)
    layer_norm_fwd_kernel(const NormArgs a) {
  constexpr int N = Chunk<T>::N;
  using Pc = Pieces<G, N>;
  constexpr bool PRE = 2 * VPL * Pc::P * 16 <= 256;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRows + threadIdx.x / 32;
  if (row >= a.rows) return;  // the whole warp
  const int nch = a.h / N;
  const uint4* xr =
      static_cast<const uint4*>(a.x) + static_cast<size_t>(row) * nch;
  const G* gamma = static_cast<const G*>(a.gamma);
  const G* beta = static_cast<const G*>(a.beta);
  const bool has_beta = beta != nullptr;
  uint4 raw[VPL];
  uint4 gr[PRE ? VPL : 1][Pc::P], br[PRE ? VPL : 1][Pc::P];
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int c = k * 32 + lane;
    raw[k] = c < nch ? xr[c] : make_uint4(0, 0, 0, 0);
    if constexpr (PRE) {
      if (c < nch) {
        Pc::load(gamma + c * N, gr[k]);
        if (has_beta) Pc::load(beta + c * N, br[k]);
      }
    }
  }
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    float v[N];
    Chunk<T>::widen(raw[k], v);  // the zero chunks past the row add 0
#pragma unroll
    for (int i = 0; i < N; ++i) {
      s += v[i];
      ss += v[i] * v[i];
    }
  }
  float mean, rstd;
  row_stats(s, ss, a.h, a.rms, a.eps, mean, rstd);
  uint4* yr = static_cast<uint4*>(a.y) + static_cast<size_t>(row) * nch;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int c = k * 32 + lane;
    if (c < nch) {
      float v[N];
      Chunk<T>::widen(raw[k], v);
      if constexpr (PRE)
        yr[c] = norm_chunk<T, G>(v, gr[k], br[k], has_beta, mean, rstd);
      else
        yr[c] = norm_chunk_at<T, G>(v, gamma, beta, c, mean, rstd);
    }
  }
  if (lane == 0) {
    a.mean[row] = mean;
    a.rstd[row] = rstd;
  }
}

// the two-pass path, a warp a row: by 16-byte chunks (VEC) or value by
// value
template <typename T, typename G, bool VEC>
__global__ void __launch_bounds__(kRows * 32)
    layer_norm_fwd_rows_kernel(const NormArgs a) {
  constexpr int N = Chunk<T>::N;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRows + threadIdx.x / 32;
  if (row >= a.rows) return;
  const T* xr = static_cast<const T*>(a.x) + static_cast<size_t>(row) * a.h;
  T* yr = static_cast<T*>(a.y) + static_cast<size_t>(row) * a.h;
  const G* gamma = static_cast<const G*>(a.gamma);
  const G* beta = static_cast<const G*>(a.beta);
  const int nch = VEC ? a.h / N : 0;  // chunks a row (VEC)
  float s = 0.f, ss = 0.f;
  if constexpr (VEC) {
    for (int c = lane; c < nch; c += 32) {
      float v[N];
      Chunk<T>::widen(reinterpret_cast<const uint4*>(xr)[c], v);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        s += v[i];
        ss += v[i] * v[i];
      }
    }
  } else {
    for (int c = lane; c < a.h; c += 32) {
      const float v = to_f32(xr[c]);
      s += v;
      ss += v * v;
    }
  }
  float mean, rstd;
  row_stats(s, ss, a.h, a.rms, a.eps, mean, rstd);
  if constexpr (VEC) {
    for (int c = lane; c < nch; c += 32) {
      float v[N];
      Chunk<T>::widen(reinterpret_cast<const uint4*>(xr)[c], v);
      reinterpret_cast<uint4*>(yr)[c] =
          norm_chunk_at<T, G>(v, gamma, beta, c, mean, rstd);
    }
  } else {
    for (int c = lane; c < a.h; c += 32) {
      float v = (to_f32(xr[c]) - mean) * rstd * to_f32(gamma[c]);
      if (beta != nullptr) v += to_f32(beta[c]);
      yr[c] = from_f32<T>(v);
    }
  }
  if (lane == 0) {
    a.mean[row] = mean;
    a.rstd[row] = rstd;
  }
}

template <typename T, typename G>
int launch_ln(const NormArgs& a, cudaStream_t st) {
  constexpr int N = Chunk<T>::N;
  const int blocks = (a.rows + kRows - 1) / kRows;
  const bool vec = a.h % N == 0 && aligned16(a.x) && aligned16(a.y) &&
                   aligned16(a.gamma) &&
                   (a.beta == nullptr || aligned16(a.beta));
  const int vpl = (a.h / N + 31) / 32;  // chunks a lane
  void (*kern)(const NormArgs) =
      !vec       ? layer_norm_fwd_rows_kernel<T, G, false>
      : vpl <= 1  ? layer_norm_fwd_kernel<T, G, 1>
      : vpl <= 2  ? layer_norm_fwd_kernel<T, G, 2>
      : vpl <= 3  ? layer_norm_fwd_kernel<T, G, 3>
      : vpl <= 4  ? layer_norm_fwd_kernel<T, G, 4>
      : vpl <= 6  ? layer_norm_fwd_kernel<T, G, 6>
      : vpl <= 8  ? layer_norm_fwd_kernel<T, G, 8>
      : vpl <= 12 ? layer_norm_fwd_kernel<T, G, 12>
      : vpl <= 16 ? layer_norm_fwd_kernel<T, G, 16>
                  : layer_norm_fwd_rows_kernel<T, G, true>;
  note_launch(kern, 0, kRows * 32);
  kern<<<blocks, kRows * 32, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// γ/β in fp32 or in x's own half type
template <typename T>
int launch_g(const NormArgs& a, int gdtype, int dtype, cudaStream_t st) {
  if (gdtype == kF32) return launch_ln<T, float>(a, st);
  if (gdtype == dtype) return launch_ln<T, T>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x, y (rows, h) in `dtype`; gamma, beta (h,) in `gdtype` (fp32, or
// `dtype`), beta nullptr for none; mean, rstd (rows,) fp32
extern "C" int apex1_layer_norm_fwd(const void* x, const void* gamma,
                                    const void* beta, void* y, void* mean,
                                    void* rstd, int rows, int h, float eps,
                                    int rms, int dtype, int gdtype,
                                    void* stream) {
  if (rows <= 0 || h <= 0) return 0;
  const NormArgs a{x,    gamma, beta, y, static_cast<float*>(mean),
                   static_cast<float*>(rstd), rows, h, rms, eps};
  cudaStream_t st = as_stream(stream);
  switch (dtype) {
    case kF32:
      return launch_g<float>(a, gdtype, dtype, st);
    case kBF16:
      return launch_g<__nv_bfloat16>(a, gdtype, dtype, st);
    case kF16:
      return launch_g<__half>(a, gdtype, dtype, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
