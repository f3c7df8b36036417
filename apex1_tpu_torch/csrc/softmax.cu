// Fused scale + mask + softmax, forward and backward, for Hopper (sm_90a).
//
// Replaces: apex1_tpu/ops/softmax.py::_fwd_kernel (launched by
// _pallas_softmax_fwd) and ::_bwd_kernel (launched by
// _pallas_softmax_bwd), the Pallas TPU kernels behind
// scaled_masked_softmax and scaled_upper_triang_masked_softmax.
//
//   forward:  y  = softmax(scale * x + mask), causal: columns past the
//             row's query index set to NEG_INF before the max
//   backward: dx = scale * y * (dy - sum(y * dy))
//
// Bound on the H100: memory. A few flops per element against 4 bytes
// read and 4 written (fp32 on GPT-2's path: (16, 12, 1024, 1024) scores;
// the causal forward reads only the lower triangle, 1.2 GB, and the
// backward moves 2.4 GB per layer).
//
// Design: one warp per row of (B, H, Sq, Sk), eight rows per block. The
// TPU kernel takes a (rows, Sk) block and its causal row index from the
// grid position; here the query index comes from the row's own place in
// (B, H, Sq), so the kernel needs no padding of Sq or Sk. The forward
// streams the row twice: each lane folds its columns into a running
// (max, sum of exp) pair, the 32 pairs are joined with shuffles, and a
// second pass (the 4 KB row is still in L1/L2) writes exp(v - max) *
// (1 / sum). A causal row reads only its first q + 1 columns and writes
// the rest as 0. The additive mask is read through four strides, 0 on a
// broadcast dimension, so a (B, 1, Sq, Sk) or (1, 1, 1, Sk) mask is
// never expanded. The backward keeps a row of up to 1024 columns of y
// and dy in the lanes' registers (32 values a lane), so each is read
// once, reduces sum(y * dy) with shuffles and writes dx; a longer row is
// streamed twice. (Measured on the H100 at GPT-2's shape: the resident
// forward, max then exp then sum, ran 1.5x slower than the streamed one
// above, the resident backward 1.7x faster than a streamed one.)

#include "common.cuh"

__device__ __forceinline__ void fold(float& m, float& s, float v) {
  if (v > m) {
    s = s * expf(m - v) + 1.f;
    m = v;
  } else {
    s += expf(v - m);
  }
}

// columns a lane keeps in registers in the backward: rows of up to
// 32 * kItems stay resident, longer rows are streamed
static const int kItems = 32;

template <typename T>
__global__ void softmax_fwd_kernel(const T* __restrict__ x,
                                   const float* __restrict__ mask,
                                   T* __restrict__ y, long long rows, int nh,
                                   int sq, int sk, float scale, int causal,
                                   long long msb, long long msh,
                                   long long msq, long long msk) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp leaves together
  const int q = static_cast<int>(row % sq);
  const long long bh = row / sq;
  const int hh = static_cast<int>(bh % nh);
  const long long b = bh / nh;
  const T* xr = x + row * sk;
  const float* mr =
      mask == nullptr ? nullptr : mask + b * msb + hh * msh + q * msq;
  auto value = [&](int c) {
    float v = to_f32(xr[c]) * scale;
    if (mr != nullptr) v += mr[c * msk];
    return v;
  };
  // causal: the TPU kernel sets the columns past q to NEG_INF (-1e30),
  // whose exp underflows to exactly 0, so here they are neither read
  // nor exponentiated, and written as 0
  const int end = causal ? min(q + 1, sk) : sk;
  float m = -3.402823466e38f, s = 0.f;
  for (int c = lane; c < end; c += 32) fold(m, s, value(c));
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    const float mx = fmaxf(m, m2);
    s = s * expf(m - mx) + s2 * expf(m2 - mx);
    m = mx;
  }
  const float inv = 1.f / s;
  T* yr = y + row * sk;
  for (int c = lane; c < sk; c += 32)
    yr[c] = from_f32<T>(c < end ? expf(value(c) - m) * inv : 0.f);
}

// ITEMS > 0: y and dy live in registers (sk <= 32 * ITEMS); 0: streamed
template <typename T, int ITEMS>
__global__ void softmax_bwd_kernel(const T* __restrict__ y,
                                   const T* __restrict__ dy,
                                   T* __restrict__ dx, long long rows, int sk,
                                   float scale) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* yr = y + row * sk;
  const T* dyr = dy + row * sk;
  T* dxr = dx + row * sk;
  float dot = 0.f;
  float ry[ITEMS > 0 ? ITEMS : 1], rd[ITEMS > 0 ? ITEMS : 1];
  if constexpr (ITEMS > 0) {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int c = lane + 32 * i;
      if (c < sk) {
        ry[i] = to_f32(yr[c]);
        rd[i] = to_f32(dyr[c]);
        dot += ry[i] * rd[i];
      }
    }
  } else {
    for (int c = lane; c < sk; c += 32)
      dot += to_f32(yr[c]) * to_f32(dyr[c]);
  }
  dot = warp_sum(dot);
  if constexpr (ITEMS > 0) {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int c = lane + 32 * i;
      if (c < sk) dxr[c] = from_f32<T>(scale * ry[i] * (rd[i] - dot));
    }
  } else {
    for (int c = lane; c < sk; c += 32) {
      const float yv = to_f32(yr[c]);
      dxr[c] = from_f32<T>(scale * yv * (to_f32(dyr[c]) - dot));
    }
  }
}

static const int kRowsPerBlock = 8;

template <typename T>
static void launch_fwd(const void* x, const float* mask, void* y,
                       long long rows, int nh, int sq, int sk, float scale,
                       int causal, const long long* ms, cudaStream_t st) {
  const unsigned blocks =
      static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  softmax_fwd_kernel<T><<<blocks, 32 * kRowsPerBlock, 0, st>>>(
      static_cast<const T*>(x), mask, static_cast<T*>(y), rows, nh, sq, sk,
      scale, causal, ms[0], ms[1], ms[2], ms[3]);
}

template <typename T>
static void launch_bwd(const void* y, const void* dy, void* dx,
                       long long rows, int sk, float scale, cudaStream_t st) {
  const unsigned blocks =
      static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  if (sk <= 32 * kItems)
    softmax_bwd_kernel<T, kItems><<<blocks, 32 * kRowsPerBlock, 0, st>>>(
        static_cast<const T*>(y), static_cast<const T*>(dy),
        static_cast<T*>(dx), rows, sk, scale);
  else
    softmax_bwd_kernel<T, 0><<<blocks, 32 * kRowsPerBlock, 0, st>>>(
        static_cast<const T*>(y), static_cast<const T*>(dy),
        static_cast<T*>(dx), rows, sk, scale);
}

// x, y: (b, nh, sq, sk) contiguous in `dtype`; mask: fp32 or null, read
// at b * msb + h * msh + q * msq + c * msk (0 strides broadcast).
extern "C" int apex1_softmax_fwd(const void* x, const void* mask, void* y,
                                 int b, int nh, int sq, int sk, float scale,
                                 int causal, long long msb, long long msh,
                                 long long msq, long long msk, int dtype,
                                 void* stream) {
  const long long rows = static_cast<long long>(b) * nh * sq;
  if (rows <= 0 || sk <= 0) return 0;
  const long long ms[4] = {msb, msh, msq, msk};
  const float* m = static_cast<const float*>(mask);
  cudaStream_t st = as_stream(stream);
  switch (dtype) {
    case kF32:
      launch_fwd<float>(x, m, y, rows, nh, sq, sk, scale, causal, ms, st);
      break;
    case kBF16:
      launch_fwd<__nv_bfloat16>(x, m, y, rows, nh, sq, sk, scale, causal, ms,
                                st);
      break;
    case kF16:
      launch_fwd<__half>(x, m, y, rows, nh, sq, sk, scale, causal, ms, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// y, dy, dx: (rows, sk) contiguous in `dtype`
extern "C" int apex1_softmax_bwd(const void* y, const void* dy, void* dx,
                                 long long rows, int sk, float scale,
                                 int dtype, void* stream) {
  if (rows <= 0 || sk <= 0) return 0;
  cudaStream_t st = as_stream(stream);
  switch (dtype) {
    case kF32:
      launch_bwd<float>(y, dy, dx, rows, sk, scale, st);
      break;
    case kBF16:
      launch_bwd<__nv_bfloat16>(y, dy, dx, rows, sk, scale, st);
      break;
    case kF16:
      launch_bwd<__half>(y, dy, dx, rows, sk, scale, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
