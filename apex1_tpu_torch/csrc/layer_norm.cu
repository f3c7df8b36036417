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
// Design: one block per row. The threads stride over H, accumulate
// sum(x) and sum(x^2) in fp32, reduce them across the block with warp
// shuffles, and form the variance as E[x^2] - mean^2, as the TPU kernel
// and the plain version do. A second pass over the row (now in L1/L2)
// writes y = (x - mean) * rstd * gamma + beta in x's dtype, and thread
// 0 writes the row's mean and rstd. Template over x's dtype (f32, bf16,
// f16) and the RMS flag (no mean subtraction, no beta).

#include "common.cuh"

template <typename T, bool RMS>
__global__ void layer_norm_fwd_kernel(const T* __restrict__ x,
                                      const float* __restrict__ gamma,
                                      const float* __restrict__ beta,
                                      T* __restrict__ y,
                                      float* __restrict__ mean_out,
                                      float* __restrict__ rstd_out, int h,
                                      float eps) {
  const size_t row = blockIdx.x;
  const T* xr = x + row * h;
  T* yr = y + row * h;
  float s = 0.f, ss = 0.f;
  for (int c = threadIdx.x; c < h; c += blockDim.x) {
    const float v = to_f32(xr[c]);
    s += v;
    ss += v * v;
  }
  __shared__ float red[2][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  s = warp_sum(s);
  ss = warp_sum(ss);
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = ss;
  }
  __syncthreads();
  if (warp == 0) {
    s = lane < n_warps ? red[0][lane] : 0.f;
    ss = lane < n_warps ? red[1][lane] : 0.f;
    s = warp_sum(s);
    ss = warp_sum(ss);
    if (lane == 0) {
      red[0][0] = s;
      red[1][0] = ss;
    }
  }
  __syncthreads();
  const float inv_h = 1.f / static_cast<float>(h);
  const float mean = RMS ? 0.f : red[0][0] * inv_h;
  const float var = red[1][0] * inv_h - mean * mean;
  const float rstd = rsqrtf(var + eps);
  for (int c = threadIdx.x; c < h; c += blockDim.x) {
    float v = (to_f32(xr[c]) - mean) * rstd * gamma[c];
    if (beta != nullptr) v += beta[c];
    yr[c] = from_f32<T>(v);
  }
  if (threadIdx.x == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T>
static void launch_ln(const void* x, const float* gamma, const float* beta,
                      void* y, float* mean, float* rstd, int rows, int h,
                      float eps, bool rms, cudaStream_t stream) {
  int threads = ((h + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  if (rms)
    layer_norm_fwd_kernel<T, true><<<rows, threads, 0, stream>>>(
        static_cast<const T*>(x), gamma, beta, static_cast<T*>(y), mean,
        rstd, h, eps);
  else
    layer_norm_fwd_kernel<T, false><<<rows, threads, 0, stream>>>(
        static_cast<const T*>(x), gamma, beta, static_cast<T*>(y), mean,
        rstd, h, eps);
}

extern "C" int apex1_layer_norm_fwd(const void* x, const void* gamma,
                                    const void* beta, void* y, void* mean,
                                    void* rstd, int rows, int h, float eps,
                                    int rms, int dtype, void* stream) {
  if (rows <= 0 || h <= 0) return 0;
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  float* m = static_cast<float*>(mean);
  float* r = static_cast<float*>(rstd);
  cudaStream_t st = as_stream(stream);
  switch (dtype) {
    case kF32:
      launch_ln<float>(x, g, b, y, m, r, rows, h, eps, rms, st);
      break;
    case kBF16:
      launch_ln<__nv_bfloat16>(x, g, b, y, m, r, rows, h, eps, rms, st);
      break;
    case kF16:
      launch_ln<__half>(x, g, b, y, m, r, rows, h, eps, rms, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
