// LayerNorm / RMSNorm backward for Hopper (sm_90a).
//
// Replaces: apex1_tpu/ops/layer_norm.py::_bwd_kernel (launched by
// _pallas_bwd), the Pallas TPU kernel that writes dx for a (rows, H)
// block from the saved fp32 mean/rstd and accumulates dgamma/dbeta into
// one output block across the sequential grid.
//
// Bound on the H100: memory. x and dy are read and dx written once,
// about a dozen flops per element (far below the ~20 flops per byte at
// which the fp32 CUDA cores would become the limit). At GPT-2's training
// shape (16384 x 768 bf16) that is ~75 MB, ~23 us at 3.35 TB/s.
//
// Design. Hopper blocks run in no order, so the TPU kernel's running
// dgamma/dbeta sum over a sequential grid becomes two passes, with no
// atomics, so the result is the same from run to run:
//   1. ln_bwd_rows: block g takes a fixed run of rows. For each row the
//      block reduces sum(xhat * w) and sum(w) (w = dy * gamma) with warp
//      shuffles, then writes dx = (w - c2 - xhat * c1) * rstd in x's
//      dtype. Each column's dgamma/dbeta partial lives in shared memory
//      and is owned by one thread (column c by thread c % blockDim), so
//      it needs no synchronisation. The block writes its partials to an
//      fp32 workspace row g of (2, G, H).
//   2. ln_bwd_cols: one thread per column sums the G partials in order
//      and writes dgamma (and dbeta) in gamma's dtype, as the JAX
//      package casts them.

#include "common.cuh"

template <typename T, bool RMS>
__global__ void ln_bwd_rows(const T* __restrict__ x,
                            const float* __restrict__ gamma,
                            const float* __restrict__ mean,
                            const float* __restrict__ rstd,
                            const T* __restrict__ dy, T* __restrict__ dx,
                            float* __restrict__ part, int rows, int h,
                            int rows_per_block) {
  extern __shared__ float acc[];  // [2 * h]: dgamma, dbeta partials
  float* ag = acc;
  float* ab = acc + h;
  for (int c = threadIdx.x; c < h; c += blockDim.x) {
    ag[c] = 0.f;
    ab[c] = 0.f;
  }
  __shared__ float red[2][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const float inv_h = 1.f / static_cast<float>(h);
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(r0 + rows_per_block, rows);
  for (int r = r0; r < r1; ++r) {
    const T* xr = x + static_cast<size_t>(r) * h;
    const T* dyr = dy + static_cast<size_t>(r) * h;
    const float mu = mean[r], rs = rstd[r];
    float s1 = 0.f, s2 = 0.f;
    for (int c = threadIdx.x; c < h; c += blockDim.x) {
      const float xh = (to_f32(xr[c]) - mu) * rs;
      const float d = to_f32(dyr[c]);
      const float w = d * gamma[c];
      s1 += xh * w;
      s2 += w;
      ag[c] += d * xh;
      ab[c] += d;
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      red[0][warp] = s1;
      red[1][warp] = s2;
    }
    __syncthreads();
    if (warp == 0) {
      s1 = lane < n_warps ? red[0][lane] : 0.f;
      s2 = lane < n_warps ? red[1][lane] : 0.f;
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) {
        red[0][0] = s1;
        red[1][0] = s2;
      }
    }
    __syncthreads();
    const float c1 = red[0][0] * inv_h;
    const float c2 = RMS ? 0.f : red[1][0] * inv_h;
    __syncthreads();  // red is rewritten by the next row
    T* dxr = dx + static_cast<size_t>(r) * h;
    for (int c = threadIdx.x; c < h; c += blockDim.x) {
      const float xh = (to_f32(xr[c]) - mu) * rs;
      const float w = to_f32(dyr[c]) * gamma[c];
      const float v = RMS ? (w - xh * c1) * rs : (w - c2 - xh * c1) * rs;
      dxr[c] = from_f32<T>(v);
    }
  }
  const int groups = gridDim.x;
  float* pg = part + static_cast<size_t>(blockIdx.x) * h;
  float* pb = part + (static_cast<size_t>(groups) + blockIdx.x) * h;
  for (int c = threadIdx.x; c < h; c += blockDim.x) {
    pg[c] = ag[c];
    pb[c] = ab[c];
  }
}

// blockIdx.y 0: dgamma from part[0]; 1: dbeta from part[1]
template <typename G>
__global__ void ln_bwd_cols(const float* __restrict__ part, G* __restrict__ dg,
                            G* __restrict__ db, int groups, int h) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= h) return;
  const float* p = part + static_cast<size_t>(blockIdx.y) * groups * h;
  float s = 0.f;
  for (int g = 0; g < groups; ++g) s += p[static_cast<size_t>(g) * h + c];
  (blockIdx.y == 0 ? dg : db)[c] = from_f32<G>(s);
}

template <typename T>
static void launch_rows(const void* x, const float* gamma, const float* mean,
                        const float* rstd, const void* dy, void* dx,
                        float* part, int rows, int h, int rows_per_block,
                        int groups, bool rms, cudaStream_t st) {
  int threads = ((h + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  const size_t smem = 2 * static_cast<size_t>(h) * sizeof(float);
  if (rms)
    ln_bwd_rows<T, true><<<groups, threads, smem, st>>>(
        static_cast<const T*>(x), gamma, mean, rstd,
        static_cast<const T*>(dy), static_cast<T*>(dx), part, rows, h,
        rows_per_block);
  else
    ln_bwd_rows<T, false><<<groups, threads, smem, st>>>(
        static_cast<const T*>(x), gamma, mean, rstd,
        static_cast<const T*>(dy), static_cast<T*>(dx), part, rows, h,
        rows_per_block);
}

template <typename G>
static void launch_cols(const float* part, void* dg, void* db, int groups,
                        int h, int with_beta, cudaStream_t st) {
  dim3 grid((h + 255) / 256, with_beta ? 2 : 1);
  ln_bwd_cols<G><<<grid, 256, 0, st>>>(part, static_cast<G*>(dg),
                                       static_cast<G*>(db), groups, h);
}

// x, dy, dx: (rows, h) in `dtype`; gamma (h,) fp32; mean, rstd (rows,)
// fp32; part: fp32 workspace (2, groups, h); dg, db: (h,) in
// `param_dtype` (db null without beta). groups * rows_per_block >= rows.
extern "C" int apex1_layer_norm_bwd(const void* x, const void* gamma,
                                    const void* mean, const void* rstd,
                                    const void* dy, void* dx, void* part,
                                    void* dg, void* db, int rows, int h,
                                    int rows_per_block, int groups, int rms,
                                    int with_beta, int dtype,
                                    int param_dtype, void* stream) {
  if (rows <= 0 || h <= 0) return 0;
  const float* g = static_cast<const float*>(gamma);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  float* p = static_cast<float*>(part);
  cudaStream_t st = as_stream(stream);
  switch (dtype) {
    case kF32:
      launch_rows<float>(x, g, m, r, dy, dx, p, rows, h, rows_per_block,
                         groups, rms, st);
      break;
    case kBF16:
      launch_rows<__nv_bfloat16>(x, g, m, r, dy, dx, p, rows, h,
                                 rows_per_block, groups, rms, st);
      break;
    case kF16:
      launch_rows<__half>(x, g, m, r, dy, dx, p, rows, h, rows_per_block,
                          groups, rms, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (param_dtype) {
    case kF32:
      launch_cols<float>(p, dg, db, groups, h, with_beta, st);
      break;
    case kBF16:
      launch_cols<__nv_bfloat16>(p, dg, db, groups, h, with_beta, st);
      break;
    case kF16:
      launch_cols<__half>(p, dg, db, groups, h, with_beta, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
