// Softmax cross-entropy with label smoothing, forward and backward, for
// Hopper (sm_90a).
//
// Replaces: apex1_tpu/ops/xentropy.py::_fwd_kernel (launched by
// _fused_xent_fwd) and ::_bwd_kernel (launched by _fused_xent_bwd), the
// Pallas TPU kernels behind softmax_cross_entropy_loss (apex's
// contrib.xentropy). Per row i with target t, eps = smoothing, K the
// number of real classes (columns >= K are padding):
//   lse_i  = log sum_{k<K} exp(x_ik)
//   loss_i = (1-eps) (lse_i - x_it) + eps (lse_i - sum_{k<K} x_ik / K)
//   dx_ik  = (exp(x_ik - lse_i) - (1-eps) [k == t] - eps / K) dloss_i,
//            0 for k >= K and for rows whose target is padding_idx.
// Only loss and lse leave the forward; the backward recomputes the
// softmax from the logits and lse, as the reference does.
//
// Bound on the H100: memory. GPT-2's rows are 50304 fp32 logits (201 KB,
// K = 50257), 16368 rows: the forward reads 3.3 GB, the backward reads
// 3.3 GB and writes 3.3 GB; a handful of flops per element.
//
// Design: one block of 256 threads per row; the row is too long for one
// block's registers, so the forward streams it once, each thread folding
// its columns into a running (max, sum of exp) pair plus sum(x), and the
// block joins the pairs with warp shuffles and shared memory. The target
// logit is one load. The backward streams the row once more and writes
// dx. Rows are addressed through two strides, so the (B, S-1, V) slice
// logits[:, :-1] of (B, S, V) logits is read in place.

#include "common.cuh"

static const int kThreads = 256;

__device__ __forceinline__ void fold(float& m, float& s, float v) {
  if (v > m) {
    s = s * expf(m - v) + 1.f;
    m = v;
  } else {
    s += expf(v - m);
  }
}

__device__ __forceinline__ void join(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2);
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

template <typename T>
__global__ void xent_fwd_kernel(const T* __restrict__ x,
                                const int* __restrict__ labels,
                                float* __restrict__ loss,
                                float* __restrict__ lse_out, int t_len,
                                long long s_a, long long s_t, int width,
                                int true_k, float smoothing,
                                float one_minus_smoothing, int has_pad,
                                int pad_idx) {
  const int row = blockIdx.x;
  const T* xr = x + (row / t_len) * s_a + (row % t_len) * s_t;
  float m = -3.402823466e38f, s = 0.f, sx = 0.f;
  for (int c = threadIdx.x; c < true_k; c += blockDim.x) {
    const float v = to_f32(xr[c]);
    fold(m, s, v);
    sx += v;
  }
  for (int o = 16; o > 0; o >>= 1) {
    join(m, s, __shfl_xor_sync(0xffffffffu, m, o),
         __shfl_xor_sync(0xffffffffu, s, o));
    sx += __shfl_xor_sync(0xffffffffu, sx, o);
  }
  __shared__ float red[3][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  if (lane == 0) {
    red[0][warp] = m;
    red[1][warp] = s;
    red[2][warp] = sx;
  }
  __syncthreads();
  if (warp != 0) return;
  m = lane < n_warps ? red[0][lane] : -3.402823466e38f;
  s = lane < n_warps ? red[1][lane] : 0.f;
  sx = lane < n_warps ? red[2][lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) {
    join(m, s, __shfl_xor_sync(0xffffffffu, m, o),
         __shfl_xor_sync(0xffffffffu, s, o));
    sx += __shfl_xor_sync(0xffffffffu, sx, o);
  }
  if (lane != 0) return;
  const int t = labels[row];
  const float tgt = (t >= 0 && t < width) ? to_f32(xr[t]) : 0.f;
  const float lse = m + logf(s);
  float l = one_minus_smoothing * (lse - tgt) +
            smoothing * (lse - sx / static_cast<float>(true_k));
  if (has_pad && t == pad_idx) l = 0.f;
  loss[row] = l;
  lse_out[row] = lse;
}

template <typename T>
__global__ void xent_bwd_kernel(const T* __restrict__ x,
                                const int* __restrict__ labels,
                                const float* __restrict__ lse,
                                const float* __restrict__ dloss,
                                T* __restrict__ dx, int t_len, long long s_a,
                                long long s_t, int width, int true_k,
                                float one_minus_smoothing, float eps_over_k,
                                int has_pad, int pad_idx) {
  const int row = blockIdx.x;
  const T* xr = x + (row / t_len) * s_a + (row % t_len) * s_t;
  T* dxr = dx + static_cast<size_t>(row) * width;
  const int t = labels[row];
  const float l = lse[row];
  const float d = (has_pad && t == pad_idx) ? 0.f : dloss[row];
  for (int c = threadIdx.x; c < width; c += blockDim.x) {
    float g = 0.f;
    if (c < true_k)
      g = expf(to_f32(xr[c]) - l) - one_minus_smoothing * (c == t ? 1.f : 0.f)
          - eps_over_k;
    dxr[c] = from_f32<T>(g * d);
  }
}

// x: rows of `width` logits in `dtype`; row r = a * t_len + t sits at
// a * s_a + t * s_t elements; labels int32; loss, lse: (rows,) fp32.
extern "C" int apex1_xent_fwd(const void* x, const void* labels, void* loss,
                              void* lse, int rows, int t_len, long long s_a,
                              long long s_t, int width, int true_k,
                              float smoothing, float one_minus_smoothing,
                              int has_pad, int pad_idx, int dtype,
                              void* stream) {
  if (rows <= 0) return 0;
  const int* lab = static_cast<const int*>(labels);
  float* lo = static_cast<float*>(loss);
  float* ls = static_cast<float*>(lse);
  cudaStream_t st = as_stream(stream);
  switch (dtype) {
    case kF32:
      xent_fwd_kernel<float><<<rows, kThreads, 0, st>>>(
          static_cast<const float*>(x), lab, lo, ls, t_len, s_a, s_t, width,
          true_k, smoothing, one_minus_smoothing, has_pad, pad_idx);
      break;
    case kBF16:
      xent_fwd_kernel<__nv_bfloat16><<<rows, kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), lab, lo, ls, t_len, s_a, s_t,
          width, true_k, smoothing, one_minus_smoothing, has_pad, pad_idx);
      break;
    case kF16:
      xent_fwd_kernel<__half><<<rows, kThreads, 0, st>>>(
          static_cast<const __half*>(x), lab, lo, ls, t_len, s_a, s_t, width,
          true_k, smoothing, one_minus_smoothing, has_pad, pad_idx);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dx: (rows, width) contiguous in `dtype`; dloss: (rows,) fp32.
extern "C" int apex1_xent_bwd(const void* x, const void* labels,
                              const void* lse, const void* dloss, void* dx,
                              int rows, int t_len, long long s_a,
                              long long s_t, int width, int true_k,
                              float one_minus_smoothing, float eps_over_k,
                              int has_pad, int pad_idx, int dtype,
                              void* stream) {
  if (rows <= 0) return 0;
  const int* lab = static_cast<const int*>(labels);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(dloss);
  cudaStream_t st = as_stream(stream);
  switch (dtype) {
    case kF32:
      xent_bwd_kernel<float><<<rows, kThreads, 0, st>>>(
          static_cast<const float*>(x), lab, ls, dl, static_cast<float*>(dx),
          t_len, s_a, s_t, width, true_k, one_minus_smoothing, eps_over_k,
          has_pad, pad_idx);
      break;
    case kBF16:
      xent_bwd_kernel<__nv_bfloat16><<<rows, kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), lab, ls, dl,
          static_cast<__nv_bfloat16*>(dx), t_len, s_a, s_t, width, true_k,
          one_minus_smoothing, eps_over_k, has_pad, pad_idx);
      break;
    case kF16:
      xent_bwd_kernel<__half><<<rows, kThreads, 0, st>>>(
          static_cast<const __half*>(x), lab, ls, dl,
          static_cast<__half*>(dx), t_len, s_a, s_t, width, true_k,
          one_minus_smoothing, eps_over_k, has_pad, pad_idx);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
