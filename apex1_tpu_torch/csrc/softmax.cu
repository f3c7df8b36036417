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
// Design: one warp per row of (B, H, Sq, Sk), four rows a block in the
// forward, eight in the backward. The TPU kernel takes a (rows, Sk)
// block and its causal row index from the grid position; here the query
// index comes from the row's own place in (B, H, Sq), so the kernel
// needs no padding of Sq or Sk. The additive mask is read through four
// strides, 0 on a broadcast dimension, so a (B, 1, Sq, Sk) or
// (1, 1, 1, Sk) mask is never expanded.
//
// Forward, the register path (Sk a multiple of a 16-byte chunk, at most
// 16 chunks a lane: Sk 2048 in fp32, 4096 in bf16/fp16; x, y and a
// key-dense mask 16-byte aligned). Lane l holds the row's chunks l,
// l + 32, ... (VPL of them, a template on Sk's range) in registers, and
// every load of the row is issued before any arithmetic, so a warp has
// its whole row in flight at once. A causal row loads only the chunks
// that begin before its end q + 1, and the one chunk that straddles it
// is masked in registers (the TPU kernel sets those columns to NEG_INF,
// whose exp underflows to exactly 0). The mask is added in registers: a
// key-dense mask read in 16-byte pieces beside x, a key-broadcast one as
// one value a row. The row max is a butterfly over the warp, each element
// is exponentiated once, in place (expf, not __expf: the fp32 check holds
// the kernel to 1e-5 relative of the plain version's torch.exp, and the
// pass is bound by memory, not by the exp), the sum is a butterfly, and
// y = e * (1 / sum) is written in 16-byte stores; the chunks past a
// causal row's end are written as zeros without being read. Rows that
// do not take it (past 16 chunks a lane, Sk not a multiple of a chunk, a
// misaligned pointer) are streamed twice: each lane folds its columns
// into a running (max, sum of exp) pair, the 32 pairs are joined with
// shuffles, and a second pass (the row is still in L1/L2) writes
// exp(v - max) * (1 / sum). Measured on the H100 at GPT-2's causal fp32
// (16, 12, 1024, 1024) scores (`chip_smoke.py --compare`): the register
// path takes 0.41-0.42 ms against the streamed kernel's 0.60, 86-87 % of
// the 0.36 ms that its bytes need; eight rows a block ran as fast in
// fp32 and up to 5 % slower in bf16/fp16.
//
// Backward: keeps a row of up to 1024 columns of y and dy in the lanes'
// registers (32 values a lane), so each is read once, reduces
// sum(y * dy) with shuffles and writes dx; a longer row is streamed
// twice. (Measured on the H100 at GPT-2's shape: the resident backward
// 1.7x faster than a streamed one.)

#include "chunks.cuh"

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
__global__ void softmax_fwd_streamed_kernel(const T* __restrict__ x,
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

static const int kRowsPerBlock = 8;  // the backward's rows (warps) a block
static const int kFwdRows = 4;       // the forward's

// the register path's forward: VPL chunks a lane; MVEC: a key-dense
// mask read in 16-byte pieces, else none or one value a row
template <typename T, int VPL, bool MVEC>
__global__ void __launch_bounds__(kFwdRows * 32)
    softmax_fwd_reg_kernel(const T* __restrict__ x,
                           const float* __restrict__ mask,
                           T* __restrict__ y, long long rows, int nh, int sq,
                           int sk, float scale, int causal, long long msb,
                           long long msh, long long msq, long long msk) {
  constexpr int N = Chunk<T>::N;
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp leaves together
  const int q = static_cast<int>(row % sq);
  const long long bh = row / sq;
  const int hh = static_cast<int>(bh % nh);
  const long long b = bh / nh;
  const int nch = sk / N;
  const int end = causal ? min(q + 1, sk) : sk;
  const int lim = (end + N - 1) / N;  // chunks that begin before end
  const uint4* xr = reinterpret_cast<const uint4*>(x) + row * nch;
  const float* mr =
      mask == nullptr ? nullptr : mask + b * msb + hh * msh + q * msq;
  uint4 raw[VPL];
  float4 mv[MVEC ? VPL : 1][N / 4];
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int c = k * 32 + lane;
    raw[k] = make_uint4(0, 0, 0, 0);
    if (k * 32 < lim && c < lim) {
      raw[k] = xr[c];
      if constexpr (MVEC) {
#pragma unroll
        for (int j = 0; j < N / 4; ++j)
          mv[k][j] = reinterpret_cast<const float4*>(mr + c * N)[j];
      }
    }
  }
  const float madd = (!MVEC && mr != nullptr) ? mr[0] : 0.f;
  const float ninf = __int_as_float(0xff800000);  // -inf
  float v[VPL][N];
  float mx = ninf;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int c = k * 32 + lane;
    Chunk<T>::widen(raw[k], v[k]);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float t = v[k][i] * scale;
      if constexpr (MVEC)
        t += reinterpret_cast<const float*>(mv[k])[i];
      else
        t += madd;
      v[k][i] = c * N + i < end ? t : ninf;
      mx = fmaxf(mx, v[k][i]);
    }
  }
  mx = warp_max(mx);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    if (k * 32 < lim) {  // the warp skips chunks wholly past the end
#pragma unroll
      for (int i = 0; i < N; ++i) {
        v[k][i] = expf(v[k][i] - mx);
        s += v[k][i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) v[k][i] = 0.f;
    }
  }
  const float inv = 1.f / warp_sum(s);
  uint4* yr = reinterpret_cast<uint4*>(y) + row * nch;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int c = k * 32 + lane;
    if (c < nch) {
#pragma unroll
      for (int i = 0; i < N; ++i) v[k][i] *= inv;
      yr[c] = Chunk<T>::narrow(v[k]);
    }
  }
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

template <typename T>
using FwdKernel = void (*)(const T*, const float*, T*, long long, int, int,
                           int, float, int, long long, long long, long long,
                           long long);

// the register kernel for chunks a lane `vpl`, or null past 16
template <typename T, bool MVEC>
FwdKernel<T> reg_fwd(int vpl) {
  return vpl <= 1    ? softmax_fwd_reg_kernel<T, 1, MVEC>
         : vpl <= 2  ? softmax_fwd_reg_kernel<T, 2, MVEC>
         : vpl <= 4  ? softmax_fwd_reg_kernel<T, 4, MVEC>
         : vpl <= 8  ? softmax_fwd_reg_kernel<T, 8, MVEC>
         : vpl <= 12 ? softmax_fwd_reg_kernel<T, 12, MVEC>
         : vpl <= 16 ? softmax_fwd_reg_kernel<T, 16, MVEC>
                     : nullptr;
}

template <typename T>
static void launch_fwd(const void* x, const float* mask, void* y,
                       long long rows, int nh, int sq, int sk, float scale,
                       int causal, const long long* ms, cudaStream_t st) {
  constexpr int N = Chunk<T>::N;
  const unsigned blocks =
      static_cast<unsigned>((rows + kFwdRows - 1) / kFwdRows);
  // a key-dense mask is read in 16-byte pieces: its base and every row's
  // start 16-byte aligned
  const bool mvec = mask != nullptr && ms[3] != 0;
  const bool mask_ok =
      !mvec || (ms[3] == 1 && aligned16(mask) && ms[0] % 4 == 0 &&
                ms[1] % 4 == 0 && ms[2] % 4 == 0);
  const int vpl = (sk / N + 31) / 32;
  FwdKernel<T> k = nullptr;
  if (sk % N == 0 && aligned16(x) && aligned16(y) && mask_ok)
    k = mvec ? reg_fwd<T, true>(vpl) : reg_fwd<T, false>(vpl);
  if (k == nullptr) k = softmax_fwd_streamed_kernel<T>;
  note_launch(k, 0, 32 * kFwdRows);
  k<<<blocks, 32 * kFwdRows, 0, st>>>(
      static_cast<const T*>(x), mask, static_cast<T*>(y), rows, nh, sq, sk,
      scale, causal, ms[0], ms[1], ms[2], ms[3]);
}

template <typename T>
static void launch_bwd(const void* y, const void* dy, void* dx,
                       long long rows, int sk, float scale, cudaStream_t st) {
  const unsigned blocks =
      static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  if (sk <= 32 * kItems) {
    note_launch(softmax_bwd_kernel<T, kItems>, 0, 32 * kRowsPerBlock);
    softmax_bwd_kernel<T, kItems><<<blocks, 32 * kRowsPerBlock, 0, st>>>(
        static_cast<const T*>(y), static_cast<const T*>(dy),
        static_cast<T*>(dx), rows, sk, scale);
  } else {
    note_launch(softmax_bwd_kernel<T, 0>, 0, 32 * kRowsPerBlock);
    softmax_bwd_kernel<T, 0><<<blocks, 32 * kRowsPerBlock, 0, st>>>(
        static_cast<const T*>(y), static_cast<const T*>(dy),
        static_cast<T*>(dx), rows, sk, scale);
  }
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
