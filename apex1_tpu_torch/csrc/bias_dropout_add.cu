// Fused bias + dropout + residual add, forward and backward, for Hopper
// (sm_90a).
//
// Replaces: apex1_tpu/ops/stochastic.py::_bda_fwd_kernel (launched by
// _bda_pallas_fwd) and ::_bda_bwd_kernel (launched by _bda_pallas_bwd),
// the Pallas TPU row kernels behind fused_bias_dropout_add and
// fused_dropout_add_layer_norm.
//
//   forward:  keep = hash(seed, salt 0, row, col) >= thr (dropout_hash.cuh,
//             row the global row of the (rows, h) view, col in [0, h)),
//             y = f32(res) + (keep ? (f32(x) + f32(bias)) * inv : 0),
//             rounded to x's type; inv = 1 / (1 - p) as an fp32 value
//   backward: dx = keep ? f32(dy) * inv : 0, rounded to dy's type;
//             dbias = Σ over rows of the fp32 dx, before its rounding
//
// No mask is stored: the backward recomputes it from the seed. The
// products and sums use the round-to-nearest intrinsics, so nvcc fuses
// no multiply-add and the result equals the plain version bit for bit.
//
// Bound on the H100: bytes. The forward reads x and the residual and
// writes y, about ten integer operations an element for the hash; at
// BERT-base's shape (4096 x 768 bf16) that is 18.9 MB, 5.6 us at
// 3.35 TB/s. The backward reads dy and writes dx.
//
// Design. The TPU kernel walks row blocks on a sequential grid and keeps
// dbias in one output block across it. Here:
// - the forward and the backward without bias are a grid-stride loop over
//   the elements, N a thread at a time (16-byte loads where every row is
//   a multiple of 16 bytes and the operands are 16-byte aligned, else one
//   element), so a ragged last row block needs no padding;
// - the backward with bias takes two passes and no atomics, as
//   layer_norm_bwd.cu does: block g owns a fixed run of rows and its
//   threads fixed columns, summing their fp32 dx in shared memory and
//   writing one row of partials; then one thread a column sums the
//   partials in order. Two runs give the same bits.

#include "common.cuh"
#include "dropout_hash.cuh"

static const int kThreads = 256;

// N values of type U loaded or stored as one access (16 bytes at most)
template <typename U, int N>
struct alignas(sizeof(U) * N > 16 ? 16 : sizeof(U) * N) Pack {
  U v[N];
};

struct BdaArgs {
  const void* x;      // forward: x; backward: dy
  const void* res;    // forward: the residual
  const float* bias;  // null: no bias
  void* out;          // forward: y; backward: dx
  float* part;        // backward with bias: (groups, h) partials
  float* dbias;       // backward with bias: (h,) fp32
  long long rows;
  int h;
  int rows_per_block;
  uint32_t key, thr;
  float inv;
};

template <typename T, typename R, int N>
__global__ void __launch_bounds__(kThreads) bda_fwd_kernel(const BdaArgs a) {
  const int per_row = a.h / N;
  const long long n = a.rows * per_row;
  const T* x = static_cast<const T*>(a.x);
  const R* res = static_cast<const R*>(a.res);
  T* y = static_cast<T*>(a.out);
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long r = i / per_row;
    const int c0 = static_cast<int>(i - r * per_row) * N;
    const size_t off = static_cast<size_t>(r) * a.h + c0;
    const uint32_t rk = row_key(a.key, static_cast<uint32_t>(r));
    const Pack<T, N> xv = *reinterpret_cast<const Pack<T, N>*>(x + off);
    const Pack<R, N> rv = *reinterpret_cast<const Pack<R, N>*>(res + off);
    Pack<T, N> out;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float v = to_f32(xv.v[j]);
      if (a.bias != nullptr) v = __fadd_rn(v, a.bias[c0 + j]);
      v = keep_bit(rk, static_cast<uint32_t>(c0 + j), a.thr)
              ? __fmul_rn(v, a.inv)
              : 0.f;
      out.v[j] = from_f32<T>(__fadd_rn(v, to_f32(rv.v[j])));
    }
    *reinterpret_cast<Pack<T, N>*>(y + off) = out;
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads) bda_bwd_kernel(const BdaArgs a) {
  const int per_row = a.h / N;
  const long long n = a.rows * per_row;
  const T* dy = static_cast<const T*>(a.x);
  T* dx = static_cast<T*>(a.out);
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long r = i / per_row;
    const int c0 = static_cast<int>(i - r * per_row) * N;
    const size_t off = static_cast<size_t>(r) * a.h + c0;
    const uint32_t rk = row_key(a.key, static_cast<uint32_t>(r));
    const Pack<T, N> dv = *reinterpret_cast<const Pack<T, N>*>(dy + off);
    Pack<T, N> out;
#pragma unroll
    for (int j = 0; j < N; ++j)
      out.v[j] = from_f32<T>(keep_bit(rk, static_cast<uint32_t>(c0 + j),
                                      a.thr)
                                 ? __fmul_rn(to_f32(dv.v[j]), a.inv)
                                 : 0.f);
    *reinterpret_cast<Pack<T, N>*>(dx + off) = out;
  }
}

// pass 1 of the backward with bias: block g takes rows
// [g * rows_per_block, ...); thread t owns the column packs t, t + kThreads,
// ... of every row, so its shared-memory sums need no synchronisation
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    bda_bwd_rows_kernel(const BdaArgs a) {
  extern __shared__ float acc[];  // [h]
  const int per_row = a.h / N;
  const T* dy = static_cast<const T*>(a.x);
  T* dx = static_cast<T*>(a.out);
  for (int p = threadIdx.x; p < per_row; p += kThreads)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[p * N + j] = 0.f;
  const long long r0 = static_cast<long long>(blockIdx.x) * a.rows_per_block;
  const long long r1 = min(r0 + a.rows_per_block, a.rows);
  for (long long r = r0; r < r1; ++r) {
    const uint32_t rk = row_key(a.key, static_cast<uint32_t>(r));
    for (int p = threadIdx.x; p < per_row; p += kThreads) {
      const int c0 = p * N;
      const size_t off = static_cast<size_t>(r) * a.h + c0;
      const Pack<T, N> dv = *reinterpret_cast<const Pack<T, N>*>(dy + off);
      Pack<T, N> out;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float v = keep_bit(rk, static_cast<uint32_t>(c0 + j), a.thr)
                            ? __fmul_rn(to_f32(dv.v[j]), a.inv)
                            : 0.f;
        acc[c0 + j] = __fadd_rn(acc[c0 + j], v);
        out.v[j] = from_f32<T>(v);
      }
      *reinterpret_cast<Pack<T, N>*>(dx + off) = out;
    }
  }
  float* pr = a.part + static_cast<size_t>(blockIdx.x) * a.h;
  for (int p = threadIdx.x; p < per_row; p += kThreads)
#pragma unroll
    for (int j = 0; j < N; ++j) pr[p * N + j] = acc[p * N + j];
}

// pass 2: dbias[c] = Σ_g part[g, c], g in order
__global__ void bda_dbias_kernel(const float* __restrict__ part,
                                 float* __restrict__ dbias, int groups,
                                 int h) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= h) return;
  float s = 0.f;
  for (int g = 0; g < groups; ++g)
    s = __fadd_rn(s, part[static_cast<size_t>(g) * h + c]);
  dbias[c] = s;
}

static unsigned grid_for(long long items) {
  const long long blocks = (items + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < 132 * 16 ? blocks : 132 * 16);
}

template <typename T, typename R>
static int fwd_typed(const BdaArgs& a, int vec, cudaStream_t st) {
  constexpr int N = 16 / sizeof(T);
  if (vec) {
    note_launch(bda_fwd_kernel<T, R, N>, 0, kThreads);
    bda_fwd_kernel<T, R, N><<<grid_for(a.rows * (a.h / N)), kThreads, 0,
                              st>>>(a);
  } else {
    note_launch(bda_fwd_kernel<T, R, 1>, 0, kThreads);
    bda_fwd_kernel<T, R, 1><<<grid_for(a.rows * a.h), kThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int fwd_res(const BdaArgs& a, int vec, int res_dtype,
                   cudaStream_t st) {
  switch (res_dtype) {
    case kF32:
      return fwd_typed<T, float>(a, vec, st);
    case kBF16:
      return fwd_typed<T, __nv_bfloat16>(a, vec, st);
    case kF16:
      return fwd_typed<T, __half>(a, vec, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
static int bwd_typed(const BdaArgs& a, int vec, int groups, cudaStream_t st) {
  constexpr int N = 16 / sizeof(T);
  if (a.dbias == nullptr) {
    if (vec) {
      note_launch(bda_bwd_kernel<T, N>, 0, kThreads);
      bda_bwd_kernel<T, N><<<grid_for(a.rows * (a.h / N)), kThreads, 0,
                             st>>>(a);
    } else {
      note_launch(bda_bwd_kernel<T, 1>, 0, kThreads);
      bda_bwd_kernel<T, 1><<<grid_for(a.rows * a.h), kThreads, 0, st>>>(a);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = static_cast<size_t>(a.h) * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (vec) {
    note_launch(bda_bwd_rows_kernel<T, N>, smem, kThreads);
    bda_bwd_rows_kernel<T, N><<<groups, kThreads, smem, st>>>(a);
  } else {
    note_launch(bda_bwd_rows_kernel<T, 1>, smem, kThreads);
    bda_bwd_rows_kernel<T, 1><<<groups, kThreads, smem, st>>>(a);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  note_launch(bda_dbias_kernel, 0, 256);
  bda_dbias_kernel<<<(a.h + 255) / 256, 256, 0, st>>>(a.part, a.dbias, groups,
                                                      a.h);
  return static_cast<int>(cudaGetLastError());
}

static BdaArgs make_args(long long rows, int h, unsigned seed, unsigned thr,
                         float inv) {
  BdaArgs a{};
  a.rows = rows;
  a.h = h;
  a.key = stream_key(seed, 0u);
  a.thr = thr;
  a.inv = inv;
  return a;
}

// x, y: (rows, h) in `dtype`; res (rows, h) in `res_dtype`; bias (h,) fp32
// or null. vec: h * size is a multiple of 16 for both types and every
// operand is 16-byte aligned. seed, thr: the uint32 seed word and
// threshold; inv: 1 / (1 - p) in fp32.
extern "C" int apex1_bda_fwd(const void* x, const void* res, const void* bias,
                             void* y, long long rows, int h, unsigned seed,
                             unsigned thr, float inv, int vec, int dtype,
                             int res_dtype, void* stream) {
  if (rows <= 0 || h <= 0) return 0;
  BdaArgs a = make_args(rows, h, seed, thr, inv);
  a.x = x;
  a.res = res;
  a.bias = static_cast<const float*>(bias);
  a.out = y;
  cudaStream_t st = as_stream(stream);
  switch (dtype) {
    case kF32:
      return fwd_res<float>(a, vec, res_dtype, st);
    case kBF16:
      return fwd_res<__nv_bfloat16>(a, vec, res_dtype, st);
    case kF16:
      return fwd_res<__half>(a, vec, res_dtype, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dy, dx: (rows, h) in `dtype`. With dbias (h,) fp32: part is an fp32
// workspace (groups, h) and groups * rows_per_block >= rows; both null
// without bias.
extern "C" int apex1_bda_bwd(const void* dy, void* dx, void* part,
                             void* dbias, long long rows, int h,
                             int rows_per_block, int groups, unsigned seed,
                             unsigned thr, float inv, int vec, int dtype,
                             void* stream) {
  if (rows <= 0 || h <= 0) return 0;
  BdaArgs a = make_args(rows, h, seed, thr, inv);
  a.x = dy;
  a.out = dx;
  a.part = static_cast<float*>(part);
  a.dbias = static_cast<float*>(dbias);
  a.rows_per_block = rows_per_block;
  cudaStream_t st = as_stream(stream);
  switch (dtype) {
    case kF32:
      return bwd_typed<float>(a, vec, groups, st);
    case kBF16:
      return bwd_typed<__nv_bfloat16>(a, vec, groups, st);
    case kF16:
      return bwd_typed<__half>(a, vec, groups, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
