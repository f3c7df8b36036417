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
// Bound on the H100: memory. GPT-2's head is 16368 rows of 50304 logits:
// in bf16 the forward reads 1.65 GB (0.49 ms at 3.35 TB/s) and the
// backward reads and writes 1.65 GB each; in fp32 twice that. A handful
// of flops an element: 823 M exponentials on the MUFU unit (16 a clock
// an SM) take about 0.22 ms, under the bytes.
//
// Design: a block of 256 threads a row (the short rows of the main
// paths, the ResNet head's 64 x 1000 and NSP's 8 x 2, come few at a
// time: a call is a launch and a memory round trip, and a block a row
// spreads them over the most SMs). Each thread streams its columns as
// 16-byte vectors (8 bf16/fp16 or 4 fp32 values; read-only,
// L1 not allocated), kU of them loaded before any arithmetic, so 64
// bytes a thread are in flight. A row whose base is not 16-byte aligned
// (an odd width, a logits[:, :-1] slice of one) takes its first columns
// up to the next 16-byte boundary, and its last ones past the final
// whole vector, as scalars; the choice is made per row here from the
// row's own address, never by falling back to the plain version. The
// forward folds each group of loaded values into the thread's running
// (max, sum of exp) pair once: the group's max, one rescale of the sum,
// then each value's exp2((x - m) log2 e) as one FFMA and one ex2.approx
// (no data-dependent branch, no precise expf: the pass is bound by bytes
// and the approximate exponential is within 2 ulp); sum(x) beside it,
// the target logit one load issued before the loop. The row's pairs are
// joined in a fixed order, warp shuffles then shared memory (no
// atomics, the same bits on every launch), and lse = m + logf(s) stays
// precise. The backward folds each row's constants once (lse log2 e,
// -eps/K dloss, and that minus (1-eps) dloss for the target column;
// dloss 0 on a padding row), so an element is one FFMA, one ex2, a
// compare against the target column and one FMA; dx leaves in 16-byte
// stores, the padding columns [K, width) as zeros in the same stores.
// Where x's row and dx's row sit at different offsets from a 16-byte
// boundary, dx keeps its vector stores and x is read as scalars. Rows
// are addressed through two strides, so the (B, S-1, V) slice
// logits[:, :-1] of (B, S, V) logits is read in place.

#include "chunks.cuh"

// threads of a block, which takes one row
static const int kThreads = 256;
// 16-byte vectors a thread loads before it folds them
static const int kU = 4;
static const float kLog2e = 1.4426950408889634f;
static const float kMaxF = 3.402823466e38f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a 16-byte load of read-only data that is streamed once (no L1 line)
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

// columns from p up to the next 16-byte boundary (p is T-aligned)
template <typename T>
__device__ __forceinline__ int to_boundary(const T* p) {
  return static_cast<int>((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) /
         static_cast<int>(sizeof(T));
}

// N values of T at p as fp32: one 16-byte load where p is aligned (V),
// else N scalar loads
template <typename T, bool V>
__device__ __forceinline__ void load_f32(const T* p,
                                         float (&v)[Chunk<T>::N]) {
  if constexpr (V) {
    Chunk<T>::widen(ld_stream(p), v);
  } else {
#pragma unroll
    for (int i = 0; i < Chunk<T>::N; ++i) v[i] = to_f32(p[i]);
  }
}

// s's factor when the running max moves from m to mn >= m: exactly 1
// where it stays (also at -inf, before any column)
__device__ __forceinline__ float rescale(float m, float mn) {
  return m == mn ? 1.f : ex2((m - mn) * kLog2e);
}

// the running (max, sum of exp, sum) of a thread's columns, and C more
// values folded in at once
struct Fold {
  float m = -INFINITY, s = 0.f, sx = 0.f;

  template <int C>
  __device__ __forceinline__ void add(const float* v) {
    float mx = v[0];
#pragma unroll
    for (int i = 1; i < C; ++i) mx = fmaxf(mx, v[i]);
    const float mn = fmaxf(m, mx);
    // -(mn log2 e), finite while mn is -inf (every value so far -inf):
    // exp2 of a -inf logit is then still 0
    const float off = -fmaxf(mn * kLog2e, -kMaxF);
    float e = 0.f, x = 0.f;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      e += ex2(fmaf(v[i], kLog2e, off));
      x += v[i];
    }
    s = s * rescale(m, mn) + e;
    sx += x;
    m = mn;
  }

  __device__ __forceinline__ void join(float m2, float s2, float sx2) {
    const float mn = fmaxf(m, m2);
    s = s * rescale(m, mn) + s2 * rescale(m2, mn);
    sx += sx2;
    m = mn;
  }

  // butterfly over the 32 lanes: every lane ends with the warp's fold
  __device__ __forceinline__ void join_warp() {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      join(__shfl_xor_sync(0xffffffffu, m, o),
           __shfl_xor_sync(0xffffffffu, s, o),
           __shfl_xor_sync(0xffffffffu, sx, o));
  }
};

struct XentArgs {
  const void* x;
  const int* labels;
  const float* lse;    // backward: the forward's lse
  const float* dloss;  // backward
  float* loss;         // forward
  float* lse_out;      // forward
  void* dx;            // backward: (rows, width), dense
  int rows, t_len;
  long long s_a, s_t;
  int width, true_k;
  float smoothing, one_minus_smoothing, eps_over_k;
  int has_pad, pad_idx;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    xent_fwd_kernel(const XentArgs a) {
  constexpr int N = Chunk<T>::N;
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const T* xr = static_cast<const T*>(a.x) + (row / a.t_len) * a.s_a +
                (row % a.t_len) * a.s_t;
  const int K = a.true_k;
  const int t = a.labels[row];
  float tgt = 0.f;
  if (tid == 0 && t >= 0 && t < a.width) tgt = to_f32(xr[t]);

  // vectors from column h (the row's first 16-byte boundary) to tail
  const int h = min(to_boundary(xr), K);
  const int nv = (K - h) / N;
  const int tail = h + nv * N;
  Fold f;
  // the scalar columns first, [0, h) and [tail, K): a short row's only
  // ones, reached without the vector loops' set-up
  for (int i = tid; i < h + K - tail; i += kThreads) {
    const float one = to_f32(xr[i < h ? i : tail + i - h]);
    f.add<1>(&one);
  }
  if (nv > 0) {
    const T* xv = xr + h;
    int v = tid;
    for (; v + (kU - 1) * kThreads < nv; v += kU * kThreads) {
      float g[kU][N];
#pragma unroll
      for (int j = 0; j < kU; ++j)
        load_f32<T, true>(xv + (v + j * kThreads) * N, g[j]);
      f.add<kU * N>(&g[0][0]);
    }
    for (; v < nv; v += kThreads) {
      float g[N];
      load_f32<T, true>(xv + v * N, g);
      f.add<N>(g);
    }
  }

  f.join_warp();
  constexpr int W = kThreads / 32;
  __shared__ float red[3][W];
  const int warp = tid >> 5, lane = tid & 31;
  if (lane == 0) {
    red[0][warp] = f.m;
    red[1][warp] = f.s;
    red[2][warp] = f.sx;
  }
  __syncthreads();
  if (warp != 0) return;
  f = Fold();
  if (lane < W) {
    f.m = red[0][lane];
    f.s = red[1][lane];
    f.sx = red[2][lane];
  }
  f.join_warp();
  if (lane != 0) return;
  const float lse = f.m + logf(f.s);
  float l = a.one_minus_smoothing * (lse - tgt) +
            a.smoothing * (lse - f.sx / static_cast<float>(K));
  if (a.has_pad && t == a.pad_idx) l = 0.f;
  a.loss[row] = l;
  a.lse_out[row] = lse;
}

// one row's backward constants: dx_k = g(x_k) for k < K, else 0
struct BwdRow {
  float off;  // -lse log2 e
  float d;    // dloss, 0 on a padding row
  float dn;   // -eps/K d: every real column
  float dt;   // dn - (1-eps) d: the target column
  int t, K;

  __device__ __forceinline__ float g(int k, float x) const {
    return fmaf(ex2(fmaf(x, kLog2e, off)), d, k == t ? dt : dn);
  }
  __device__ __forceinline__ float masked(int k, float x) const {
    return k < K ? g(k, x) : 0.f;
  }
};

// dx's vectors [0, nv) of a row from column h on: the kv of them wholly
// inside the K real columns first, kU at a time, then the rest masked
// (a vector past K is stored as zeros without a load). XV: x's row
// shares dx's offset from a 16-byte boundary, so x is read in vectors
// too.
template <typename T, bool XV>
__device__ __forceinline__ void bwd_vectors(const T* xr, T* dxr, int h,
                                            int nv, int kv, const BwdRow& r,
                                            int tid) {
  constexpr int N = Chunk<T>::N;
  const T* xv = xr + h;
  uint4* dv = reinterpret_cast<uint4*>(dxr + h);
  int v = tid;
  for (; v + (kU - 1) * kThreads < kv; v += kU * kThreads) {
    float g[kU][N];
#pragma unroll
    for (int j = 0; j < kU; ++j)
      load_f32<T, XV>(xv + (v + j * kThreads) * N, g[j]);
#pragma unroll
    for (int j = 0; j < kU; ++j) {
      const int c0 = h + (v + j * kThreads) * N;
#pragma unroll
      for (int i = 0; i < N; ++i) g[j][i] = r.g(c0 + i, g[j][i]);
      dv[v + j * kThreads] = Chunk<T>::narrow(g[j]);
    }
  }
  for (; v < kv; v += kThreads) {
    float g[N];
    load_f32<T, XV>(xv + v * N, g);
    const int c0 = h + v * N;
#pragma unroll
    for (int i = 0; i < N; ++i) g[i] = r.g(c0 + i, g[i]);
    dv[v] = Chunk<T>::narrow(g);
  }
  for (v = kv + tid; v < nv; v += kThreads) {
    const int c0 = h + v * N;
    float g[N] = {};
    if (c0 < r.K) {
      load_f32<T, XV>(xv + v * N, g);
#pragma unroll
      for (int i = 0; i < N; ++i) g[i] = r.masked(c0 + i, g[i]);
    }
    dv[v] = Chunk<T>::narrow(g);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    xent_bwd_kernel(const XentArgs a) {
  constexpr int N = Chunk<T>::N;
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const T* xr = static_cast<const T*>(a.x) + (row / a.t_len) * a.s_a +
                (row % a.t_len) * a.s_t;
  T* dxr = static_cast<T*>(a.dx) + static_cast<size_t>(row) * a.width;
  // the row's three loads issued together: none waits on another
  BwdRow r;
  r.t = a.labels[row];
  const float dl = a.dloss[row];
  r.off = -a.lse[row] * kLog2e;
  r.K = a.true_k;
  r.d = (a.has_pad && r.t == a.pad_idx) ? 0.f : dl;
  r.dn = -a.eps_over_k * r.d;
  r.dt = r.dn - a.one_minus_smoothing * r.d;

  // dx's row sets the vectors, from column h to tail; x follows in
  // vectors where it sits at the same offset from a 16-byte boundary
  const int h = min(to_boundary(dxr), a.width);
  const int nv = (a.width - h) / N;
  const int tail = h + nv * N;
  // the scalar columns first, [0, h) and [tail, width), as the forward
  for (int i = tid; i < h + a.width - tail; i += kThreads) {
    const int c = i < h ? i : tail + i - h;
    dxr[c] = from_f32<T>(r.masked(c, to_f32(xr[c])));
  }
  if (nv > 0) {
    const int kv = a.true_k > h ? min(nv, (a.true_k - h) / N) : 0;
    if (to_boundary(xr) == to_boundary(dxr))
      bwd_vectors<T, true>(xr, dxr, h, nv, kv, r, tid);
    else
      bwd_vectors<T, false>(xr, dxr, h, nv, kv, r, tid);
  }
}

template <typename T>
static void launch(bool fwd, const XentArgs& a, cudaStream_t st) {
  if (fwd) {
    note_launch(xent_fwd_kernel<T>, 0, kThreads);
    xent_fwd_kernel<T><<<a.rows, kThreads, 0, st>>>(a);
  } else {
    note_launch(xent_bwd_kernel<T>, 0, kThreads);
    xent_bwd_kernel<T><<<a.rows, kThreads, 0, st>>>(a);
  }
}

static int dispatch(bool fwd, const XentArgs& a, int dtype, void* stream) {
  if (a.rows <= 0) return 0;
  cudaStream_t st = as_stream(stream);
  switch (dtype) {
    case kF32:
      launch<float>(fwd, a, st);
      break;
    case kBF16:
      launch<__nv_bfloat16>(fwd, a, st);
      break;
    case kF16:
      launch<__half>(fwd, a, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x: rows of `width` logits in `dtype`; row r = a * t_len + t sits at
// a * s_a + t * s_t elements; labels int32; loss, lse: (rows,) fp32.
extern "C" int apex1_xent_fwd(const void* x, const void* labels, void* loss,
                              void* lse, int rows, int t_len, long long s_a,
                              long long s_t, int width, int true_k,
                              float smoothing, float one_minus_smoothing,
                              int has_pad, int pad_idx, int dtype,
                              void* stream) {
  XentArgs a = {};
  a.x = x;
  a.labels = static_cast<const int*>(labels);
  a.loss = static_cast<float*>(loss);
  a.lse_out = static_cast<float*>(lse);
  a.rows = rows;
  a.t_len = t_len;
  a.s_a = s_a;
  a.s_t = s_t;
  a.width = width;
  a.true_k = true_k;
  a.smoothing = smoothing;
  a.one_minus_smoothing = one_minus_smoothing;
  a.has_pad = has_pad;
  a.pad_idx = pad_idx;
  return dispatch(true, a, dtype, stream);
}

// dx: (rows, width) contiguous in `dtype`; dloss: (rows,) fp32.
extern "C" int apex1_xent_bwd(const void* x, const void* labels,
                              const void* lse, const void* dloss, void* dx,
                              int rows, int t_len, long long s_a,
                              long long s_t, int width, int true_k,
                              float one_minus_smoothing, float eps_over_k,
                              int has_pad, int pad_idx, int dtype,
                              void* stream) {
  XentArgs a = {};
  a.x = x;
  a.labels = static_cast<const int*>(labels);
  a.lse = static_cast<const float*>(lse);
  a.dloss = static_cast<const float*>(dloss);
  a.dx = dx;
  a.rows = rows;
  a.t_len = t_len;
  a.s_a = s_a;
  a.s_t = s_t;
  a.width = width;
  a.true_k = true_k;
  a.one_minus_smoothing = one_minus_smoothing;
  a.eps_over_k = eps_over_k;
  a.has_pad = has_pad;
  a.pad_idx = pad_idx;
  return dispatch(false, a, dtype, stream);
}
