// Rotary positional embedding for Hopper (sm_90a), forward and backward.
//
// Replaces: apex1_tpu/ops/rope.py::_rope_kernel (launched by _pallas_rope
// :58, forward, and by _rope_bwd :137 with -sin, backward).
//
//   x viewed as (P, S, I, D): P rows before the sequence axis, S positions,
//   I rows after it (the heads), D = 2·half lanes. Each (x1, x2) lane pair
//   (the two halves, or even/odd lanes with `interleaved`) rotates by its
//   position's angle, in fp32, rounded to x's dtype:
//     o1 = x1·cos - x2·sin,  o2 = x2·cos + x1·sin
//   with sin negated for the backward (the rotation by -θ). The tables are
//   fp32 (S, half), or per row (B, S, half) for packed batches, where the
//   batch row of prefix row p is p / pre (pre = the rows between the batch
//   axis and the sequence axis).
//
// Bound on the H100: bytes. Each element of x is read once and written
// once, the tables once; about 6 flops a pair. At the Llama-3 8B training
// shape (q: 2 x 4096 x 32 x 128 bf16) that is 64 MB moved for 0.1 GFLOP.
//
// Design. The TPU wrapper materialises the x1/x2 halves and tables
// broadcast to x's shape before its kernel (rope.py:99-111); here the
// kernel reads x in place in its (..., seq, heads, D) layout and indexes
// the table by each row's position, so only x, the output and the tables
// move. A thread rotates 4 consecutive pairs with vector loads (8 or 16
// bytes of x for each half, 16 bytes of each table) when the geometry
// allows it, one pair otherwise; a grid-stride loop covers all pairs. The
// products and the difference are rounded one at a time (__fmul_rn,
// __fsub_rn: no fused multiply-add), as the plain version rounds them.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

struct RopeArgs {
  const void* x;
  const float* cos;
  const float* sin;
  void* out;
  long long P;  // rows before the sequence axis
  int S, I, half, pre;
  int per_row, interleaved;
  float sign;  // +1 forward, -1 backward
};

__device__ __forceinline__ void rotate(float x1, float x2, float c, float s,
                                       float& o1, float& o2) {
  o1 = __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s));
  o2 = __fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s));
}

// V consecutive pairs a thread (V = 4 with vector loads, else 1)
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    rope_kernel(const RopeArgs a) {
  const T* x = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);
  const int D = 2 * a.half, groups = a.half / V;
  const long long rows = a.P * a.S * a.I;
  const long long total = rows * groups;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long r = i / groups;
    const int j = static_cast<int>(i - r * groups) * V;
    const long long ps = r / a.I;  // (prefix row, position)
    const int s = static_cast<int>(ps % a.S);
    const long long p = ps / a.S;
    const long long trow = a.per_row ? (p / a.pre) * a.S + s : s;
    const float* cp = a.cos + trow * a.half + j;
    const float* sp = a.sin + trow * a.half + j;
    const T* xr = x + r * D;
    T* orow = out + r * D;
    float c[V], sn[V], x1[V], x2[V];
    if constexpr (V == 1) {
      c[0] = *cp;
      sn[0] = *sp;
    } else {
      const float4 cv = *reinterpret_cast<const float4*>(cp);
      const float4 sv = *reinterpret_cast<const float4*>(sp);
      c[0] = cv.x, c[1] = cv.y, c[2] = cv.z, c[3] = cv.w;
      sn[0] = sv.x, sn[1] = sv.y, sn[2] = sv.z, sn[3] = sv.w;
    }
    if (a.interleaved) {
      Vec<T, 2 * V> xv = *reinterpret_cast<const Vec<T, 2 * V>*>(xr + 2 * j);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        x1[e] = to_f32(xv.v[2 * e]);
        x2[e] = to_f32(xv.v[2 * e + 1]);
      }
      Vec<T, 2 * V> ov;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float o1, o2;
        rotate(x1[e], x2[e], c[e], a.sign * sn[e], o1, o2);
        ov.v[2 * e] = from_f32<T>(o1);
        ov.v[2 * e + 1] = from_f32<T>(o2);
      }
      *reinterpret_cast<Vec<T, 2 * V>*>(orow + 2 * j) = ov;
    } else {
      Vec<T, V> v1 = *reinterpret_cast<const Vec<T, V>*>(xr + j);
      Vec<T, V> v2 = *reinterpret_cast<const Vec<T, V>*>(xr + a.half + j);
      Vec<T, V> o1v, o2v;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float o1, o2;
        rotate(to_f32(v1.v[e]), to_f32(v2.v[e]), c[e], a.sign * sn[e], o1,
               o2);
        o1v.v[e] = from_f32<T>(o1);
        o2v.v[e] = from_f32<T>(o2);
      }
      *reinterpret_cast<Vec<T, V>*>(orow + j) = o1v;
      *reinterpret_cast<Vec<T, V>*>(orow + a.half + j) = o2v;
    }
  }
}

template <typename T>
int launch(const RopeArgs& a, int vec, cudaStream_t st) {
  const long long pairs = a.P * a.S * a.I * a.half;
  const long long items = vec ? pairs / 4 : pairs;
  // enough blocks to fill every SM several times; the loop covers the rest
  const long long want = (items + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  if (vec) {
    note_launch(rope_kernel<T, 4>, 0, kThreads);
    rope_kernel<T, 4><<<blocks, kThreads, 0, st>>>(a);
  } else {
    note_launch(rope_kernel<T, 1>, 0, kThreads);
    rope_kernel<T, 1><<<blocks, kThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: contiguous (P, S, I, 2·half) in `dtype`; cos, sin: fp32 (S, half)
// or, with per_row, (P / pre, S, half). sign +1 forward, -1 backward. vec:
// half % 4 == 0 and x, out, cos, sin 32-byte aligned.
extern "C" int apex1_rope(const void* x, const void* cos, const void* sin,
                          void* out, long long P, int S, int I, int half,
                          int pre, int per_row, int interleaved, float sign,
                          int vec, int dtype, void* stream) {
  if (P <= 0 || S <= 0 || I <= 0 || half <= 0) return 0;
  if (pre <= 0 || (vec && half % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  RopeArgs a{};
  a.x = x;
  a.cos = static_cast<const float*>(cos);
  a.sin = static_cast<const float*>(sin);
  a.out = out;
  a.P = P;
  a.S = S;
  a.I = I;
  a.half = half;
  a.pre = pre;
  a.per_row = per_row;
  a.interleaved = interleaved;
  a.sign = sign;
  cudaStream_t st = as_stream(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(a, vec, st);
    case kBF16:
      return launch<__nv_bfloat16>(a, vec, st);
    case kF16:
      return launch<__half>(a, vec, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
