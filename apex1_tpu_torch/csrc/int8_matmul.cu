// Weight-only int8 matmul for Hopper (sm_90a): y = (bf16(x) · bf16(Wq)ᵀ)
// summed in fp32, times the per-output-channel fp32 scale.
//
// Replaces: apex1_tpu/ops/quantized.py::_int8_mm_kernel (launched by
// _pallas_int8_matmul, pallas_call :112).
//
//   x (T, K) bf16; Wq (N, K) int8; scale (N,) fp32; y (T, N) fp32.
//
// Bound on the H100: bytes at decode. One decode step of the 0.8B Llama
// (T = 8) reads every weight once for 8 rows of work: 2·T flop per weight
// byte, far below the ~295 flop/byte ridge, so the time is the int8 weight
// bytes over 3.35 TB/s (half the bf16 matrix's). Prefill (T = 1024) is
// above the ridge: operations at the bf16 tensor-core rate.
//
// Design. The TPU kernel keeps the int8 tile in VMEM, casts it to bf16
// there and feeds the MXU, so the bf16 matrix never exists in HBM. Here a
// block of 4 warps owns 64 weight rows (output channels) x BT tokens and
// streams K in 64-deep steps: each thread reads its share of the int8 tile
// as 16-byte vectors (the next step's while the current one computes),
// converts the values to bf16 in registers (exact: |q| <= 127) and stores
// them to shared memory; x's tile is copied as it is. The product runs on
// mma.sync m16n8k16 (bf16, fp32 accumulators) with the WEIGHT on the
// 16-row side and the tokens on the 8-column side, so decode's T = 8 fills
// the MMA instead of wasting half of it (warp w: weight rows 16w..16w+15;
// A fragments by ldmatrix, B fragments by 32-bit loads of x's k-contiguous
// rows). A narrow projection (N = 256 at decode: 4 blocks) would leave the
// 132 SMs idle, so K is split across gridDim.z until about 4 blocks an SM
// are in flight; each split writes its fp32 partial sums, and a second
// kernel adds them in split order (fixed, no atomics: two launches give
// the same bits) and applies the scale. The scale is applied once, after
// the whole K sum, as the TPU kernel does on its last K block. Every shape
// is taken: ragged N, T and K tiles are zero-filled in shared memory;
// K % 16 != 0 or unaligned pointers take the scalar loads. Not yet: TMA,
// wgmma, a warp-specialized dequantizing pipeline.

#include "mma.cuh"

namespace {

constexpr int kBN = 64;        // weight rows a block (4 warps x 16)
constexpr int kKT = 64;        // K depth of one step
constexpr int kLds = kKT + 8;  // shared row stride (bf16): conflict-free
constexpr int kThreads = 128;

struct I8Args {
  const __nv_bfloat16* x;  // (T, K)
  const int8_t* w;         // (N, K)
  const float* scale;      // (N,)
  float* out;              // (T, N)
  float* part;             // (splits, T, N) partial sums, or null
  int T, N, K, kc;
};

// 16 int8 values -> 16 bf16 values (two 16-byte words)
__device__ __forceinline__ void i8x16_to_bf16(const int4& v, int4 (&o)[2]) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&v);
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(o);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    p[j] = __floats2bfloat162_rn(static_cast<float>(b[2 * j]),
                                 static_cast<float>(b[2 * j + 1]));
}

template <int NT, bool VEC>
__global__ void __launch_bounds__(kThreads) int8_mm_kernel(const I8Args a) {
  constexpr int BT = 8 * NT;
  constexpr int WCH = kBN * kKT / 16 / kThreads;  // int8 16-byte chunks
  constexpr int XCH = (BT * kKT / 8 + kThreads - 1) / kThreads;  // bf16
  __shared__ __align__(16) __nv_bfloat16 sW[kBN * kLds];
  __shared__ __align__(16) __nv_bfloat16 sX[BT * kLds];
  const int n0 = blockIdx.x * kBN, t0 = blockIdx.y * BT;
  const int kbeg = blockIdx.z * a.kc, kend = min(a.K, kbeg + a.kc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  int4 wreg[WCH], xreg[XCH];
  // global -> registers (VEC): whole 16-byte chunks, zero outside the
  // tile; K % 16 == 0 there, so a chunk never straddles kend
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < WCH; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int r = c / (kKT / 16), col = (c % (kKT / 16)) * 16;
      const int n = n0 + r, k = k0 + col;
      wreg[i] = (n < a.N && k < kend)
                    ? *reinterpret_cast<const int4*>(a.w + size_t(n) * a.K + k)
                    : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < XCH; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int r = c / (kKT / 8), col = (c % (kKT / 8)) * 8;
      const int t = t0 + r, k = k0 + col;
      xreg[i] = (c < BT * kKT / 8 && t < a.T && k < kend)
                    ? *reinterpret_cast<const int4*>(a.x + size_t(t) * a.K + k)
                    : make_int4(0, 0, 0, 0);
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < WCH; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int r = c / (kKT / 16), col = (c % (kKT / 16)) * 16;
      int4 o[2];
      i8x16_to_bf16(wreg[i], o);
      *reinterpret_cast<int4*>(&sW[r * kLds + col]) = o[0];
      *reinterpret_cast<int4*>(&sW[r * kLds + col + 8]) = o[1];
    }
#pragma unroll
    for (int i = 0; i < XCH; ++i) {
      const int c = threadIdx.x + i * kThreads;
      if (c < BT * kKT / 8) {
        const int r = c / (kKT / 8), col = (c % (kKT / 8)) * 8;
        *reinterpret_cast<int4*>(&sX[r * kLds + col]) = xreg[i];
      }
    }
  };
  // scalar staging: any K, any alignment
  auto fill_scalar = [&](int k0) {
    for (int i = threadIdx.x; i < kBN * kKT; i += kThreads) {
      const int r = i / kKT, col = i % kKT, n = n0 + r, k = k0 + col;
      const float v =
          (n < a.N && k < kend) ? static_cast<float>(a.w[size_t(n) * a.K + k])
                                : 0.f;
      sW[r * kLds + col] = __float2bfloat16_rn(v);
    }
    for (int i = threadIdx.x; i < BT * kKT; i += kThreads) {
      const int r = i / kKT, col = i % kKT, t = t0 + r, k = k0 + col;
      sX[r * kLds + col] = (t < a.T && k < kend)
                               ? a.x[size_t(t) * a.K + k]
                               : __float2bfloat16_rn(0.f);
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  if constexpr (VEC) fetch(kbeg);
  for (int k0 = kbeg; k0 < kend; k0 += kKT) {
    if constexpr (VEC) {
      stash();
    } else {
      fill_scalar(k0);
    }
    __syncthreads();
    if constexpr (VEC) {
      if (k0 + kKT < kend) fetch(k0 + kKT);  // in flight during the MMAs
    }
#pragma unroll
    for (int kk = 0; kk < kKT; kk += 16) {
      unsigned af[4];
      load_a<__nv_bfloat16>(af, &sW[(warp * 16) * kLds + kk], kLds);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* xb =
            &sX[(8 * j + lane / 4) * kLds + kk + 2 * (lane % 4)];
        const unsigned b0 = *reinterpret_cast<const unsigned*>(xb);
        const unsigned b1 = *reinterpret_cast<const unsigned*>(xb + 8);
        mma16816<__nv_bfloat16>(acc[j], af, b0, b1);
      }
    }
    __syncthreads();
  }

  // accumulator (j, e): weight row n0 + 16·warp + lane/4 (+8 for e >= 2),
  // token t0 + 8j + 2·(lane%4) (+1 for odd e)
  const int nb = n0 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = nb + 8 * (e / 2), t = t0 + 8 * j + 2 * (lane % 4) + e % 2;
      if (n >= a.N || t >= a.T) continue;
      if (a.part == nullptr)
        a.out[size_t(t) * a.N + n] = acc[j][e] * a.scale[n];
      else
        a.part[(size_t(blockIdx.z) * a.T + t) * a.N + n] = acc[j][e];
    }
  }
}

// y[t, n] = (Σ_z part[z, t, n]) · scale[n], the splits added in order
__global__ void int8_mm_reduce(const float* part, const float* scale,
                               float* out, int T, int N, int splits) {
  const size_t total = size_t(T) * N;
  for (size_t i = blockIdx.x * size_t(blockDim.x) + threadIdx.x; i < total;
       i += size_t(gridDim.x) * blockDim.x) {
    float s = part[i];
    for (int z = 1; z < splits; ++z) s += part[size_t(z) * total + i];
    out[i] = s * scale[i % N];
  }
}

template <int NT, bool VEC>
int launch(const I8Args& a, int splits, cudaStream_t st) {
  constexpr int BT = 8 * NT;
  const dim3 grid((a.N + kBN - 1) / kBN, (a.T + BT - 1) / BT, splits);
  int8_mm_kernel<NT, VEC><<<grid, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (T, K) bf16, w (N, K) int8, scale (N,) fp32, out (T, N) fp32, all
// contiguous. splits > 1: K is cut into `splits` slices of kc (a multiple
// of 64) and part holds splits x T x N fp32 partial sums. nt8: tile the
// tokens 64 at a time (else 8). vec: K % 16 == 0 and x, w 16-byte aligned.
extern "C" int apex1_int8_mm(const void* x, const void* w, const void* scale,
                             void* out, void* part, int T, int N, int K,
                             int splits, int kc, int nt8, int vec,
                             void* stream) {
  if (T <= 0 || N <= 0) return 0;
  if (K <= 0 || splits < 1 || kc <= 0 || kc % kKT != 0 ||
      (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  I8Args a{static_cast<const __nv_bfloat16*>(x),
           static_cast<const int8_t*>(w),
           static_cast<const float*>(scale),
           static_cast<float*>(out),
           splits > 1 ? static_cast<float*>(part) : nullptr,
           T, N, K, kc};
  cudaStream_t st = as_stream(stream);
  int err;
  if (nt8)
    err = vec ? launch<8, true>(a, splits, st) : launch<8, false>(a, splits, st);
  else
    err = vec ? launch<1, true>(a, splits, st) : launch<1, false>(a, splits, st);
  if (err != 0 || splits == 1) return err;
  const size_t total = size_t(T) * N, want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  int8_mm_reduce<<<blocks, 256, 0, st>>>(a.part, a.scale, a.out, T, N,
                                         splits);
  return static_cast<int>(cudaGetLastError());
}
