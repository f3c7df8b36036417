// Multi-tenant LoRA logit delta through adapter pages, for Hopper (sm_90a).
//
// Replaces: apex1_tpu/ops/lora_epilogue.py::_lora_kernel (launched by
// lora_delta, pallas_call :165).
//
//   h (N, H) f32/bf16/f16 hidden rows; A pages (P, H) and B pages (P, V)
//   fp32; bt (N, R) int32 page ids; out (N, V) fp32 with
//   out[n] = Σ_r (h[n] · A[bt[n, r]]) · B[bt[n, r]].
//
// Bound on the H100: bytes. Each output costs R multiply-adds against one
// B value read per rank (4 bytes a flop), and the coefficients are R dot
// products of length H per row: the rows' hidden states, the pages they
// name (each read once) and the output, over 3.35 TB/s.
//
// Design. The TPU kernel walks a (row, vocab tile, rank) grid, rank
// innermost, accumulating coef_r · B[page_r] in a VMEM tile. Here one block
// owns one row and a 2048-wide vocab tile. It reads the row's R page ids,
// then its 8 warps compute the R coefficients h[n]·A[page] in fp32, each
// in a fixed order (lane-strided partial sums, then an xor butterfly), so
// every vocab tile of the row gets the same bits, and keeps them in shared
// memory. Each thread then accumulates coef[r] · B[page_r, v] for its
// columns in rank order r = 0..R-1 (16-byte loads when V allows) and writes
// each output once: no atomics, and no sum across rows, so a row's result
// depends on that row's operands alone (a mixed-tenant batch equals each
// row run alone, bit for bit). Page 0 is the pool's zero page: a row that
// names only it gets exactly 0.0.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVT = 2048;  // vocab columns a block

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lora_delta_kernel(const T* __restrict__ h, const float* __restrict__ A,
                      const float* __restrict__ B, const int* __restrict__ bt,
                      float* __restrict__ out, int H, int V, int R,
                      int vec4) {
  extern __shared__ float smem[];
  float* coef = smem;
  int* ids = reinterpret_cast<int*>(smem + R);
  const int n = blockIdx.y;
  for (int r = threadIdx.x; r < R; r += kThreads) ids[r] = bt[size_t(n) * R + r];
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* hr = h + size_t(n) * H;
  for (int r = warp; r < R; r += kThreads / 32) {
    const float* ar = A + size_t(ids[r]) * H;
    float s = 0.f;
    for (int i = lane; i < H; i += 32) s += to_f32(hr[i]) * ar[i];
    s = warp_sum(s);
    if (lane == 0) coef[r] = s;
  }
  __syncthreads();
  const int v0 = blockIdx.x * kVT, v1 = min(V, v0 + kVT);
  float* orow = out + size_t(n) * V;
  if (vec4) {
    for (int c = v0 + 4 * threadIdx.x; c < v1; c += 4 * kThreads) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int r = 0; r < R; ++r) {
        const float4 b =
            *reinterpret_cast<const float4*>(B + size_t(ids[r]) * V + c);
        const float k = coef[r];
        acc.x += k * b.x;
        acc.y += k * b.y;
        acc.z += k * b.z;
        acc.w += k * b.w;
      }
      *reinterpret_cast<float4*>(orow + c) = acc;
    }
  } else {
    for (int c = v0 + threadIdx.x; c < v1; c += kThreads) {
      float acc = 0.f;
      for (int r = 0; r < R; ++r) acc += coef[r] * B[size_t(ids[r]) * V + c];
      orow[c] = acc;
    }
  }
}

template <typename T>
int launch(const void* h, const void* a, const void* b, const void* bt,
           void* out, int N, int H, int V, int R, int vec4, cudaStream_t st) {
  const size_t smem = size_t(R) * (sizeof(float) + sizeof(int));
  auto kern = lora_delta_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((V + kVT - 1) / kVT, N);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(h), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const int*>(bt),
      static_cast<float*>(out), H, V, R, vec4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h (N, H) in `dtype`, a_pages (P, H) and b_pages (P, V) fp32, bt (N, R)
// int32, out (N, V) fp32, all contiguous. vec4: V % 4 == 0 and b_pages, out
// 16-byte aligned.
extern "C" int apex1_lora_delta(const void* h, const void* a_pages,
                                const void* b_pages, const void* bt, void* out,
                                int N, int H, int V, int R, int vec4,
                                int dtype, void* stream) {
  if (N <= 0 || V <= 0) return 0;
  if (H <= 0 || R <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = as_stream(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(h, a_pages, b_pages, bt, out, N, H, V, R, vec4, st);
    case kBF16:
      return launch<__nv_bfloat16>(h, a_pages, b_pages, bt, out, N, H, V, R,
                                   vec4, st);
    case kF16:
      return launch<__half>(h, a_pages, b_pages, bt, out, N, H, V, R, vec4,
                            st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
