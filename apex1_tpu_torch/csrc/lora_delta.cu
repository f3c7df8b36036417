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
// innermost, accumulating coef_r · B[page_r] in a VMEM tile. Here two
// kernels:
// - lora_coef_kernel computes the N·R coefficients h[n]·A[page] once, a
//   warp each: every lane starts its 16-byte loads of h (in its own
//   dtype) and of A for up to kGroups 8-element groups before it sums
//   them, in a fixed order (the lane's groups in turn, then the xor
//   butterfly), so a coefficient does not depend on the batch; they go
//   to an (N, R) fp32 workspace.
// - lora_stream_kernel, launched as its programmatic dependent, streams
//   B: a block owns 512 columns, a float4 (or four strided scalars where
//   V is not a multiple of 4) a thread, of one row or of a few rows in
//   turn (ops/lora_epilogue.py::lora_rows: where the grid would hold
//   more than 4 blocks an SM). It reads the rows' page ids and starts
//   the first row's B loads (all R of them for a rank of 8, 16 or 32,
//   the rank a template parameter; 32 at a time past that; 8 at a time
//   for any other rank) before it waits for the coefficients, so the
//   first kernel hides behind the stream. A row that names the same
//   pages as the row before it (a verify step's K + 1 rows of a slot)
//   reuses the B values in registers instead of reading them again
//   through L2. Each output is Σ coef[r] · B[page_r, v] in rank order
//   r = 0..R-1, written once: no atomics, and no sum across rows, so a
//   row's result depends on that row's operands alone (a mixed-tenant
//   batch equals each row run alone, bit for bit) and every launch gives
//   the same bits. Page 0 is the pool's zero page: a row that names only
//   it gets exactly 0.0.

#include "common.cuh"

namespace {

constexpr int kCoefWarps = 4;  // coefficients a block of the first kernel
constexpr int kGroups = 8;     // 8-element groups a lane loads, then sums
constexpr int kThreads = 128;
constexpr int kVT = 4 * kThreads;  // vocab columns a block of the stream

// 8 consecutive elements as floats: two float4, or one 16-byte load of
// 8 half values
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&x)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = to_f32(e[i]);
}

// coef[w] = h[n] · A[bt[w]] for the warp's w = n·R + r. vec: H % 8 == 0
// and h, A 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(32 * kCoefWarps)
    lora_coef_kernel(const T* __restrict__ h, const float* __restrict__ A,
                     const int* __restrict__ bt, float* __restrict__ coef,
                     int NR, int H, int R, int vec) {
  let_next_start();
  const int w = blockIdx.x * kCoefWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= NR) return;
  const T* hr = h + size_t(w / R) * H;
  const float* ar = A + size_t(__ldg(bt + w)) * H;
  float s = 0.f;
  if (vec) {
    const int groups = H / 8;
    for (int g0 = lane; g0 < groups; g0 += 32 * kGroups) {
      float hx[kGroups][8], ax[kGroups][8];
#pragma unroll
      for (int u = 0; u < kGroups; ++u) {
        const int g = g0 + 32 * u;
        if (g < groups) {
          load8(hr + 8 * g, hx[u]);
          load8(ar + 8 * g, ax[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kGroups; ++u) {
        if (g0 + 32 * u < groups) {
#pragma unroll
          for (int e = 0; e < 8; ++e) s += hx[u][e] * ax[u][e];
        }
      }
    }
  } else {
    for (int i = lane; i < H; i += 32) s += to_f32(hr[i]) * ar[i];
  }
  s = warp_sum(s);
  if (lane == 0) coef[w] = s;
}

// out[n, c] = Σ_r coef[n, r] · B[bt[n, r], c] over this block's 512
// columns, for its `rows` rows n in turn. RT: the rank, or 0 for any
// rank (a runtime loop). vec4: V % 4 == 0 and B, out 16-byte aligned.
template <int RT>
__global__ void __launch_bounds__(kThreads)
    lora_stream_kernel(const float* __restrict__ B, const int* __restrict__ bt,
                       const float* __restrict__ coef,
                       float* __restrict__ out, int N, int V, int R,
                       int rows, int vec4) {
  // the rank's loads in flight at once: all of it up to 32
  constexpr int CH = RT == 0 ? 8 : (RT < 32 ? RT : 32);
  const int rank = RT ? RT : R;
  const int n0 = blockIdx.y * rows, nr = min(rows, N - n0);
  extern __shared__ float smem[];
  float* ks = smem;                                  // (nr, rank)
  int* ids = reinterpret_cast<int*>(smem + nr * rank);  // (nr, rank)
  for (int i = threadIdx.x; i < nr * rank; i += kThreads)
    ids[i] = __ldg(bt + size_t(n0) * rank + i);
  __syncthreads();
  // this thread's columns: a float4 at c, or c, c + 128, c + 256, c + 384
  const int c = blockIdx.x * kVT + (vec4 ? 4 * threadIdx.x : threadIdx.x);
  const auto load4 = [&](const float* row, float (&b)[4]) {
    if (vec4) {
      const float4 x = c < V ? __ldg(reinterpret_cast<const float4*>(row + c))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      b[0] = x.x, b[1] = x.y, b[2] = x.z, b[3] = x.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ce = c + e * kThreads;
        b[e] = ce < V ? __ldg(row + ce) : 0.f;
      }
    }
  };
  // b holds every rank's values where the rank fits one chunk: a row that
  // names the same pages as the row before it reuses them
  const bool whole = rank <= CH;
  float b[CH][4];
  for (int g = 0; g < nr; ++g) {
    const int* gid = ids + g * rank;
    bool reuse = whole && g > 0;
    for (int r = 0; reuse && r < rank; ++r) reuse = gid[r] == gid[r - rank];
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r0 = 0; r0 < rank; r0 += CH) {
      if (!reuse) {
#pragma unroll
        for (int j = 0; j < CH; ++j)
          if (RT != 0 || r0 + j < rank)
            load4(B + size_t(gid[r0 + j]) * V, b[j]);
      }
      if (g == 0 && r0 == 0) {
        // the coefficients: the first kernel's writes, visible from here
        wait_prior();
        for (int i = threadIdx.x; i < nr * rank; i += kThreads)
          ks[i] = __ldcg(coef + size_t(n0) * rank + i);
        __syncthreads();
      }
      const float* gk = ks + g * rank + r0;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        if (RT != 0 || r0 + j < rank) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[e] += gk[j] * b[j][e];
        }
      }
    }
    float* orow = out + size_t(n0 + g) * V;
    if (vec4) {
      if (c < V)
        *reinterpret_cast<float4*>(orow + c) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e * kThreads < V) orow[c + e * kThreads] = acc[e];
    }
  }
}

template <int RT>
cudaError_t launch_stream(const float* b, const int* bt, const float* coef,
                          float* out, int N, int V, int R, int rows,
                          int vec4, cudaStream_t st) {
  const size_t smem = size_t(rows) * R * (sizeof(float) + sizeof(int));
  auto kern = lora_stream_kernel<RT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((V + kVT - 1) / kVT, (N + rows - 1) / rows);
  return launch_after_smem(kern, grid, dim3(kThreads), smem, st, b, bt, coef,
                           out, N, V, R, rows, vec4);
}

template <typename T>
int launch(const void* h, const void* a, const void* b, const void* bt,
           void* coef, void* out, int N, int H, int V, int R, int rows,
           int hvec, int vec4, cudaStream_t st) {
  const int nr = N * R;
  note_launch(lora_coef_kernel<T>, 0, 32 * kCoefWarps);
  lora_coef_kernel<T><<<(nr + kCoefWarps - 1) / kCoefWarps,
                        32 * kCoefWarps, 0, st>>>(
      static_cast<const T*>(h), static_cast<const float*>(a),
      static_cast<const int*>(bt), static_cast<float*>(coef), nr, H, R, hvec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto* bp = static_cast<const float*>(b);
  const auto* ip = static_cast<const int*>(bt);
  const auto* cp = static_cast<const float*>(coef);
  auto* op = static_cast<float*>(out);
  switch (R) {
    case 8:
      e = launch_stream<8>(bp, ip, cp, op, N, V, R, rows, vec4, st);
      break;
    case 16:
      e = launch_stream<16>(bp, ip, cp, op, N, V, R, rows, vec4, st);
      break;
    case 32:
      e = launch_stream<32>(bp, ip, cp, op, N, V, R, rows, vec4, st);
      break;
    case 64:
      e = launch_stream<64>(bp, ip, cp, op, N, V, R, rows, vec4, st);
      break;
    default:
      e = launch_stream<0>(bp, ip, cp, op, N, V, R, rows, vec4, st);
  }
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}

}  // namespace

// h (N, H) in `dtype`, a_pages (P, H) and b_pages (P, V) fp32, bt (N, R)
// int32, coef an (N, R) fp32 workspace, out (N, V) fp32, all contiguous.
// rows: rows a block of the stream kernel (ops/lora_epilogue.py::
// lora_rows). hvec: H % 8 == 0 and h, a_pages 16-byte aligned; vec4:
// V % 4 == 0 and b_pages, out 16-byte aligned.
extern "C" int apex1_lora_delta(const void* h, const void* a_pages,
                                const void* b_pages, const void* bt,
                                void* coef, void* out, int N, int H, int V,
                                int R, int rows, int hvec, int vec4,
                                int dtype, void* stream) {
  if (N <= 0 || V <= 0) return 0;
  if (H <= 0 || R <= 0 || rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = as_stream(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(h, a_pages, b_pages, bt, coef, out, N, H, V, R,
                           rows, hvec, vec4, st);
    case kBF16:
      return launch<__nv_bfloat16>(h, a_pages, b_pages, bt, coef, out, N, H,
                                   V, R, rows, hvec, vec4, st);
    case kF16:
      return launch<__half>(h, a_pages, b_pages, bt, coef, out, N, H, V, R,
                            rows, hvec, vec4, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
