// Ragged paged attention over the serving KV pool, for Hopper (sm_90a).
//
// Replaces: apex1_tpu/ops/paged_decode.py::_paged_attn_kernel (launched
// by paged_attend), the Pallas TPU kernel whose sequential grid
// (N, Hkv, pages) carries an online softmax across pages in VMEM
// scratch, with the block table scalar-prefetched into the index maps.
//
// Bound on the H100: memory. A decode query row does 4*D flops per
// cached position it reads (2*D*elt bytes of K and V), under one flop
// per byte, so the K/V bytes up to each row's horizon set the floor.
// Prefill chunks (S = prefill_chunk rows against the same pages) raise
// the flops per byte by S but stay small next to the model's matmuls.
//
// Design: Hopper blocks run in parallel with nothing carried between
// them, so the TPU's page axis becomes a loop inside the block. One
// block per (row n, kv-head h, tile of up to 16 query rows), where the
// query rows are the G*S (GQA group x chunk) rows that share kv-head h.
// The block reads its own block-table entries, loads each (P, D) K and
// V page into shared memory converted to f32 (f32, bf16, f16 or int8
// pages: the int8 tier's dequant is this conversion, no scales), and
// folds the page into each row's running max, sum and f32 accumulator.
// Query row r sees global positions t*P + col <= len + (r % S); pages
// wholly past the horizon len + S - 1 are never read, so the work
// tracks each row's real depth. A row with nothing visible returns 0
// (the l > 0 guard). K rows are padded by one float in shared memory
// so the per-column dot products do not collide on one bank.
// wgmma, TMA and a split over pages are later work.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRowTile = 16;
constexpr float kNegInf = -1e30f;

size_t smem_bytes(int d, int p) {
  return sizeof(float) *
         (static_cast<size_t>(kRowTile) * d * 2 +  // Q tile, accumulator
          static_cast<size_t>(p) * (d + 1) +       // K page (padded)
          static_cast<size_t>(p) * d +             // V page
          static_cast<size_t>(kRowTile) * p +      // scores / probs
          3 * kRowTile);                           // m, l, correction
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
    paged_attend_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                        const TKV* __restrict__ vp,
                        const int* __restrict__ bt,
                        const int* __restrict__ lens, TQ* __restrict__ out,
                        int hkv, int rows_total, int s, int d, int p,
                        int t_pages, float scale) {
  extern __shared__ float smem[];
  const int n = blockIdx.x, h = blockIdx.y, r0 = blockIdx.z * kRowTile;
  const int rows = min(kRowTile, rows_total - r0);
  const int ks = d + 1;
  float* qs = smem;
  float* acc = qs + kRowTile * d;
  float* kbuf = acc + kRowTile * d;
  float* vbuf = kbuf + p * ks;
  float* sc = vbuf + p * d;
  float* m_run = sc + kRowTile * p;
  float* l_run = m_run + kRowTile;
  float* corr = l_run + kRowTile;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, n_warps = kThreads >> 5;
  const int len = lens[n];
  // q and out viewed as (N, Hkv, G*S, D): row r of kv-head h is query
  // head h*G + r/S at chunk position r%S
  const size_t q_off = ((static_cast<size_t>(n) * hkv + h) * rows_total +
                        r0) * d;
  for (int e = tid; e < rows * d; e += kThreads) {
    qs[e] = to_f32(q[q_off + e]);
    acc[e] = 0.f;
  }
  for (int r = tid; r < kRowTile; r += kThreads) {
    m_run[r] = kNegInf;
    l_run[r] = 0.f;
  }
  __syncthreads();

  const int horizon = len + s - 1;
  const int* row_bt = bt + static_cast<size_t>(n) * t_pages;
  const size_t page_stride = static_cast<size_t>(hkv) * p * d;
  for (int t = 0; t < t_pages && t * p <= horizon; ++t) {
    const size_t base = static_cast<size_t>(row_bt[t]) * page_stride +
                        static_cast<size_t>(h) * p * d;
    for (int e = tid; e < p * d; e += kThreads) {
      const int c = e / d;
      kbuf[c * ks + (e - c * d)] = to_f32(kp[base + e]);
      vbuf[e] = to_f32(vp[base + e]);
    }
    __syncthreads();
    for (int e = tid; e < rows * p; e += kThreads) {
      const int r = e / p, c = e - r * p;
      const float* qr = qs + r * d;
      const float* kc = kbuf + c * ks;
      float dot = 0.f;
      for (int j = 0; j < d; ++j) dot += qr[j] * kc[j];
      const bool keep = t * p + c <= len + (r0 + r) % s;
      sc[e] = keep ? dot * scale : kNegInf;
    }
    __syncthreads();
    for (int r = warp; r < rows; r += n_warps) {
      const int lim = len + (r0 + r) % s - t * p;  // visible cols <= lim
      float mx = kNegInf;
      for (int c = lane; c < p; c += 32) mx = fmaxf(mx, sc[r * p + c]);
      mx = warp_max(mx);
      const float m_prev = m_run[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < p; c += 32) {
        const float e = c <= lim ? expf(sc[r * p + c] - m_new) : 0.f;
        sc[r * p + c] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float cf = expf(m_prev - m_new);
        corr[r] = cf;
        l_run[r] = l_run[r] * cf + sum;
        m_run[r] = m_new;
      }
    }
    __syncthreads();
    for (int e = tid; e < rows * d; e += kThreads) {
      const int r = e / d, j = e - r * d;
      const float* pr = sc + r * p;
      float pv = 0.f;
      for (int c = 0; c < p; ++c) pv += pr[c] * vbuf[c * d + j];
      acc[e] = acc[e] * corr[r] + pv;
    }
    __syncthreads();
  }
  for (int e = tid; e < rows * d; e += kThreads) {
    const float l = l_run[e / d];
    out[q_off + e] = from_f32<TQ>(acc[e] / (l > 0.f ? l : 1.f));
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const int* bt,
           const int* lens, void* out, int n, int hkv, int rows_total,
           int s, int d, int p, int t_pages, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(d, p);
  auto kern = paged_attend_kernel<TQ, TKV>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(n, hkv, (rows_total + kRowTile - 1) / kRowTile);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), bt, lens, static_cast<TQ*>(out), hkv,
      rows_total, s, d, p, t_pages, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ>
int launch_kv(int kv_dtype, const void* q, const void* k, const void* v,
              const int* bt, const int* lens, void* out, int n, int hkv,
              int rows_total, int s, int d, int p, int t_pages, float scale,
              cudaStream_t st) {
  switch (kv_dtype) {
    case kF32:
      return launch<TQ, float>(q, k, v, bt, lens, out, n, hkv, rows_total,
                               s, d, p, t_pages, scale, st);
    case kBF16:
      return launch<TQ, __nv_bfloat16>(q, k, v, bt, lens, out, n, hkv,
                                       rows_total, s, d, p, t_pages, scale,
                                       st);
    case kF16:
      return launch<TQ, __half>(q, k, v, bt, lens, out, n, hkv, rows_total,
                                s, d, p, t_pages, scale, st);
    case kI8:
      return launch<TQ, int8_t>(q, k, v, bt, lens, out, n, hkv, rows_total,
                                s, d, p, t_pages, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int apex1_paged_attend(const void* q, const void* k,
                                  const void* v, const void* bt,
                                  const void* lens, void* out, int n, int hq,
                                  int hkv, int s, int d, int p, int t_pages,
                                  float scale, int q_dtype, int kv_dtype,
                                  void* stream) {
  if (n <= 0 || hq <= 0 || s <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int rows_total = (hq / hkv) * s;
  const int* b = static_cast<const int*>(bt);
  const int* l = static_cast<const int*>(lens);
  cudaStream_t st = as_stream(stream);
  switch (q_dtype) {
    case kF32:
      return launch_kv<float>(kv_dtype, q, k, v, b, l, out, n, hkv,
                              rows_total, s, d, p, t_pages, scale, st);
    case kBF16:
      return launch_kv<__nv_bfloat16>(kv_dtype, q, k, v, b, l, out, n, hkv,
                                      rows_total, s, d, p, t_pages, scale,
                                      st);
    case kF16:
      return launch_kv<__half>(kv_dtype, q, k, v, b, l, out, n, hkv,
                               rows_total, s, d, p, t_pages, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
