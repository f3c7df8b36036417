// Ragged paged attention over the serving KV pool, for Hopper (sm_90a), as
// flash-decoding: the page axis is split across blocks.
//
// Replaces: apex1_tpu/ops/paged_decode.py::_paged_attn_kernel (launched
// by paged_attend), the Pallas TPU kernel whose sequential grid
// (N, Hkv, pages) carries an online softmax across pages in VMEM
// scratch, with the block table scalar-prefetched into the index maps.
//
// Query row r of kv head h (the G·S rows of the GQA group and chunk that
// share h: query head h·G + r / S at chunk position j = r % S) sees the
// positions t·P + c <= len[n] + j of its row's pages, through the block
// table. Pages may be f32, bf16, fp16 or int8 (the int8 tier's dequant is
// the exact conversion, no scales). A row with nothing visible returns 0.
//
// Bound on the H100: memory at decode. A decode row does 4·D flops per
// cached position it reads (2·D·elt bytes of K and V), under one flop a
// byte, so the K/V bytes up to each row's horizon len + S - 1 set the
// floor; a prefill chunk of S rows against the same pages raises the
// flops a byte by G·S.
//
// Design. The TPU's sequential page axis carried one online softmax; a
// Hopper block walking all of a row's pages alone leaves most SMs idle at
// decode (N·Hkv blocks: 96 at GPT-2's batch of 8). So the positions
// 0 .. T·P - 1 are cut into key blocks of 64 and those into `splits` runs
// of `per` key blocks (ops/paged_decode.py: paged_geometry, from N, Hq,
// Hkv, S, P and T, never from the lengths, so a call stays capturable in
// a CUDA graph): a block per (n, h, run, row tile). A block whose run
// starts past its rows' horizon len + S - 1 exits at once. Each run keeps
// its own (m, l, fp32 accumulator) per row; with one run the block writes
// the output, else it writes them to a workspace sized in Python, and a
// second kernel, launched as a programmatic dependent, folds each row's
// live runs in index order (no atomics: the same bits on every launch).
//
// A key block's K and V rows (each from its page through the block table,
// so a run may end mid-page) are copied into shared memory in their own
// dtype by 16-byte cp.async, two key blocks in the ring: the next is in
// flight while this one is used. A row is 16-byte chunks, chunk c of row r
// at c ^ (r % 8), so reads down a column of chunks meet no bank twice.
// Positions past T·P or the block's horizon are neither read nor summed.
// Two paths:
// - CUDA cores (decode, G·S <= 4, and every fp32 or mixed-type call): up
//   to 16 rows a block, q in shared memory as fp32; QK by two threads a
//   key (half the head dim each, then a shuffle), values widened to fp32
//   in registers; a warp a row for the softmax; P·V in fp32 by (4-column
//   group, key slice) threads whose sums stay in registers for the whole
//   run and are added in slice order at its end.
// - Tensor cores (prefill chunks, G·S > 4, bf16/fp16 q with pages of its
//   type or int8, D 64 or 128): mma.sync m16n8k16, a warp 16 rows and a
//   block up to 64, every staged key block shared by them all; S = Q·Kᵀ
//   from q in registers and K fragments read from the swizzled rows (int8
//   widened to q's type, which is exact), the online softmax on the
//   fragment, then O += P·V with P rounded to q's type (the plain version
//   rounds its probabilities so) and V's fragments by ldmatrix.trans
//   (int8: read and widened in registers). fp32 stays off the tensor
//   cores (no TF32).

#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kKeys = 64;  // positions a key block: the unit of a run
constexpr float kNegInf = -1e30f;

struct PagedArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* bt;
  const int* lens;
  void* out;
  // with more than one run: (n_rows, splits, d) fp32 accumulators, then
  // (n_rows, splits, 2) fp32 (m, l); null with one
  float* ws;
  int n_rows;  // N·Hq·S, the rows of the call
  int hkv, rows, s, d, p, t_pages, splits, per;
  float scale;
  int cpr;   // 16-byte chunks a K/V row (the head dim padded to them)
  int swz;   // a row's chunk swizzle mask (0: none)
  int nbuf;  // key blocks in the ring: 2, or 1 where two do not fit
  int vec;   // 16-byte copies: D·elt a multiple of 16, pools aligned
};

// byte offset of 16-byte chunk c of row r in a staged key block
__device__ __forceinline__ int kv_off(const PagedArgs& a, int r, int c) {
  return (r * a.cpr + (c ^ (r & a.swz))) << 4;
}

// The key block of positions [pos0, pos0 + 64) of kv head h through the
// row's block table into the K and V buffers, by all the block's threads:
// 16-byte cp.async where `vec`, else plain loads; a position past `last`
// becomes zeros. The caller commits the copies as one group.
template <typename TKV>
__device__ __forceinline__ void stage(const PagedArgs& a, unsigned char* kb,
                                      unsigned char* vb, const int* row_bt,
                                      int h, int pos0, int last) {
  constexpr int VW = 16 / sizeof(TKV);
  const TKV* kg = static_cast<const TKV*>(a.k);
  const TKV* vg = static_cast<const TKV*>(a.v);
  for (int i = threadIdx.x; i < kKeys * a.cpr; i += blockDim.x) {
    const int r = i / a.cpr, c = i - r * a.cpr, pos = pos0 + r;
    const bool in = pos <= last;
    size_t row = 0;
    if (in) {
      const int t = pos / a.p;
      row = ((static_cast<size_t>(row_bt[t]) * a.hkv + h) * a.p + pos -
             t * a.p) * a.d;
    }
    const int o = kv_off(a, r, c);
    if (a.vec) {
      cp_async16(kb + o, in ? kg + row + c * VW : kg, in ? 16 : 0);
      cp_async16(vb + o, in ? vg + row + c * VW : vg, in ? 16 : 0);
    } else {
      uint4 ku = make_uint4(0u, 0u, 0u, 0u), vu = ku;
      TKV* ke = reinterpret_cast<TKV*>(&ku);
      TKV* ve = reinterpret_cast<TKV*>(&vu);
      for (int e = 0; e < VW; ++e) {
        const int x = c * VW + e;
        if (in && x < a.d) {
          ke[e] = kg[row + x];
          ve[e] = vg[row + x];
        }
      }
      *reinterpret_cast<uint4*>(kb + o) = ku;
      *reinterpret_cast<uint4*>(vb + o) = vu;
    }
  }
}

// the values of type TKV packed in a 32-bit word, as fp32 (exact)
template <typename TKV>
__device__ __forceinline__ void widen_word(uint32_t w, float* f) {
  if constexpr (std::is_same<TKV, float>::value) {
    f[0] = __uint_as_float(w);
  } else if constexpr (std::is_same<TKV, __nv_bfloat16>::value) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  } else if constexpr (std::is_same<TKV, __half>::value) {
    const float2 x = __half22float2(*reinterpret_cast<const __half2*>(&w));
    f[0] = x.x;
    f[1] = x.y;
  } else {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[b] = static_cast<float>(static_cast<int8_t>(w >> (8 * b)));
  }
}

// the WORDS 32-bit words at p (16-byte aligned for 4, 8 for 2) as fp32
template <typename TKV, int WORDS>
__device__ __forceinline__ void widen(const unsigned char* p, float* f) {
  constexpr int PER = 4 / sizeof(TKV);  // values a word
  uint32_t w[WORDS];
  if constexpr (WORDS == 4) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  } else if constexpr (WORDS == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x; w[1] = u.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < WORDS; ++i) widen_word<TKV>(w[i], f + i * PER);
}

// the shared bytes the CUDA-core path's ring takes: nbuf key blocks of K
// and V, or after the loop the key slices' P·V sums, whichever is larger
__host__ __device__ inline size_t core_ring_bytes(int cpr, int dp, int nbuf,
                                                  int rt) {
  const size_t ring = size_t(nbuf) * 2 * kKeys * cpr * 16;
  const size_t red = size_t(kThreads / (dp / 4)) * rt * dp * 4;
  return ring > red ? ring : red;
}

// the key blocks [kb0, kb1) of this block's run, clipped to its horizon
// hmax (kb1 <= kb0: nothing to read)
__device__ __forceinline__ void run_blocks(const PagedArgs& a, int split,
                                           int hmax, int& kb0, int& kb1) {
  const int nkb = (a.t_pages * a.p + kKeys - 1) / kKeys;
  kb0 = split * a.per;
  kb1 = hmax < 0 ? kb0 : min(min(nkb, kb0 + a.per), hmax / kKeys + 1);
}

// row `row` of the call's workspace slots for run `split`: its D fp32
// accumulators, and its (m, l)
__device__ __forceinline__ float* ws_acc(const PagedArgs& a, size_t row,
                                         int split) {
  return a.ws + (row * a.splits + split) * a.d;
}

__device__ __forceinline__ float* ws_ml(const PagedArgs& a, size_t row,
                                        int split) {
  return a.ws + size_t(a.n_rows) * a.splits * a.d +
         (row * a.splits + split) * 2;
}

// The CUDA-core path: RT rows (a tile of the G·S rows of (n, h)) against
// one run of key blocks.
template <typename TQ, typename TKV, int RT>
__global__ void __launch_bounds__(kThreads)
    paged_core_kernel(const PagedArgs a) {
  constexpr int VW = 16 / sizeof(TKV);
  extern __shared__ __align__(16) unsigned char smem[];
  const int dp = a.cpr * VW;  // the padded head dim
  const size_t kvb = size_t(kKeys) * a.cpr * 16;
  unsigned char* ring = smem;
  float* qs =
      reinterpret_cast<float*>(smem + core_ring_bytes(a.cpr, dp, a.nbuf, RT));
  float* sc = qs + RT * dp;      // scores, then probabilities: RT x 64
  float* m_s = sc + RT * kKeys;  // running max, sum, last correction
  float* l_s = m_s + RT;
  float* c_s = l_s + RT;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = blockIdx.x, h = blockIdx.y;
  const int split = blockIdx.z % a.splits;
  const int r0 = (blockIdx.z / a.splits) * RT;
  const int rows = min(RT, a.rows - r0);
  const int len = a.lens[n];
  const int hmax = len + a.s - 1;  // the block's horizon: its rows' last
  const int last = min(hmax, a.t_pages * a.p - 1);
  int kb0, kb1;
  run_blocks(a, split, hmax, kb0, kb1);
  if (a.splits > 1 && kb1 <= kb0) return;  // the merge skips this run

  // q and out viewed as (N, Hkv, G·S, D)
  const size_t row0 = (size_t(n) * a.hkv + h) * a.rows + r0;
  const TQ* qg = static_cast<const TQ*>(a.q) + row0 * a.d;
  for (int i = tid; i < RT * dp; i += kThreads) {
    const int r = i / dp, x = i - r * dp;
    qs[i] = (r < rows && x < a.d) ? to_f32(qg[size_t(r) * a.d + x]) : 0.f;
  }
  for (int r = tid; r < RT; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
    c_s[r] = 1.f;
  }
  const int* row_bt = a.bt + size_t(n) * a.t_pages;
  if (kb0 < kb1)
    stage<TKV>(a, ring, ring + kvb, row_bt, h, kb0 * kKeys, last);
  cp_async_commit();

  // QK: two threads a key, chunks [c_lo, c_hi) each
  const int key = tid >> 1, half = tid & 1;
  const int hc = (a.cpr + 1) >> 1;
  const int c_lo = half * hc, c_hi = min(a.cpr, c_lo + hc);
  // P·V: columns 4·cg .. 4·cg + 3 over keys ks, ks + nks, ...
  const int ncg = dp >> 2, nks = kThreads / ncg;
  const int cg = tid % ncg, ks = tid / ncg;
  const int cb = cg * 4 * int(sizeof(TKV));  // byte of the group in a row
  float acc[RT][4];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;

  for (int kb = kb0, it = 0; kb < kb1; ++kb, ++it) {
    cp_async_wait_all();
    __syncthreads();  // key block kb has landed; the last one is done with
    unsigned char* kbuf = ring + (a.nbuf == 2 ? (it & 1) : 0) * 2 * kvb;
    unsigned char* vbuf = kbuf + kvb;
    if (a.nbuf == 2 && kb + 1 < kb1)
      stage<TKV>(a, ring + ((it + 1) & 1) * 2 * kvb,
                 ring + ((it + 1) & 1) * 2 * kvb + kvb, row_bt, h,
                 (kb + 1) * kKeys, last);
    cp_async_commit();
    const int pos0 = kb * kKeys;

    float dot[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) dot[r] = 0.f;
    for (int c = c_lo; c < c_hi; ++c) {
      float kf[VW];
      widen<TKV, 4>(kbuf + kv_off(a, key, c), kf);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float4* qr = reinterpret_cast<const float4*>(qs + r * dp +
                                                           c * VW);
#pragma unroll
        for (int e = 0; e < VW / 4; ++e) {
          const float4 qv = qr[e];
          dot[r] = fmaf(qv.x, kf[4 * e], dot[r]);
          dot[r] = fmaf(qv.y, kf[4 * e + 1], dot[r]);
          dot[r] = fmaf(qv.z, kf[4 * e + 2], dot[r]);
          dot[r] = fmaf(qv.w, kf[4 * e + 3], dot[r]);
        }
      }
    }
    const int pos = pos0 + key;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], 1);
      if (r < rows && (r & 1) == half)
        sc[r * kKeys + key] =
            pos <= min(last, len + (r0 + r) % a.s) ? dot[r] * a.scale
                                                   : -INFINITY;
    }
    __syncthreads();

    // the online softmax: a warp a row, two keys a lane
    for (int r = warp; r < rows; r += kThreads / 32) {
      float* sr = sc + r * kKeys;
      const float s0 = sr[lane], s1 = sr[lane + 32];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float e0 = expf(s0 - m_new), e1 = expf(s1 - m_new);
      sr[lane] = e0;
      sr[lane + 32] = e1;
      const float sum = warp_sum(e0 + e1);
      if (lane == 0) {
        const float cf = expf(m_old - m_new);
        c_s[r] = cf;
        l_s[r] = l_s[r] * cf + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    if (ks < nks) {
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float cf = c_s[r];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][e] *= cf;
      }
      const int kend = min(kKeys, last - pos0 + 1);
      for (int kk = ks; kk < kend; kk += nks) {
        float vf[4];
        widen<TKV, int(sizeof(TKV))>(vbuf + kv_off(a, kk, cb >> 4) + (cb & 15),
                                vf);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float pr = sc[r * kKeys + kk];
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][e] = fmaf(pr, vf[e], acc[r][e]);
        }
      }
    }
    if (a.nbuf == 1 && kb + 1 < kb1) {
      __syncthreads();  // every thread is done with the one buffer
      stage<TKV>(a, ring, ring + kvb, row_bt, h, (kb + 1) * kKeys, last);
      cp_async_commit();
    }
  }
  cp_async_wait_all();
  __syncthreads();  // every P·V is done with the ring
  let_next_start();

  // the key slices' sums, added in slice order
  float* red = reinterpret_cast<float*>(ring);
  if (ks < nks) {
#pragma unroll
    for (int r = 0; r < RT; ++r)
      *reinterpret_cast<float4*>(red + (ks * RT + r) * dp + 4 * cg) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();
  for (int i = tid; i < rows * ncg; i += kThreads) {
    const int r = i / ncg, g = i - r * ncg;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    for (int x = 0; x < nks; ++x) {
      const float4 v =
          *reinterpret_cast<const float4*>(red + (x * RT + r) * dp + 4 * g);
      o[0] += v.x;
      o[1] += v.y;
      o[2] += v.z;
      o[3] += v.w;
    }
    const size_t row = row0 + r;
    if (a.splits == 1) {
      const float l = l_s[r];
      TQ* out = static_cast<TQ*>(a.out) + row * a.d;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * g + e < a.d)
          out[4 * g + e] = from_f32<TQ>(o[e] / (l > 0.f ? l : 1.f));
    } else {
      float* w = ws_acc(a, row, split);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * g + e < a.d) w[4 * g + e] = o[e];
      if (g == 0) {
        float* ml = ws_ml(a, row, split);
        ml[0] = m_s[r];
        ml[1] = l_s[r];
      }
    }
  }
}

// two fp32 values as a packed pair of T (the low half the first)
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 x = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&x);
  } else {
    __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&x);
  }
}

// d += a·b, m16n8k16, T operands, fp32 accumulators
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// int8 values i0, i1 as a packed pair of T (exact: |x| <= 128)
template <typename T>
__device__ __forceinline__ uint32_t widen_i8(int8_t i0, int8_t i1) {
  return pack2<T>(static_cast<float>(i0), static_cast<float>(i1));
}

// The tensor-core path: 16 rows a warp, up to four warps, against one run
// of key blocks. T is q's type; TKV is T or int8 (widened to T).
template <typename T, typename TKV, int DP>
__global__ void __launch_bounds__(kThreads)
    paged_mma_kernel(const PagedArgs a) {
  constexpr int NK = DP / 16, ND = DP / 8;
  constexpr bool I8 = std::is_same<TKV, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n = blockIdx.x, h = blockIdx.y;
  const int split = blockIdx.z % a.splits;
  const int r0 = (blockIdx.z / a.splits) * (blockDim.x / 2) + 16 * warp;
  const int len = a.lens[n];
  const int hmax = len + a.s - 1;
  const int last = min(hmax, a.t_pages * a.p - 1);
  int kb0, kb1;
  run_blocks(a, split, hmax, kb0, kb1);
  if (a.splits > 1 && kb1 <= kb0) return;
  const size_t kvb = size_t(kKeys) * a.cpr * 16;
  const int* row_bt = a.bt + size_t(n) * a.t_pages;
  if (kb0 < kb1)
    stage<TKV>(a, smem, smem + kvb, row_bt, h, kb0 * kKeys, last);
  cp_async_commit();

  // this thread's rows r0 + g and r0 + g + 8: the last visible position
  // of each (-1: a row past G·S sees nothing), and its q fragments
  const size_t qrow0 = (size_t(n) * a.hkv + h) * a.rows;
  const T* qg = static_cast<const T*>(a.q) + qrow0 * DP;
  int lim[2];
  uint32_t qa[NK][4];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + g + 8 * hh;
    lim[hh] = r < a.rows ? min(last, len + r % a.s) : -1;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi)
        qa[kk][hh + 2 * hi] =
            r < a.rows ? *reinterpret_cast<const uint32_t*>(
                             qg + size_t(r) * DP + 16 * kk + 2 * t + 8 * hi)
                       : 0u;
  }
  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[j][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int kb = kb0, it = 0; kb < kb1; ++kb, ++it) {
    cp_async_wait_all();
    __syncthreads();  // key block kb has landed; the last one is done with
    const unsigned char* kbuf = smem + (it & 1) * 2 * kvb;
    const unsigned char* vbuf = kbuf + kvb;
    if (kb + 1 < kb1)
      stage<TKV>(a, smem + ((it + 1) & 1) * 2 * kvb,
                 smem + ((it + 1) & 1) * 2 * kvb + kvb, row_bt, h,
                 (kb + 1) * kKeys, last);
    cp_async_commit();
    const int pos0 = kb * kKeys;

    // S = Q·Kᵀ: key column 8·nt + g of each n8 tile, depth 16·kk + 2t
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
      const int kr = 8 * nt + g;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        uint32_t b[2];
        if constexpr (I8) {
          const unsigned char* row = kbuf + kv_off(a, kr, kk);
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const char2 x = *reinterpret_cast<const char2*>(
                row + 2 * t + 8 * hi);
            b[hi] = widen_i8<T>(x.x, x.y);
          }
        } else {
#pragma unroll
          for (int hi = 0; hi < 2; ++hi)
            b[hi] = *reinterpret_cast<const uint32_t*>(
                kbuf + kv_off(a, kr, 2 * kk + hi) + 4 * t);
        }
        mma16816<T>(s[nt], qa[kk], b);
      }
    }
    // scale and mask (selects: a masked logit is -inf, whose exp is 0),
    // then the online softmax on the rows g and g + 8 of the fragment
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pos = pos0 + 8 * nt + 2 * t + (i & 1);
        s[nt][i] = pos <= lim[i >> 1] ? s[nt][i] * a.scale : -INFINITY;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[nt][i]);
      }
    float corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh]);
      corr[hh] = expf(m[hh] - m_new);
      m[hh] = m_new;
      l[hh] *= corr[hh];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nt][i] = expf(s[nt][i] - m[i >> 1]);
        l[i >> 1] += s[nt][i];
      }
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[j][i] *= corr[i >> 1];

    // O += P·V over the key slices of 16 (kk), P rounded to T as the A
    // fragment: registers (row g, keys 2t..), (g + 8, 2t..), (g, 2t + 8..),
    // (g + 8, 2t + 8..) of the slice
    const int kend = last - pos0;  // the last key any row here sees
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (16 * kk > kend) break;
      const uint32_t pa[4] = {pack2<T>(s[2 * kk][0], s[2 * kk][1]),
                              pack2<T>(s[2 * kk][2], s[2 * kk][3]),
                              pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      if constexpr (I8) {
        // b: V rows 16kk + 2t, + 1 (and + 8, + 9) of column 8j + g
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          const int col = 8 * j + g;
          uint32_t b[2];
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int kr = 16 * kk + 2 * t + 8 * hi;
            const int8_t v0 = static_cast<int8_t>(
                vbuf[kv_off(a, kr, col >> 4) + (col & 15)]);
            const int8_t v1 = static_cast<int8_t>(
                vbuf[kv_off(a, kr + 1, col >> 4) + (col & 15)]);
            b[hi] = widen_i8<T>(v0, v1);
          }
          mma16816<T>(o[j], pa, b);
        }
      } else {
        // ldmatrix.x4.trans: lanes 0-15 name V rows 16kk + 0..15 of
        // column chunk j, lanes 16-31 of chunk j + 1
#pragma unroll
        for (int j = 0; j < ND; j += 2) {
          const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(
              vbuf + kv_off(a, 16 * kk + (lane & 15), j + (lane >> 4))));
          uint32_t b[4];
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
              "{%0, %1, %2, %3}, [%4];\n"
              : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
              : "r"(addr));
          const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
          mma16816<T>(o[j], pa, b0);
          mma16816<T>(o[j + 1], pa, b1);
        }
      }
    }
  }
  cp_async_wait_all();
  let_next_start();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const int r = r0 + g + 8 * hh;
    if (r >= a.rows) continue;
    const size_t row = qrow0 + r;
    if (a.splits == 1) {
      const float ls = l[hh] > 0.f ? l[hh] : 1.f;
      T* out = static_cast<T*>(a.out) + row * DP;
#pragma unroll
      for (int j = 0; j < ND; ++j)
        store_pair(out, 8 * j + 2 * t, DP, o[j][2 * hh] / ls,
                   o[j][2 * hh + 1] / ls, true);
    } else {
      float* w = ws_acc(a, row, split);
#pragma unroll
      for (int j = 0; j < ND; ++j)
        store_pair(w, 8 * j + 2 * t, DP, o[j][2 * hh], o[j][2 * hh + 1],
                   true);
      if (t == 0) {
        float* ml = ws_ml(a, row, split);
        ml[0] = m[hh];
        ml[1] = l[hh];
      }
    }
  }
}

// The merge: a warp a row of the call folds the row's live runs in index
// order, out = Σ e^(m_i - M)·acc_i / Σ e^(m_i - M)·l_i (0 where nothing is
// visible). A run is live when its first position lies at or before the
// horizon, the test the first kernel's blocks exit on.
template <typename TQ>
__global__ void __launch_bounds__(kThreads)
    paged_merge_kernel(const PagedArgs a) {
  wait_prior();  // the runs' partials
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= a.n_rows) return;
  const int hmax = a.lens[row / (a.hkv * a.rows)] + a.s - 1;
  const int live =
      hmax < 0 ? 0 : min(a.splits, hmax / (a.per * kKeys) + 1);
  float mx = kNegInf;
  for (int i = 0; i < live; ++i) mx = fmaxf(mx, ws_ml(a, row, i)[0]);
  float l = 0.f;
  for (int i = 0; i < live; ++i) {
    const float* ml = ws_ml(a, row, i);
    l += expf(ml[0] - mx) * ml[1];
  }
  TQ* out = static_cast<TQ*>(a.out) + size_t(row) * a.d;
  for (int x = lane; x < a.d; x += 32) {
    float o = 0.f;
    for (int i = 0; i < live; ++i)
      o += expf(ws_ml(a, row, i)[0] - mx) * ws_acc(a, row, i)[x];
    out[x] = from_f32<TQ>(o / (l > 0.f ? l : 1.f));
  }
}

template <typename TQ, typename TKV>
constexpr bool on_tensor_cores() {
  return !std::is_same<TQ, float>::value &&
         (std::is_same<TKV, TQ>::value || std::is_same<TKV, int8_t>::value);
}

cudaError_t set_smem(const void* kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename TQ, typename TKV, int RT>
cudaError_t launch_core(PagedArgs a, int n, cudaStream_t st) {
  const int dp = a.cpr * int(16 / sizeof(TKV));
  const size_t rest = sizeof(float) * (size_t(RT) * dp + RT * kKeys + 3 * RT);
  // two key blocks in the ring where they fit, else one
  a.nbuf = core_ring_bytes(a.cpr, dp, 2, RT) + rest <= 232448 ? 2 : 1;
  const size_t smem = core_ring_bytes(a.cpr, dp, a.nbuf, RT) + rest;
  auto kern = paged_core_kernel<TQ, TKV, RT>;
  const cudaError_t e = set_smem(reinterpret_cast<const void*>(kern), smem);
  if (e != cudaSuccess) return e;
  const int tiles = (a.rows + RT - 1) / RT;
  note_launch(kern, smem, kThreads);
  kern<<<dim3(n, a.hkv, a.splits * tiles), kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_mma(PagedArgs a, int n, cudaStream_t st) {
  a.nbuf = 2;
  const int warps = min(4, (a.rows + 15) / 16);
  const int tiles = (a.rows + 16 * warps - 1) / (16 * warps);
  const size_t smem = size_t(4) * kKeys * a.cpr * 16;
  auto kern = a.d == 64 ? paged_mma_kernel<TQ, TKV, 64>
                        : paged_mma_kernel<TQ, TKV, 128>;
  const cudaError_t e = set_smem(reinterpret_cast<const void*>(kern), smem);
  if (e != cudaSuccess) return e;
  note_launch(kern, smem, 32 * warps);
  kern<<<dim3(n, a.hkv, a.splits * tiles), 32 * warps, smem, st>>>(a);
  return cudaGetLastError();
}

// the attend kernel for (TQ, TKV), then the merge where there are runs
template <typename TQ, typename TKV>
int launch(PagedArgs a, int n, cudaStream_t st) {
  constexpr int VW = 16 / sizeof(TKV);
  a.cpr = (a.d + VW - 1) / VW;
  if (a.cpr * VW / 4 > kThreads)  // D past 512
    return static_cast<int>(cudaErrorInvalidValue);
  a.swz = (a.cpr & (a.cpr - 1)) == 0 ? min(a.cpr, 8) - 1 : 0;
  a.vec = a.d % VW == 0 && reinterpret_cast<uintptr_t>(a.k) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(a.v) % 16 == 0;
  cudaError_t e;
  if constexpr (on_tensor_cores<TQ, TKV>()) {
    if (a.vec && a.rows > 4 && (a.d == 64 || a.d == 128))
      e = launch_mma<TQ, TKV>(a, n, st);
    else
      e = a.rows <= 1   ? launch_core<TQ, TKV, 1>(a, n, st)
          : a.rows <= 4 ? launch_core<TQ, TKV, 4>(a, n, st)
                        : launch_core<TQ, TKV, 16>(a, n, st);
  } else {
    e = a.rows <= 1   ? launch_core<TQ, TKV, 1>(a, n, st)
        : a.rows <= 4 ? launch_core<TQ, TKV, 4>(a, n, st)
                      : launch_core<TQ, TKV, 16>(a, n, st);
  }
  if (e != cudaSuccess || a.splits == 1) return static_cast<int>(e);
  const int blocks = (a.n_rows + kThreads / 32 - 1) / (kThreads / 32);
  e = launch_after(paged_merge_kernel<TQ>, dim3(blocks), dim3(kThreads), st,
                   a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ>
int launch_kv(int kv_dtype, const PagedArgs& a, int n, cudaStream_t st) {
  switch (kv_dtype) {
    case kF32:
      return launch<TQ, float>(a, n, st);
    case kBF16:
      return launch<TQ, __nv_bfloat16>(a, n, st);
    case kF16:
      return launch<TQ, __half>(a, n, st);
    case kI8:
      return launch<TQ, int8_t>(a, n, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, out (N, Hq, S, D) in q_dtype; k, v (pages, Hkv, P, D) in kv_dtype;
// bt (N, T) and lens (N,) int32. splits runs of per key blocks of 64
// positions (paged_geometry), covering ceil(T·P / 64) key blocks; ws fp32,
// N·Hq·S·splits·(D + 2) floats, used (and required) where splits > 1.
extern "C" int apex1_paged_attend(const void* q, const void* k,
                                  const void* v, const void* bt,
                                  const void* lens, void* out, void* ws,
                                  int n, int hq, int hkv, int s, int d,
                                  int p, int t_pages, int splits, int per,
                                  float scale, int q_dtype, int kv_dtype,
                                  void* stream) {
  if (n <= 0 || hq <= 0 || s <= 0) return 0;
  const int nkb = p > 0 && t_pages > 0 ? (t_pages * p + kKeys - 1) / kKeys
                                       : 0;
  if (hkv <= 0 || hq % hkv != 0 || d <= 0 || nkb <= 0 || splits < 1 ||
      per < 1 || (splits - 1) * per >= nkb || splits * per < nkb ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  PagedArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.bt = static_cast<const int*>(bt);
  a.lens = static_cast<const int*>(lens);
  a.out = out;
  a.ws = static_cast<float*>(ws);
  a.n_rows = n * hq * s;
  a.hkv = hkv;
  a.rows = (hq / hkv) * s;
  a.s = s;
  a.d = d;
  a.p = p;
  a.t_pages = t_pages;
  a.splits = splits;
  a.per = per;
  a.scale = scale;
  cudaStream_t st = as_stream(stream);
  switch (q_dtype) {
    case kF32:
      return launch_kv<float>(kv_dtype, a, n, st);
    case kBF16:
      return launch_kv<__nv_bfloat16>(kv_dtype, a, n, st);
    case kF16:
      return launch_kv<__half>(kv_dtype, a, n, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
