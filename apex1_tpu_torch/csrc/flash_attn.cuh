// Flash attention kernels for Hopper (sm_90a), shared by flash_attn.cu
// (the kernels without dropout) and flash_attn_dropout.cu (with it): two
// translation units, so nvcc compiles the two sets in parallel. See
// flash_attn.cu for what they compute and how: the forward, dq, dk/dv and
// the additive bias's gradient (dbias).
#pragma once

#include "common.cuh"
#include "dropout_hash.cuh"

#include <type_traits>

static const int kThreads = 128;
static const float kNegInf = -1e30f;  // finite, as the JAX package's NEG_INF

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

// Shared-memory geometry of the fp32 kernels (T = float; bf16/fp16 are
// flash_wg.cuh's) for padded head dim DP.
template <typename T, int DP>
struct Geom {
  static constexpr int BT = 32;                        // tile rows
  static constexpr int TPR = kThreads / BT;            // threads per row
  static constexpr int CPT = BT / TPR;                 // score cols a thread
  static constexpr int LDT = DP + 16 / sizeof(T);      // operand tile stride
  static constexpr int LDS = BT + 4;                   // fp32 score stride
  static constexpr int LDP = BT + 16 / sizeof(T);      // T score stride
  static constexpr int LDA = DP + 4;                   // fp32 acc stride
  static constexpr size_t OP = align128(size_t(BT) * LDT * sizeof(T));
  static constexpr size_t SF = align128(size_t(BT) * LDS * 4);
  static constexpr size_t ACC = align128(size_t(BT) * LDA * 4);
  static constexpr size_t ROW = align128(size_t(BT) * 4);
  // forward: Q K V | S (P aliased) | acc | kseg
  static constexpr size_t FWD = 3 * OP + SF + ACC + ROW;
  // dq: Q dO K V | S (dS aliased) | dP | dq | kseg
  static constexpr size_t DQ = 4 * OP + 2 * SF + ACC + ROW;
  // dk/dv: K V Q dO | S (P aliased) | dP (dS aliased) | dk dv | kseg
  static constexpr size_t DKV = 4 * OP + 2 * SF + 2 * ACC + ROW;
  // dbias: Q dO K V | S (the dbias tile at the end) | dP | kseg
  static constexpr size_t DB = 4 * OP + 2 * SF + ROW;
  static_assert(size_t(BT) * LDP * sizeof(T) <= SF, "P must fit in S");
};

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  const float* dlse;  // null: zero
  const int* qseg;    // null: no segments
  const int* kseg;
  const float* bias;  // null: no bias; else fp32 (Bb, Hb, Sq, Sk)
  long long bias_sb;  // the bias's batch stride, 0 when Bb == 1
  long long bias_sh;  // its head stride, 0 when Hb == 1
  int Bb, Hb;
  float* dbias;       // fp32 (Bb, Hb, Sq, Sk)
  void* out;
  float* lse;
  void* dq;
  void* dk;
  void* dv;
  int dkv_f32;  // dk and dv are fp32, not the operand type
  // the forward's merge mode (null: off): the carried fp32 (B, Hq, Sq, D)
  // output and (B, Hq, Sq) lse this shard's result merges into; `out` is
  // then fp32 too
  const float* prev_out;
  const float* prev_lse;
  int B, Hq, Hkv, Sq, Sk, D;
  float scale;
  int causal, q_off, k_off;
  int vec;  // D equals the padded width and rows are 16-byte aligned
  uint32_t seed, thr;  // dropout: the seed word and the keep threshold
  float inv;           // dropout: 1 / (1 - p)
};

// the dropout row key of query row `qrow` of (batch b, query head h)
__device__ __forceinline__ uint32_t drop_row_key(const FlashArgs& a, int b,
                                                 int h, int qrow) {
  return row_key(stream_key(a.seed, static_cast<uint32_t>(b * a.Hq + h)),
                 static_cast<uint32_t>(qrow + a.q_off));
}

__device__ __forceinline__ bool drop_keep(const FlashArgs& a, uint32_t rk,
                                          int kcol) {
  return keep_bit(rk, static_cast<uint32_t>(kcol + a.k_off), a.thr);
}

// Copy `rows` rows of D values (row stride D) into a BT x DP tile with
// row stride `ld`; rows past `rows` and columns past D become zero.
template <typename T, int DP, int BT>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          int rows, int D, int vec) {
  if (vec) {
    constexpr int CPR = DP * int(sizeof(T)) / 16;  // 16-byte chunks a row
    for (int i = threadIdx.x; i < BT * CPR; i += kThreads) {
      const int r = i / CPR, c = i % CPR;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows)
        val = reinterpret_cast<const uint4*>(src + size_t(r) * DP)[c];
      reinterpret_cast<uint4*>(dst + r * ld)[c] = val;
    }
  } else {
    for (int i = threadIdx.x; i < BT * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      dst[r * ld + c] =
          (r < rows && c < D) ? src[size_t(r) * D + c] : from_f32<T>(0.f);
    }
  }
}

// C[M x N] (+)= A[M x K] · B[K x N], fp32, all in shared memory, by the
// whole block, on the CUDA cores (no TF32). A(m, k) = A_COL ? A[k * lda + m]
// : A[m * lda + k]; B(k, n) = B_COL ? B[n * ldb + k] : B[k * ldb + n].
template <typename T, int M, int N, int K, bool A_COL, bool B_COL>
__device__ __forceinline__ void tile_mm(const T* A, int lda, const T* B,
                                        int ldb, float* C, int ldc,
                                        bool accumulate) {
  static_assert(std::is_same<T, float>::value,
                "bf16/fp16 products are flash_wg.cuh's wgmma");
  // 16 x 8 threads; thread (tx, ty) owns rows ty + 8i, cols tx + 16j
  static_assert(M % 8 == 0 && N % 16 == 0, "fp32 tile shape");
  constexpr int RI = M / 8, CJ = N / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float c[RI][CJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j)
      c[i][j] = accumulate ? C[(ty + 8 * i) * ldc + tx + 16 * j] : 0.f;
#pragma unroll 4
  for (int kk = 0; kk < K; ++kk) {
    float av[RI], bv[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int m = ty + 8 * i;
      av[i] = A_COL ? A[kk * lda + m] : A[m * lda + kk];
    }
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int n = tx + 16 * j;
      bv[j] = B_COL ? B[n * ldb + kk] : B[kk * ldb + n];
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) c[i][j] = fmaf(av[i], bv[j], c[i][j]);
  }
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j)
      C[(ty + 8 * i) * ldc + tx + 16 * j] = c[i][j];
}

template <int TPR>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int TPR>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ bool valid_at(const FlashArgs& a, int qrow,
                                         int kcol, int qs, int ks) {
  return qrow < a.Sq && kcol < a.Sk &&
         (!a.causal || kcol + a.k_off <= qrow + a.q_off) &&
         (a.qseg == nullptr || qs == ks);
}

// With a bias: s = s·scale + bias(b, h, row, col) over the block's fp32
// score tile at (q0, k0), by the whole block, each bias row read
// coalesced; positions past Sq or Sk keep their score (they are masked).
// Multiply and add are rounded apart, as the plain version rounds them.
template <int BT, int LDS>
__device__ __forceinline__ void add_bias(const FlashArgs& a, float* sS,
                                         int b, int h, int q0, int k0) {
  const float* src = a.bias + b * a.bias_sb + h * a.bias_sh;
  for (int i = threadIdx.x; i < BT * BT; i += kThreads) {
    const int r = i / BT, c = i % BT;
    if (q0 + r < a.Sq && k0 + c < a.Sk)
      sS[r * LDS + c] =
          __fadd_rn(__fmul_rn(sS[r * LDS + c], a.scale),
                    src[static_cast<long long>(q0 + r) * a.Sk + k0 + c]);
  }
}

// the full logit of a score tile entry: add_bias has scaled it already
__device__ __forceinline__ float logit(const FlashArgs& a, float s) {
  return a.bias != nullptr ? s : s * a.scale;
}

// number of key tiles a causal q tile starting at q0 reaches
template <int BT>
__device__ __forceinline__ int key_tiles(const FlashArgs& a, int q0) {
  int nk = (a.Sk + BT - 1) / BT;
  if (a.causal) {
    const long long last =
        static_cast<long long>(q0) + BT - 1 + a.q_off - a.k_off;
    nk = last < 0 ? 0 : static_cast<int>(min(static_cast<long long>(nk),
                                             last / BT + 1));
  }
  return nk;
}

template <int BT>
__device__ __forceinline__ void load_kseg(int* sKseg, const FlashArgs& a,
                                          int b, int k0) {
  if (a.kseg == nullptr) return;
  for (int i = threadIdx.x; i < BT; i += kThreads)
    sKseg[i] = k0 + i < a.Sk ? a.kseg[size_t(b) * a.Sk + k0 + i] : 0;
}

template <typename T, int DP, bool DROP>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const FlashArgs a) {
  using G = Geom<T, DP>;
  constexpr int BT = G::BT, TPR = G::TPR, CPT = G::CPT;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = reinterpret_cast<T*>(smem + G::OP);
  T* sV = reinterpret_cast<T*>(smem + 2 * G::OP);
  float* sS = reinterpret_cast<float*>(smem + 3 * G::OP);
  T* sP = reinterpret_cast<T*>(sS);
  float* sAcc = reinterpret_cast<float*>(smem + 3 * G::OP + G::SF);
  int* sKseg = reinterpret_cast<int*>(smem + 3 * G::OP + G::SF + G::ACC);

  const int tid = threadIdx.x, row = tid / TPR, part = tid % TPR;
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int qrow = q0 + row;
  const size_t bh = size_t(b) * a.Hq + h;
  const T* qt = static_cast<const T*>(a.q) + (bh * a.Sq + q0) * a.D;
  const size_t kv0 = (size_t(b) * a.Hkv + hk) * a.Sk * a.D;
  const T* kb = static_cast<const T*>(a.k) + kv0;
  const T* vb = static_cast<const T*>(a.v) + kv0;

  load_tile<T, DP, BT>(sQ, G::LDT, qt, min(BT, a.Sq - q0), a.D, a.vec);
  for (int i = tid; i < BT * G::LDA; i += kThreads) sAcc[i] = 0.f;
  const int qs = (a.qseg != nullptr && qrow < a.Sq)
                     ? a.qseg[size_t(b) * a.Sq + qrow]
                     : 0;
  const uint32_t rk = DROP ? drop_row_key(a, b, h, qrow) : 0u;
  float m = kNegInf, l = 0.f;
  const int nk = key_tiles<BT>(a, q0);
  for (int ki = 0; ki < nk; ++ki) {
    const int k0 = ki * BT;
    __syncthreads();  // the last tile's P·V is done with sK, sV and sP
    load_tile<T, DP, BT>(sK, G::LDT, kb + size_t(k0) * a.D,
                         min(BT, a.Sk - k0), a.D, a.vec);
    load_tile<T, DP, BT>(sV, G::LDT, vb + size_t(k0) * a.D,
                         min(BT, a.Sk - k0), a.D, a.vec);
    load_kseg<BT>(sKseg, a, b, k0);
    __syncthreads();
    tile_mm<T, BT, BT, DP, false, true>(sQ, G::LDT, sK, G::LDT, sS, G::LDS,
                                        false);
    __syncthreads();
    if (a.bias != nullptr) {
      add_bias<BT, G::LDS>(a, sS, b, h, q0, k0);
      __syncthreads();
    }
    float e[CPT];
    bool ok[CPT];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = part + TPR * j;
      ok[j] = valid_at(a, qrow, k0 + c, qs,
                       a.qseg == nullptr ? 0 : sKseg[c]);
      e[j] = ok[j] ? logit(a, sS[row * G::LDS + c]) : kNegInf;
      mx = fmaxf(mx, e[j]);
    }
    const float m_new = fmaxf(m, group_max<TPR>(mx));
    const float corr = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      e[j] = ok[j] ? expf(e[j] - m_new) : 0.f;
      sum += e[j];
    }
    l = l * corr + group_sum<TPR>(sum);
    m = m_new;
    __syncthreads();  // every score is read before P overwrites it
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      float ev = e[j];
      if constexpr (DROP)
        ev = drop_keep(a, rk, k0 + part + TPR * j) ? __fmul_rn(ev, a.inv)
                                                   : 0.f;
      sP[row * G::LDP + part + TPR * j] = from_f32<T>(ev);
    }
    for (int c = part; c < DP; c += TPR) sAcc[row * G::LDA + c] *= corr;
    __syncthreads();
    tile_mm<T, BT, DP, BT, false, false>(sP, G::LDP, sV, G::LDT, sAcc,
                                         G::LDA, true);
  }
  __syncthreads();
  if (qrow < a.Sq) {
    const float safe = l > 0.f ? l : 1.f;
    const float lse_t = l > 0.f ? m + logf(safe) : kNegInf;
    const size_t r = bh * a.Sq + qrow;
    if (a.prev_lse != nullptr) {
      // merge epilogue (the reference's _agf_kernel, op for op): this
      // shard's output rounded to T as the plain forward returns it, then
      // lse' = logaddexp(prev, lse_t) = max + log1p(exp(-|prev - lse_t|)),
      // out' = prev_out·exp(prev - lse') + o_t·exp(lse_t - lse'), each
      // product and the sum rounded apart
      const float prev = a.prev_lse[r];
      const float lse =
          fmaxf(prev, lse_t) + log1pf(expf(-fabsf(prev - lse_t)));
      const float wa = expf(prev - lse), wb = expf(lse_t - lse);
      const float* po = a.prev_out + r * a.D;
      float* o = static_cast<float*>(a.out) + r * a.D;
      for (int c = part; c < a.D; c += TPR) {
        const float ot = to_f32(from_f32<T>(sAcc[row * G::LDA + c] / safe));
        o[c] = __fadd_rn(__fmul_rn(po[c], wa), __fmul_rn(ot, wb));
      }
      if (part == 0) a.lse[r] = lse;
    } else {
      T* o = static_cast<T*>(a.out) + r * a.D;
      for (int c = part; c < a.D; c += TPR)
        o[c] = from_f32<T>(sAcc[row * G::LDA + c] / safe);
      if (part == 0) a.lse[r] = lse_t;
    }
  }
}

// the per-row statistics the backward reads for query row `qrow`
struct RowStats {
  float lse, delta, dlse;
  int seg;
};

__device__ __forceinline__ RowStats row_stats(const FlashArgs& a, size_t bh,
                                              int b, int qrow) {
  RowStats r{0.f, 0.f, 0.f, 0};
  if (qrow < a.Sq) {
    const size_t i = bh * a.Sq + qrow;
    r.lse = a.lse_in[i];
    r.delta = a.delta[i];
    r.dlse = a.dlse == nullptr ? 0.f : a.dlse[i];
    r.seg = a.qseg == nullptr ? 0 : a.qseg[size_t(b) * a.Sq + qrow];
  }
  return r;
}

// p = valid ? exp(s·scale (+ bias) - lse) : 0 and
// ds = p·(dp - δ + dlse)·ds_scale for the thread's CPT columns of its row,
// from the fp32 S and dP tiles (ds_scale: the softmax scale for dq and
// dk/dv, 1 for dbias, the gradient of the full logit). With DROP (row key
// rk): dp = keep ? dp·inv : 0, and p comes back as the P·V weight
// keep ? p·inv : 0 (ds takes the undropped p)
template <typename G, bool DROP>
__device__ __forceinline__ void probs_and_ds(const FlashArgs& a,
                                             const float* sS,
                                             const float* sDP,
                                             const int* sKseg, int row,
                                             int part, int qrow, int k0,
                                             const RowStats& st, uint32_t rk,
                                             float ds_scale, float* p,
                                             float* ds) {
#pragma unroll
  for (int j = 0; j < G::CPT; ++j) {
    const int c = part + G::TPR * j;
    const bool ok =
        valid_at(a, qrow, k0 + c, st.seg, a.qseg == nullptr ? 0 : sKseg[c]);
    const float pv = ok ? expf(logit(a, sS[row * G::LDS + c]) - st.lse) : 0.f;
    float dpv = sDP[row * G::LDS + c];
    p[j] = pv;
    if constexpr (DROP) {
      const bool keep = drop_keep(a, rk, k0 + c);
      dpv = keep ? __fmul_rn(dpv, a.inv) : 0.f;
      p[j] = keep ? __fmul_rn(pv, a.inv) : 0.f;
    }
    ds[j] = pv * (dpv - st.delta + st.dlse) * ds_scale;
  }
}

// fp32 only: bf16/fp16 dq is flash_dq_wg_kernel (flash_wg.cuh)
template <typename T, int DP, bool DROP>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const FlashArgs a) {
  using G = Geom<T, DP>;
  constexpr int BT = G::BT, TPR = G::TPR, CPT = G::CPT;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sDO = reinterpret_cast<T*>(smem + G::OP);
  T* sK = reinterpret_cast<T*>(smem + 2 * G::OP);
  T* sV = reinterpret_cast<T*>(smem + 3 * G::OP);
  float* sS = reinterpret_cast<float*>(smem + 4 * G::OP);
  T* sDS = reinterpret_cast<T*>(sS);
  float* sDP = reinterpret_cast<float*>(smem + 4 * G::OP + G::SF);
  float* sDQ = reinterpret_cast<float*>(smem + 4 * G::OP + 2 * G::SF);
  int* sKseg =
      reinterpret_cast<int*>(smem + 4 * G::OP + 2 * G::SF + G::ACC);

  const int tid = threadIdx.x, row = tid / TPR, part = tid % TPR;
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int qrow = q0 + row;
  const size_t bh = size_t(b) * a.Hq + h;
  const size_t qoff = (bh * a.Sq + q0) * a.D;
  const size_t kv0 = (size_t(b) * a.Hkv + hk) * a.Sk * a.D;
  const T* kb = static_cast<const T*>(a.k) + kv0;
  const T* vb = static_cast<const T*>(a.v) + kv0;
  const int q_rows = min(BT, a.Sq - q0);

  load_tile<T, DP, BT>(sQ, G::LDT, static_cast<const T*>(a.q) + qoff, q_rows,
                       a.D, a.vec);
  load_tile<T, DP, BT>(sDO, G::LDT, static_cast<const T*>(a.dout) + qoff,
                       q_rows, a.D, a.vec);
  for (int i = tid; i < BT * G::LDA; i += kThreads) sDQ[i] = 0.f;
  const RowStats st = row_stats(a, bh, b, qrow);
  const uint32_t rk = DROP ? drop_row_key(a, b, h, qrow) : 0u;
  const int nk = key_tiles<BT>(a, q0);
  for (int ki = 0; ki < nk; ++ki) {
    const int k0 = ki * BT;
    __syncthreads();  // the last tile's dS·K is done with sK and sDS
    load_tile<T, DP, BT>(sK, G::LDT, kb + size_t(k0) * a.D,
                         min(BT, a.Sk - k0), a.D, a.vec);
    load_tile<T, DP, BT>(sV, G::LDT, vb + size_t(k0) * a.D,
                         min(BT, a.Sk - k0), a.D, a.vec);
    load_kseg<BT>(sKseg, a, b, k0);
    __syncthreads();
    tile_mm<T, BT, BT, DP, false, true>(sQ, G::LDT, sK, G::LDT, sS, G::LDS,
                                        false);
    tile_mm<T, BT, BT, DP, false, true>(sDO, G::LDT, sV, G::LDT, sDP,
                                        G::LDS, false);
    __syncthreads();
    if (a.bias != nullptr) {
      add_bias<BT, G::LDS>(a, sS, b, h, q0, k0);
      __syncthreads();
    }
    float p[CPT], ds[CPT];
    probs_and_ds<G, DROP>(a, sS, sDP, sKseg, row, part, qrow, k0, st, rk,
                          a.scale, p, ds);
    __syncthreads();  // every score is read before dS overwrites it
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      sDS[row * G::LDP + part + TPR * j] = from_f32<T>(ds[j]);
    __syncthreads();
    tile_mm<T, BT, DP, BT, false, false>(sDS, G::LDP, sK, G::LDT, sDQ,
                                         G::LDA, true);
  }
  __syncthreads();
  if (qrow < a.Sq) {
    T* o = static_cast<T*>(a.dq) + (bh * a.Sq + qrow) * a.D;
    for (int c = part; c < a.D; c += TPR)
      o[c] = from_f32<T>(sDQ[row * G::LDA + c]);
  }
}

template <typename T, int DP, bool DROP>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const FlashArgs a) {
  using G = Geom<T, DP>;
  constexpr int BT = G::BT, TPR = G::TPR, CPT = G::CPT;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = reinterpret_cast<T*>(smem + G::OP);
  T* sQ = reinterpret_cast<T*>(smem + 2 * G::OP);
  T* sDO = reinterpret_cast<T*>(smem + 3 * G::OP);
  float* sS = reinterpret_cast<float*>(smem + 4 * G::OP);
  T* sP = reinterpret_cast<T*>(sS);
  float* sDP = reinterpret_cast<float*>(smem + 4 * G::OP + G::SF);
  T* sDS = reinterpret_cast<T*>(sDP);
  float* sDK = reinterpret_cast<float*>(smem + 4 * G::OP + 2 * G::SF);
  float* sDV =
      reinterpret_cast<float*>(smem + 4 * G::OP + 2 * G::SF + G::ACC);
  int* sKseg =
      reinterpret_cast<int*>(smem + 4 * G::OP + 2 * G::SF + 2 * G::ACC);

  const int tid = threadIdx.x, row = tid / TPR, part = tid % TPR;
  const int k0 = blockIdx.x * BT, hk = blockIdx.y, b = blockIdx.z;
  const int group = a.Hq / a.Hkv;
  const int k_rows = min(BT, a.Sk - k0);
  const size_t kvoff = ((size_t(b) * a.Hkv + hk) * a.Sk + k0) * a.D;
  load_tile<T, DP, BT>(sK, G::LDT, static_cast<const T*>(a.k) + kvoff,
                       k_rows, a.D, a.vec);
  load_tile<T, DP, BT>(sV, G::LDT, static_cast<const T*>(a.v) + kvoff,
                       k_rows, a.D, a.vec);
  load_kseg<BT>(sKseg, a, b, k0);
  for (int i = tid; i < BT * G::LDA; i += kThreads) {
    sDK[i] = 0.f;
    sDV[i] = 0.f;
  }
  const int nq = (a.Sq + BT - 1) / BT;
  int qi0 = 0;
  if (a.causal) {
    // the first q tile whose last row reaches this key tile's first key
    const long long x =
        static_cast<long long>(k0) + a.k_off - a.q_off - (BT - 1);
    qi0 = x <= 0 ? 0 : static_cast<int>((x + BT - 1) / BT);
  }
  for (int g = 0; g < group; ++g) {
    const size_t bh = size_t(b) * a.Hq + size_t(hk) * group + g;
    for (int qi = qi0; qi < nq; ++qi) {
      const int q0 = qi * BT, qrow = q0 + row;
      const size_t qoff = (bh * a.Sq + q0) * a.D;
      __syncthreads();  // the last tile's products are done with sQ, sDO,
                        // sP and sDS
      load_tile<T, DP, BT>(sQ, G::LDT, static_cast<const T*>(a.q) + qoff,
                           min(BT, a.Sq - q0), a.D, a.vec);
      load_tile<T, DP, BT>(sDO, G::LDT,
                           static_cast<const T*>(a.dout) + qoff,
                           min(BT, a.Sq - q0), a.D, a.vec);
      const RowStats st = row_stats(a, bh, b, qrow);
      const uint32_t rk =
          DROP ? drop_row_key(a, b, hk * group + g, qrow) : 0u;
      __syncthreads();
      tile_mm<T, BT, BT, DP, false, true>(sQ, G::LDT, sK, G::LDT, sS,
                                          G::LDS, false);
      tile_mm<T, BT, BT, DP, false, true>(sDO, G::LDT, sV, G::LDT, sDP,
                                          G::LDS, false);
      __syncthreads();
      if (a.bias != nullptr) {
        add_bias<BT, G::LDS>(a, sS, b, hk * group + g, q0, k0);
        __syncthreads();
      }
      float p[CPT], ds[CPT];
      probs_and_ds<G, DROP>(a, sS, sDP, sKseg, row, part, qrow, k0, st, rk,
                            a.scale, p, ds);
      __syncthreads();  // every score is read before P and dS overwrite
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        sP[row * G::LDP + part + TPR * j] = from_f32<T>(p[j]);
        sDS[row * G::LDP + part + TPR * j] = from_f32<T>(ds[j]);
      }
      __syncthreads();
      // dV += Pᵀ·dO and dK += dSᵀ·Q: the q tile is the product's depth
      tile_mm<T, BT, DP, BT, true, false>(sP, G::LDP, sDO, G::LDT, sDV,
                                          G::LDA, true);
      tile_mm<T, BT, DP, BT, true, false>(sDS, G::LDP, sQ, G::LDT, sDK,
                                          G::LDA, true);
    }
  }
  __syncthreads();
  const int krow = k0 + row;
  if (krow < a.Sk) {
    const size_t o = ((size_t(b) * a.Hkv + hk) * a.Sk + krow) * a.D;
    if (a.dkv_f32) {
      float* dk = static_cast<float*>(a.dk) + o;
      float* dv = static_cast<float*>(a.dv) + o;
      for (int c = part; c < a.D; c += TPR) {
        dk[c] = sDK[row * G::LDA + c];
        dv[c] = sDV[row * G::LDA + c];
      }
    } else {
      T* dk = static_cast<T*>(a.dk) + o;
      T* dv = static_cast<T*>(a.dv) + o;
      for (int c = part; c < a.D; c += TPR) {
        dk[c] = from_f32<T>(sDK[row * G::LDA + c]);
        dv[c] = from_f32<T>(sDV[row * G::LDA + c]);
      }
    }
  }
}

// dbias[bb, hb] = Σ over the (b, h) that broadcast onto (bb, hb) of
// p·(dp - δ + dlse), fp32 operands (bf16/fp16: flash_dbias_wg_kernel in
// flash_wg.cuh, the same sweep on wgmma). One block per (bb, hb, q tile, key tile): it
// sweeps the broadcast (b, h) in a fixed order (b = bb + (r / rh)·Bb,
// h = hb + (r % rh)·Hb, r = 0, 1, ...), recomputing S and dP each time,
// sums in registers and writes its output tile once: no atomics, no
// partials in device memory, the same bits on every launch. A causal tile
// wholly above the diagonal is written as zeros.
template <typename T, int DP, bool DROP>
__global__ void __launch_bounds__(kThreads)
    flash_dbias_kernel(const FlashArgs a) {
  using G = Geom<T, DP>;
  constexpr int BT = G::BT, TPR = G::TPR, CPT = G::CPT;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sDO = reinterpret_cast<T*>(smem + G::OP);
  T* sK = reinterpret_cast<T*>(smem + 2 * G::OP);
  T* sV = reinterpret_cast<T*>(smem + 3 * G::OP);
  float* sS = reinterpret_cast<float*>(smem + 4 * G::OP);
  float* sDP = reinterpret_cast<float*>(smem + 4 * G::OP + G::SF);
  int* sKseg = reinterpret_cast<int*>(smem + 4 * G::OP + 2 * G::SF);

  const int tid = threadIdx.x, row = tid / TPR, part = tid % TPR;
  const int nk = (a.Sk + BT - 1) / BT;
  const int q0 = (blockIdx.x / nk) * BT, k0 = (blockIdx.x % nk) * BT;
  const int hb = blockIdx.y, bb = blockIdx.z;
  const int rb = a.B / a.Bb, rh = a.Hq / a.Hb;
  const int qrow = q0 + row;
  const int q_rows = min(BT, a.Sq - q0), k_rows = min(BT, a.Sk - k0);
  float acc[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) acc[j] = 0.f;
  const bool live =
      !a.causal || static_cast<long long>(k0) + a.k_off <=
                       static_cast<long long>(q0) + BT - 1 + a.q_off;
  for (int r = 0; live && r < rb * rh; ++r) {
    const int b = bb + (r / rh) * a.Bb, h = hb + (r % rh) * a.Hb;
    const int hk = h / (a.Hq / a.Hkv);
    const size_t bh = size_t(b) * a.Hq + h;
    const size_t qoff = (bh * a.Sq + q0) * a.D;
    const size_t kvoff = ((size_t(b) * a.Hkv + hk) * a.Sk + k0) * a.D;
    __syncthreads();  // the last sweep step is done with every tile
    load_tile<T, DP, BT>(sQ, G::LDT, static_cast<const T*>(a.q) + qoff,
                         q_rows, a.D, a.vec);
    load_tile<T, DP, BT>(sDO, G::LDT, static_cast<const T*>(a.dout) + qoff,
                         q_rows, a.D, a.vec);
    load_tile<T, DP, BT>(sK, G::LDT, static_cast<const T*>(a.k) + kvoff,
                         k_rows, a.D, a.vec);
    load_tile<T, DP, BT>(sV, G::LDT, static_cast<const T*>(a.v) + kvoff,
                         k_rows, a.D, a.vec);
    load_kseg<BT>(sKseg, a, b, k0);
    __syncthreads();
    tile_mm<T, BT, BT, DP, false, true>(sQ, G::LDT, sK, G::LDT, sS, G::LDS,
                                        false);
    tile_mm<T, BT, BT, DP, false, true>(sDO, G::LDT, sV, G::LDT, sDP,
                                        G::LDS, false);
    __syncthreads();
    add_bias<BT, G::LDS>(a, sS, b, h, q0, k0);
    __syncthreads();
    const RowStats st = row_stats(a, bh, b, qrow);
    const uint32_t rk = DROP ? drop_row_key(a, b, h, qrow) : 0u;
    float p[CPT], ds[CPT];
    probs_and_ds<G, DROP>(a, sS, sDP, sKseg, row, part, qrow, k0, st, rk,
                          1.f, p, ds);
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[j] += ds[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < CPT; ++j) sS[row * G::LDS + part + TPR * j] = acc[j];
  __syncthreads();
  float* dst = a.dbias + (size_t(bb) * a.Hb + hb) * a.Sq * a.Sk;
  for (int i = tid; i < BT * BT; i += kThreads) {
    const int r = i / BT, c = i % BT;
    if (r < q_rows && c < k_rows)
      dst[size_t(q0 + r) * a.Sk + k0 + c] = sS[r * G::LDS + c];
  }
}

enum Which { kFwd = 0, kDq = 1, kDkv = 2, kDbias = 3 };

#include "flash_wg.cuh"

// bf16/fp16: the forward, dq, dk/dv and dbias on wgmma (flash_wg.cuh);
// fp32: all four here
template <typename T, int DP, bool DROP>
static int launch(int which, const FlashArgs& a, cudaStream_t st) {
  if constexpr (!std::is_same<T, float>::value) {
    return launch_wg<T, DP, DROP>(which, a, st);
  } else {
    using G = Geom<T, DP>;
    static bool attr_set[4] = {false, false, false, false};
    void (*kern)(const FlashArgs) = nullptr;
    size_t smem = 0;
    unsigned tiles = 0;
    unsigned heads = 0;
    if (which == kDbias) {
      kern = flash_dbias_kernel<T, DP, DROP>;
      smem = G::DB;
      tiles = ((a.Sq + G::BT - 1) / G::BT) * ((a.Sk + G::BT - 1) / G::BT);
      heads = a.Hb;
    } else if (which == kFwd) {
      kern = flash_fwd_kernel<T, DP, DROP>;
      smem = G::FWD;
      tiles = (a.Sq + G::BT - 1) / G::BT;
      heads = a.Hq;
    } else if (which == kDq) {
      kern = flash_dq_kernel<T, DP, DROP>;
      smem = G::DQ;
      tiles = (a.Sq + G::BT - 1) / G::BT;
      heads = a.Hq;
    } else {
      kern = flash_dkv_kernel<T, DP, DROP>;
      smem = G::DKV;
      tiles = (a.Sk + G::BT - 1) / G::BT;
      heads = a.Hkv;
    }
    if (!attr_set[which]) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
      attr_set[which] = true;
    }
    note_launch(kern, smem, kThreads);
    kern<<<dim3(tiles, heads, which == kDbias ? a.Bb : a.B), kThreads, smem,
           st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T, bool DROP>
static int launch_dp(int which, const FlashArgs& a, cudaStream_t st) {
  if (a.D <= 64) return launch<T, 64, DROP>(which, a, st);
  if (a.D <= 128) return launch<T, 128, DROP>(which, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// launch `which` for operand type `dtype` (DROP: the dropout variants)
template <bool DROP>
static int launch_typed(int which, const FlashArgs& a, int dtype,
                        cudaStream_t st) {
  switch (dtype) {
    case kF32:
      return launch_dp<float, DROP>(which, a, st);
    case kBF16:
      return launch_dp<__nv_bfloat16, DROP>(which, a, st);
    case kF16:
      return launch_dp<__half, DROP>(which, a, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the dropout variants, compiled in flash_attn_dropout.cu
int flash_launch_dropout(int which, const FlashArgs& a, int dtype,
                         cudaStream_t st);
