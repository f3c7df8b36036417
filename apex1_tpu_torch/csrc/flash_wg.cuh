// The bf16/fp16 flash forward (with its merge epilogue), dq, dk/dv and
// dbias for Hopper: warpgroups of 128 threads running wgmma m64nNk16 on
// shared tiles filled by a cp.async ring, with every fp32 accumulator
// (scores, output, dQ, dK, dV, dbias) in registers for the whole loop. Included by flash_attn.cuh,
// whose FlashArgs, masks and dropout hash they share; what they compute is
// described in flash_attn.cu.
//
// Forward: a warpgroup owns 64 query rows and walks the key tiles of 64.
// Per tile it computes S = Q·Kᵀ (Q and K from the swizzled shared tiles,
// K-major), applies scale, bias (staged in shared memory with the tile),
// masks and the online softmax on the accumulator fragment (a thread holds
// two rows; max and sum across the four threads of a row by shuffles),
// rescales its output registers, rounds P to T in registers and feeds it
// to O += P·V as wgmma's A operand (V the MN-major B operand). The next
// K/V tiles are in flight meanwhile.
//
// dk/dv: a warpgroup owns 64 keys of one kv head and walks the GQA group's
// query heads and their q tiles (g outer, q tile inner, the parent
// kernel's order, so the group sum stays in registers: no atomics, the
// same bits on every launch). Per q tile it computes Sᵀ = K·Qᵀ and
// dPᵀ = V·dOᵀ, forms Pᵀ and dSᵀ on the fragment from the tile's lse, δ,
// dlse and dropout row keys (staged in shared memory with the Q/dO tile),
// and accumulates dV += Pᵀ·dO and dK += dSᵀ·Q with Pᵀ and dSᵀ as the
// register A operand.
//
// dq: the forward's geometry with dk/dv's arithmetic. A warpgroup owns 64
// query rows of one (b, h), Q and dO staged once, and walks the key tiles
// the rows reach with K, V, the key segments and the bias tile in the
// ring. Per tile it computes S = Q·Kᵀ and dP = dO·Vᵀ (both operands
// K-major), forms dS on the fragment from its two rows' lse, δ, dlse and
// dropout row keys (kept in registers: the block's own rows), and
// accumulates dQ += dS·K with dS as the register A operand and K, read
// from the tile S used, as the MN-major B operand. Key tiles are summed in
// order: no atomics, the same bits on every launch.
//
// dbias: dq's S and dP on a 64 x 64 output tile of the bias, with the sweep
// over the (b, h) that broadcast onto it as the loop (flash_dbias_wg_kernel
// says how).
//
// Masks cost only where a tile crosses the diagonal, the Sq/Sk edge or a
// segment boundary: there a masked logit becomes -inf, in selects without
// branches (per-element branches in the unrolled fragment loop serialize
// it: the forward took twice as long with them).
//
// One __syncthreads a tile: after it the tile has landed (cp.async waited,
// then fence.proxy.async so wgmma sees it) and the block is done with the
// previous tile, whose stage the copy issued next refills, STAGES - 1
// tiles ahead.
#pragma once

#include "wgmma.cuh"

// Tiles and ring depth by head dim: a block is one warpgroup, so two or
// three blocks share an SM and one's copies and barriers overlap
// another's products; STAGES tiles are in the ring (STAGES - 1 in flight
// while one is multiplied): three where two blocks still fit an SM.
template <int DP>
struct WgGeom {
  static constexpr int NTHR = 128;
  static constexpr int NB = DP / 64;  // 64-wide blocks of the head dim
  static constexpr int STAGES = DP == 64 ? 3 : 2;
  // forward: BM query rows a block, BN keys a tile
  static constexpr int BM = 64, BN = 64;
  static constexpr int F_LDB = BN + 8;  // bias tile stride (floats)
  static constexpr size_t F_Q = size_t(BM) * DP * 2;
  static constexpr size_t F_KV = size_t(BN) * DP * 2;  // K or V
  static constexpr size_t F_STAGE = 2 * F_KV;
  static constexpr size_t F_SEG = size_t(BN) * 4;
  static constexpr size_t F_BIAS = size_t(BM) * F_LDB * 4;
  static constexpr size_t FWD =
      1024 + F_Q + STAGES * F_STAGE + STAGES * F_SEG;
  // dq: the forward's tiles and ring, with dO beside Q
  static constexpr size_t DQ = FWD + F_Q;
  // dk/dv: BK keys a block, BQ query rows a tile
  static constexpr int BK = 64, BQ = 64;
  static constexpr int B_LDB = BK + 4;  // bias tile stride (floats)
  static constexpr size_t B_KV = size_t(BK) * DP * 2;  // K or V
  static constexpr size_t B_Q = size_t(BQ) * DP * 2;   // Q or dO
  static constexpr size_t B_STAGE = 2 * B_Q;
  static constexpr size_t B_STATS = size_t(5) * BQ * 4;  // a stage's rows
  static constexpr size_t B_BIAS = size_t(BQ) * B_LDB * 4;
  static constexpr size_t DKV =
      1024 + 2 * B_KV + STAGES * B_STAGE + STAGES * B_STATS;
  // dbias: a stage is one sweep step's Q, dO, K and V tiles (BM = BN
  // rows each) and its rows' lse, δ, dlse and segments and its keys'
  // segments, three stages in the ring (two blocks an SM at DP 64)
  static constexpr int DB_STAGES = 3;
  static constexpr size_t DB_STAGE =
      (4 * F_Q + size_t(5) * BM * 4 + 1023) / 1024 * 1024;
  static constexpr size_t DB = 1024 + DB_STAGES * DB_STAGE;
  static_assert(DQ + STAGES * F_BIAS <= 232448 &&
                    DKV + STAGES * B_BIAS <= 232448 && DB <= 232448,
                "shared memory");
};

// number of BN-key tiles that query rows [r0, r0 + rows) reach (causal: up
// to the diagonal tile; the TPU kernels' skip test)
__device__ __forceinline__ int tiles_reached(const FlashArgs& a, int r0,
                                             int rows, int BN) {
  int nk = (a.Sk + BN - 1) / BN;
  if (a.causal) {
    const long long last =
        static_cast<long long>(r0) + rows - 1 + a.q_off - a.k_off;
    nk = last < 0 ? 0 : static_cast<int>(min(static_cast<long long>(nk),
                                             last / BN + 1));
  }
  return nk;
}

// the tile column of accumulator element i (4·j + 2·hh + e: column
// 8·j + 2·quad + e, row lane / 4 + 8·hh of the warp's 16)
__device__ __forceinline__ int col(int i, int quad) {
  return 8 * (i / 4) + 2 * quad + i % 2;
}

// every key of the BN-key tile at k0 valid for every query row from r0
// on: inside Sk, no segments, and (causal) below the diagonal
__device__ __forceinline__ bool full_tile(const FlashArgs& a, int k0, int BN,
                                          int r0) {
  return k0 + BN <= a.Sk && a.qseg == nullptr &&
         (!a.causal || static_cast<long long>(k0) + BN - 1 + a.k_off <=
                           static_cast<long long>(r0) + a.q_off);
}

// Masked positions of a 64-row score fragment (rows from q0, this
// thread's two at qrow with segments qs; keys from k0) become -inf, whose
// exp is exactly 0 whatever the row max (a valid logit of NEG_INF, as an
// additive mask gives, keeps the reference's exp(s - m)). Only a tile that
// crosses the diagonal, the Sk edge or a segment boundary pays for it, in
// selects without branches: per row, the last valid column (causal and
// Sk), then the segment ids (seg: the tile's key segments).
__device__ __forceinline__ void mask_logits(float (&s)[32], const FlashArgs& a,
                                            const int* seg, int quad, int q0,
                                            int k0, const int (&qrow)[2],
                                            const int (&qs)[2]) {
  if (full_tile(a, k0, 64, q0)) return;
  int last[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    last[hh] = a.causal ? min(a.Sk - 1 - k0, qrow[hh] + a.q_off - a.k_off - k0)
                        : a.Sk - 1 - k0;
#pragma unroll
  for (int i = 0; i < 32; ++i)
    s[i] = col(i, quad) <= last[(i / 2) % 2] ? s[i] : -INFINITY;
  if (a.qseg != nullptr) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      s[i] = seg[col(i, quad)] == qs[(i / 2) % 2] ? s[i] : -INFINITY;
  }
}

// The logits of a 64-row score fragment of the forward or dq: s·scale, or
// s·scale + bias rounded apart (tb: the stage's bias tile, row stride LDB;
// null without a bias), then `mask_logits`.
template <int LDB>
__device__ __forceinline__ void row_logits(float (&s)[32], const FlashArgs& a,
                                           const float* tb, const int* seg,
                                           int row0, int quad, int q0, int k0,
                                           const int (&qrow)[2],
                                           const int (&qs)[2]) {
  if (tb != nullptr) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = 4 * j + 2 * hh;
        const float2 bv = *reinterpret_cast<const float2*>(
            tb + (row0 + 8 * hh) * LDB + 8 * j + 2 * quad);
        s[i] = __fadd_rn(__fmul_rn(s[i], a.scale), bv.x);
        s[i + 1] = __fadd_rn(__fmul_rn(s[i + 1], a.scale), bv.y);
      }
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= a.scale;
  }
  mask_logits(s, a, seg, quad, q0, k0, qrow, qs);
}

// The forward's and dq's key ring: per BN-key tile its K and V (swizzled,
// K-major), its key segments and, with a bias, the block's BM x BN fp32
// bias tile, STAGES of each from `base` on (past the block's Q, and dq's
// dO). The block owns query rows q0.. of (b, h) and walks the nk key
// tiles they reach; `start` issues the first STAGES - 1 and `next(ki)`
// is the loop's one __syncthreads a tile, then refills the stage freed.
template <typename T, int DP>
struct KeyRing {
  using G = WgGeom<DP>;
  static constexpr int BM = G::BM, BN = G::BN, S = G::STAGES;
  const FlashArgs& a;
  unsigned char* base;
  const T* kg;
  const T* vg;
  const float* bg;  // the block's bias rows; null without a bias
  int b, q0, nk;
  bool vec, bias_vec;

  __device__ __forceinline__ KeyRing(const FlashArgs& args,
                                     unsigned char* ring, int b_, int h,
                                     int q0_)
      : a(args), base(ring), b(b_), q0(q0_) {
    const size_t kv0 =
        (size_t(b) * a.Hkv + h / (a.Hq / a.Hkv)) * a.Sk * a.D;
    kg = static_cast<const T*>(a.k) + kv0;
    vg = static_cast<const T*>(a.v) + kv0;
    bg = a.bias == nullptr ? nullptr
                           : a.bias + b * a.bias_sb + h * a.bias_sh +
                                 static_cast<long long>(q0) * a.Sk;
    vec = a.vec != 0;
    bias_vec = a.Sk % 4 == 0 && reinterpret_cast<uintptr_t>(a.bias) % 16 == 0;
    nk = tiles_reached(a, q0, BM, BN);
  }
  __device__ __forceinline__ unsigned char* k(int st) const {
    return base + st * G::F_STAGE;
  }
  __device__ __forceinline__ unsigned char* v(int st) const {
    return k(st) + G::F_KV;
  }
  __device__ __forceinline__ int* seg(int st) const {
    return reinterpret_cast<int*>(base + S * G::F_STAGE) + st * BN;
  }
  // the stage's bias tile (row stride F_LDB); null without a bias
  __device__ __forceinline__ float* bias(int st) const {
    return bg == nullptr ? nullptr
                         : reinterpret_cast<float*>(base + S * G::F_STAGE +
                                                    S * G::F_SEG) +
                               st * BM * G::F_LDB;
  }
  // issue key tile ki's copies as one group (an empty one past the last)
  __device__ __forceinline__ void load(int ki) const {
    if (ki < nk) {
      const int st = ki % S, k0 = ki * BN, rows = min(BN, a.Sk - k0);
      wg::load_tile<T, BN, DP, G::NTHR>(k(st), kg + size_t(k0) * a.D, rows,
                                        a.D, vec);
      wg::load_tile<T, BN, DP, G::NTHR>(v(st), vg + size_t(k0) * a.D, rows,
                                        a.D, vec);
      if (a.kseg != nullptr)
        for (int i = threadIdx.x; i < BN; i += G::NTHR)
          seg(st)[i] = i < rows ? a.kseg[size_t(b) * a.Sk + k0 + i] : 0;
      if (bg != nullptr)
        wg::load_f32_tile<BM, BN, G::F_LDB, G::NTHR>(
            bias(st), bg + k0, min(BM, a.Sq - q0), rows, a.Sk, bias_vec);
    }
    cp_async_commit();
  }
  __device__ __forceinline__ void start() const {
#pragma unroll
    for (int t = 0; t < S - 1; ++t) load(t);
  }
  // after it tile ki has landed and the block is done with tile ki - 1,
  // whose stage now refills with tile ki + S - 1
  __device__ __forceinline__ void next(int ki) const {
    cp_async_wait_group<S - 2>();
    wg::fence_async_smem();
    __syncthreads();
    load(ki + S - 1);
  }
};

template <typename T, int DP, bool DROP, bool MERGE>
__global__ void __launch_bounds__(WgGeom<DP>::NTHR)
    flash_fwd_wg_kernel(const FlashArgs a) {
  using G = WgGeom<DP>;
  constexpr int BM = G::BM, BN = G::BN, NB = G::NB, NTHR = G::NTHR;
  constexpr int S = G::STAGES;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t s0 = wg::smem_u32(wg_smem);
  unsigned char* sQ = wg_smem + (((s0 + 1023u) & ~1023u) - s0);

  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = tid / 32, quad = lane % 4;
  // the longest causal tiles first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = size_t(b) * a.Hq + h;
  const KeyRing<T, DP> ring(a, sQ + G::F_Q, b, h, q0);

  // this thread's two rows of the tile and their query rows
  const int row0 = warp * 16 + lane / 4;
  int qrow[2], qs[2];
  uint32_t rk[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    qrow[hh] = q0 + row0 + 8 * hh;
    qs[hh] = (a.qseg != nullptr && qrow[hh] < a.Sq)
                 ? a.qseg[size_t(b) * a.Sq + qrow[hh]]
                 : 0;
    rk[hh] = DROP ? drop_row_key(a, b, h, qrow[hh]) : 0u;
  }

  wg::load_tile<T, BM, DP, NTHR>(
      sQ, static_cast<const T*>(a.q) + (bh * a.Sq + q0) * a.D,
      min(BM, a.Sq - q0), a.D, ring.vec);
  ring.start();

  float o[NB][32];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[n][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int ki = 0; ki < ring.nk; ++ki) {
    ring.next(ki);
    const int st = ki % S, k0 = ki * BN;

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wg::mma_ss<T, 64, 0, 0>(s, wg::desc_k(sQ, BM, 0, kk),
                        wg::desc_k(ring.k(st), BN, 0, kk), kk > 0);
    wg::commit();
    wg::wait<0>();
    wg::keep(s);

    row_logits<G::F_LDB>(s, a, ring.bias(st), ring.seg(st), row0, quad, q0,
                         k0, qrow, qs);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh]);
      corr[hh] = expf(m[hh] - m_new);
      m[hh] = m_new;
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float ev[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hh + e;
          ev[e] = expf(s[i] - m[hh]);
          sum[hh] += ev[e];
          if constexpr (DROP)
            ev[e] = drop_keep(a, rk[hh], k0 + 8 * j + 2 * quad + e)
                        ? __fmul_rn(ev[e], a.inv)
                        : 0.f;
        }
        // the m64k16 A fragment of key slice j / 2: registers 0-3 are
        // (row, k 0-7), (row + 8, k 0-7), (row, k 8-15), (row + 8, k 8-15)
        pa[j / 2][2 * (j % 2) + hh] = wg::pack2<T>(ev[0], ev[1]);
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * corr[hh] + sum[hh];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[n][i] *= corr[(i / 2) % 2];

    wg::fence();
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int n = 0; n < NB; ++n)
        wg::mma_rs<T, 64, 1>(o[n], pa[t], wg::desc_mn(ring.v(st), BN, n, t),
                            1);
    wg::commit();
    wg::wait<0>();
#pragma unroll
    for (int n = 0; n < NB; ++n) wg::keep(o[n]);
#pragma unroll
    for (int t = 0; t < 4; ++t) wg::keep(pa[t]);
  }
  cp_async_wait_all();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    if (qrow[hh] >= a.Sq) continue;
    const float safe = l[hh] > 0.f ? l[hh] : 1.f;
    const float lse_t = l[hh] > 0.f ? m[hh] + logf(safe) : kNegInf;
    const size_t r = bh * a.Sq + qrow[hh];
    if constexpr (MERGE) {
      // the reference's _agf_kernel, op for op: this shard's output
      // rounded to T as the plain forward returns it, then
      // lse' = logaddexp(prev, lse_t) = max + log1p(exp(-|prev - lse_t|)),
      // out' = prev_out·exp(prev - lse') + o_t·exp(lse_t - lse'), each
      // product and the sum rounded apart
      const float prev = a.prev_lse[r];
      const float lse =
          fmaxf(prev, lse_t) + log1pf(expf(-fabsf(prev - lse_t)));
      const float wa = expf(prev - lse), wb = expf(lse_t - lse);
      const float* po = a.prev_out + r * a.D;
      float* out = static_cast<float*>(a.out) + r * a.D;
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 64 * n + 8 * j + 2 * quad;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float ot =
                to_f32(from_f32<T>(o[n][4 * j + 2 * hh + e] / safe));
            v[e] = c + e < a.D ? __fadd_rn(__fmul_rn(po[c + e], wa),
                                           __fmul_rn(ot, wb))
                               : 0.f;
          }
          store_pair(out, c, a.D, v[0], v[1], a.D % 2 == 0);
        }
      if (quad == 0) a.lse[r] = lse;
    } else {
      T* out = static_cast<T*>(a.out) + r * a.D;
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          store_pair(out, 64 * n + 8 * j + 2 * quad, a.D,
                     o[n][4 * j + 2 * hh] / safe,
                     o[n][4 * j + 2 * hh + 1] / safe, a.D % 2 == 0);
      if (quad == 0) a.lse[r] = lse_t;
    }
  }
}

template <typename T, int DP, bool DROP>
__global__ void __launch_bounds__(WgGeom<DP>::NTHR)
    flash_dkv_wg_kernel(const FlashArgs a) {
  using G = WgGeom<DP>;
  constexpr int BK = G::BK, BQ = G::BQ, NB = G::NB, NTHR = G::NTHR;
  constexpr int S = G::STAGES;
  constexpr int NJ = BQ / 8;  // n8 column blocks of a q tile
  static_assert(BQ == 64, "Sᵀ and dPᵀ are m64n64 products");
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t s0 = wg::smem_u32(wg_smem);
  unsigned char* sK = wg_smem + (((s0 + 1023u) & ~1023u) - s0);
  unsigned char* sV = sK + G::B_KV;
  auto sQ = [&](int st) { return sK + 2 * G::B_KV + st * G::B_STAGE; };
  auto sDO = [&](int st) { return sQ(st) + G::B_Q; };
  // a stage's per-row statistics: lse, δ, dlse, dropout row key, segment
  float* sStats =
      reinterpret_cast<float*>(sK + 2 * G::B_KV + S * G::B_STAGE);
  float* sBias = reinterpret_cast<float*>(sK + 2 * G::B_KV +
                                          S * G::B_STAGE + S * G::B_STATS);

  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = tid / 32, quad = lane % 4;
  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int group = a.Hq / a.Hkv;
  const bool vec = a.vec != 0;
  const bool bias_vec = a.Sk % 4 == 0 &&
                        reinterpret_cast<uintptr_t>(a.bias) % 16 == 0;
  const size_t kvoff = ((size_t(b) * a.Hkv + hk) * a.Sk + k0) * a.D;
  wg::load_tile<T, BK, DP, NTHR>(sK, static_cast<const T*>(a.k) + kvoff,
                                 min(BK, a.Sk - k0), a.D, vec);
  wg::load_tile<T, BK, DP, NTHR>(sV, static_cast<const T*>(a.v) + kvoff,
                                 min(BK, a.Sk - k0), a.D, vec);

  // this thread's two key rows and their segments
  const int row0 = warp * 16 + lane / 4;
  int krow[2], ks[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    krow[hh] = k0 + row0 + 8 * hh;
    ks[hh] = (a.kseg != nullptr && krow[hh] < a.Sk)
                 ? a.kseg[size_t(b) * a.Sk + krow[hh]]
                 : 0;
  }

  const int nq = (a.Sq + BQ - 1) / BQ;
  int qi0 = 0;
  if (a.causal) {
    // the first q tile whose last row reaches this block's first key
    const long long x =
        static_cast<long long>(k0) + a.k_off - a.q_off - (BQ - 1);
    qi0 = x <= 0 ? 0 : static_cast<int>(min(static_cast<long long>(nq),
                                            (x + BQ - 1) / BQ));
  }
  const int per_g = nq - qi0, ntiles = group * per_g;

  auto load_stage = [&](int t) {
    const int st = t % S, g = t / per_g, q0 = (qi0 + t % per_g) * BQ;
    const int hq = hk * group + g, rows = min(BQ, a.Sq - q0);
    const size_t bhq = size_t(b) * a.Hq + hq;
    const size_t qoff = (bhq * a.Sq + q0) * a.D;
    wg::load_tile<T, BQ, DP, NTHR>(sQ(st), static_cast<const T*>(a.q) + qoff,
                                   rows, a.D, vec);
    wg::load_tile<T, BQ, DP, NTHR>(
        sDO(st), static_cast<const T*>(a.dout) + qoff, rows, a.D, vec);
    float* stats = sStats + st * 5 * BQ;
    for (int i = tid; i < BQ; i += NTHR) {
      const bool in = i < rows;
      const size_t r = bhq * a.Sq + q0 + i;
      stats[i] = in ? a.lse_in[r] : 0.f;
      stats[BQ + i] = in ? a.delta[r] : 0.f;
      stats[2 * BQ + i] = (in && a.dlse != nullptr) ? a.dlse[r] : 0.f;
      reinterpret_cast<uint32_t*>(stats)[3 * BQ + i] =
          DROP ? drop_row_key(a, b, hq, q0 + i) : 0u;
      reinterpret_cast<int*>(stats)[4 * BQ + i] =
          (in && a.qseg != nullptr) ? a.qseg[size_t(b) * a.Sq + q0 + i] : 0;
    }
    if (a.bias != nullptr)
      wg::load_f32_tile<BQ, BK, G::B_LDB, NTHR>(
          sBias + st * BQ * G::B_LDB,
          a.bias + b * a.bias_sb + hq * a.bias_sh +
              static_cast<long long>(q0) * a.Sk + k0,
          rows, min(BK, a.Sk - k0), a.Sk, bias_vec);
    cp_async_commit();
  };

  float dk[NB][32], dv[NB][32];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      dk[n][i] = 0.f;
      dv[n][i] = 0.f;
    }
#pragma unroll
  for (int t = 0; t < S - 1; ++t) {
    if (t < ntiles)
      load_stage(t);
    else
      cp_async_commit();
  }

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait_group<S - 2>();
    wg::fence_async_smem();
    __syncthreads();  // tile t has landed; tile t - 1's stage is free
    if (t + S - 1 < ntiles)
      load_stage(t + S - 1);
    else
      cp_async_commit();
    const int st = t % S, q0 = (qi0 + t % per_g) * BQ;

    float s[BQ / 2], dp[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      s[i] = 0.f;
      dp[i] = 0.f;
    }
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wg::mma_ss<T, 64, 0, 0>(s, wg::desc_k(sK, BK, 0, kk),
                        wg::desc_k(sQ(st), BQ, 0, kk), kk > 0);
      wg::mma_ss<T, 64, 0, 0>(dp, wg::desc_k(sV, BK, 0, kk),
                        wg::desc_k(sDO(st), BQ, 0, kk), kk > 0);
    }
    wg::commit();
    wg::wait<0>();
    wg::keep(s);
    wg::keep(dp);

    const float* stats = sStats + st * 5 * BQ;
    const uint32_t* rks = reinterpret_cast<const uint32_t*>(stats) + 3 * BQ;
    const int* qsg = reinterpret_cast<const int*>(stats) + 4 * BQ;
    // the logits, then masked positions -inf (exp gives exactly 0), as in
    // the forward: per key row, the first valid q column (causal) and the
    // last (Sq; none past Sk), then the segment ids
    if (a.bias != nullptr) {
      const float* tb = sBias + st * BQ * G::B_LDB;
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int r = row0 + 8 * ((i / 2) % 2);
        s[i] = __fadd_rn(__fmul_rn(s[i], a.scale),
                         tb[col(i, quad) * G::B_LDB + r]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) s[i] *= a.scale;
    }
    const bool full =
        q0 + BQ <= a.Sq && k0 + BK <= a.Sk && a.qseg == nullptr &&
        (!a.causal || static_cast<long long>(k0) + BK - 1 + a.k_off <=
                          static_cast<long long>(q0) + a.q_off);
    if (!full) {
      int first[2], last[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        first[hh] = a.causal ? krow[hh] + a.k_off - a.q_off - q0 : 0;
        last[hh] = krow[hh] < a.Sk ? a.Sq - 1 - q0 : -1;
      }
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int c = col(i, quad), hh = (i / 2) % 2;
        s[i] = (c >= first[hh]) & (c <= last[hh]) ? s[i] : -INFINITY;
      }
      if (a.qseg != nullptr) {
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i)
          s[i] = qsg[col(i, quad)] == ks[(i / 2) % 2] ? s[i] : -INFINITY;
      }
    }
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float pv2[2], ds2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hh + e, c = 8 * j + 2 * quad + e;
          const float pv = expf(s[i] - stats[c]);
          float dpv = dp[i], p = pv;
          if constexpr (DROP) {
            const bool keep = drop_keep(a, rks[c], krow[hh]);
            dpv = keep ? __fmul_rn(dpv, a.inv) : 0.f;
            p = keep ? __fmul_rn(pv, a.inv) : 0.f;
          }
          pv2[e] = p;
          ds2[e] = pv * (dpv - stats[BQ + c] + stats[2 * BQ + c]) * a.scale;
        }
        pa[j / 2][2 * (j % 2) + hh] = wg::pack2<T>(pv2[0], pv2[1]);
        da[j / 2][2 * (j % 2) + hh] = wg::pack2<T>(ds2[0], ds2[1]);
      }

    wg::fence();
#pragma unroll
    for (int t16 = 0; t16 < BQ / 16; ++t16)
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        wg::mma_rs<T, 64, 1>(dv[n], pa[t16],
                            wg::desc_mn(sDO(st), BQ, n, t16), 1);
        wg::mma_rs<T, 64, 1>(dk[n], da[t16], wg::desc_mn(sQ(st), BQ, n, t16),
                            1);
      }
    wg::commit();
    wg::wait<0>();
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      wg::keep(dv[n]);
      wg::keep(dk[n]);
    }
#pragma unroll
    for (int t16 = 0; t16 < BQ / 16; ++t16) {
      wg::keep(pa[t16]);
      wg::keep(da[t16]);
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (krow[hh] >= a.Sk) continue;
    const size_t o = ((size_t(b) * a.Hkv + hk) * a.Sk + krow[hh]) * a.D;
    const bool pair = a.D % 2 == 0;
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 64 * n + 8 * j + 2 * quad, i = 4 * j + 2 * hh;
        if (a.dkv_f32) {
          store_pair(static_cast<float*>(a.dk) + o, c, a.D, dk[n][i],
                     dk[n][i + 1], pair);
          store_pair(static_cast<float*>(a.dv) + o, c, a.D, dv[n][i],
                     dv[n][i + 1], pair);
        } else {
          store_pair(static_cast<T*>(a.dk) + o, c, a.D, dk[n][i],
                     dk[n][i + 1], pair);
          store_pair(static_cast<T*>(a.dv) + o, c, a.D, dv[n][i],
                     dv[n][i + 1], pair);
        }
      }
  }
}

template <typename T, int DP, bool DROP>
__global__ void __launch_bounds__(WgGeom<DP>::NTHR)
    flash_dq_wg_kernel(const FlashArgs a) {
  using G = WgGeom<DP>;
  constexpr int BM = G::BM, BN = G::BN, NB = G::NB, NTHR = G::NTHR;
  constexpr int S = G::STAGES;
  static_assert(BN == 64, "S and dP are m64n64 products");
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t s0 = wg::smem_u32(wg_smem);
  unsigned char* sQ = wg_smem + (((s0 + 1023u) & ~1023u) - s0);
  unsigned char* sDO = sQ + G::F_Q;

  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = tid / 32, quad = lane % 4;
  // the longest causal tiles first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = size_t(b) * a.Hq + h;
  const KeyRing<T, DP> ring(a, sDO + G::F_Q, b, h, q0);

  // this thread's two rows of the tile: query row, lse, δ, dlse, segment
  // and dropout row key, in registers for the whole loop
  const int row0 = warp * 16 + lane / 4;
  int qrow[2], qs[2];
  float lse[2], dlt[2], dls[2];
  uint32_t rk[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    qrow[hh] = q0 + row0 + 8 * hh;
    const bool in = qrow[hh] < a.Sq;
    const size_t r = bh * a.Sq + qrow[hh];
    lse[hh] = in ? a.lse_in[r] : 0.f;
    dlt[hh] = in ? a.delta[r] : 0.f;
    dls[hh] = (in && a.dlse != nullptr) ? a.dlse[r] : 0.f;
    qs[hh] = (in && a.qseg != nullptr) ? a.qseg[size_t(b) * a.Sq + qrow[hh]]
                                       : 0;
    rk[hh] = DROP ? drop_row_key(a, b, h, qrow[hh]) : 0u;
  }

  const size_t qoff = (bh * a.Sq + q0) * a.D;
  const int q_rows = min(BM, a.Sq - q0);
  wg::load_tile<T, BM, DP, NTHR>(sQ, static_cast<const T*>(a.q) + qoff,
                                 q_rows, a.D, ring.vec);
  wg::load_tile<T, BM, DP, NTHR>(sDO, static_cast<const T*>(a.dout) + qoff,
                                 q_rows, a.D, ring.vec);
  ring.start();

  float dq[NB][32];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[n][i] = 0.f;

  for (int ki = 0; ki < ring.nk; ++ki) {
    ring.next(ki);
    const int st = ki % S, k0 = ki * BN;

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = 0.f;
      dp[i] = 0.f;
    }
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wg::mma_ss<T, 64, 0, 0>(s, wg::desc_k(sQ, BM, 0, kk),
                        wg::desc_k(ring.k(st), BN, 0, kk), kk > 0);
      wg::mma_ss<T, 64, 0, 0>(dp, wg::desc_k(sDO, BM, 0, kk),
                        wg::desc_k(ring.v(st), BN, 0, kk), kk > 0);
    }
    wg::commit();
    wg::wait<0>();
    wg::keep(s);
    wg::keep(dp);

    row_logits<G::F_LDB>(s, a, ring.bias(st), ring.seg(st), row0, quad, q0,
                         k0, qrow, qs);
    // dS = P ∘ (dP' - δ + dlse)·scale, dP' = keep ? dP·inv : 0 with
    // dropout; rounded to T as the A fragment of key slice j / 2
    uint32_t da[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float ds2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hh + e;
          const float pv = expf(s[i] - lse[hh]);
          float dpv = dp[i];
          if constexpr (DROP)
            dpv = drop_keep(a, rk[hh], k0 + 8 * j + 2 * quad + e)
                      ? __fmul_rn(dpv, a.inv)
                      : 0.f;
          ds2[e] = pv * (dpv - dlt[hh] + dls[hh]) * a.scale;
        }
        da[j / 2][2 * (j % 2) + hh] = wg::pack2<T>(ds2[0], ds2[1]);
      }

    wg::fence();
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int n = 0; n < NB; ++n)
        wg::mma_rs<T, 64, 1>(dq[n], da[t], wg::desc_mn(ring.k(st), BN, n, t),
                            1);
    wg::commit();
    wg::wait<0>();
#pragma unroll
    for (int n = 0; n < NB; ++n) wg::keep(dq[n]);
#pragma unroll
    for (int t = 0; t < 4; ++t) wg::keep(da[t]);
  }
  cp_async_wait_all();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (qrow[hh] >= a.Sq) continue;
    T* out = static_cast<T*>(a.dq) + (bh * a.Sq + qrow[hh]) * a.D;
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        store_pair(out, 64 * n + 8 * j + 2 * quad, a.D,
                   dq[n][4 * j + 2 * hh], dq[n][4 * j + 2 * hh + 1],
                   a.D % 2 == 0);
  }
}

// 4-byte cp.async (src_bytes 0: zeros)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

// dbias: a warpgroup owns the 64 x 64 output tile (bb, hb, q0, k0) and
// sweeps the (b, h) that broadcast onto it in flash_attn.cuh's fixed order
// (b = bb + (r / rh)·Bb, h = hb + (r % rh)·Hb, r = 0, 1, ...). Per step it
// computes S = Q·Kᵀ and dP = dO·Vᵀ (both operands K-major) on the step's
// tiles, adds the bias (the same tile every step: read once into this
// thread's fragment registers) and masks as dq does, and adds
// p·(dP' - δ + dlse) to the fp32 fragment that holds the tile's sum, from
// the rows' lse, δ, dlse and segments staged with the step and the
// dropout row keys of (b, h). The ring holds DB_STAGES steps: the next
// steps' Q, dO, K, V and statistics are in flight while one multiplies,
// one __syncthreads a step. The tile is written once: no atomics, the same
// bits on every launch. A causal tile wholly above the diagonal sweeps
// nothing and writes zeros.
template <typename T, int DP, bool DROP>
__global__ void __launch_bounds__(WgGeom<DP>::NTHR)
    flash_dbias_wg_kernel(const FlashArgs a) {
  using G = WgGeom<DP>;
  constexpr int BM = G::BM, BN = G::BN, NTHR = G::NTHR;
  constexpr int S = G::DB_STAGES;
  static_assert(BM == BN && BM == 64 && NTHR == 2 * BM,
                "64 x 64 tiles, a thread a row or key of the statistics");
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t s0 = wg::smem_u32(wg_smem);
  unsigned char* base = wg_smem + (((s0 + 1023u) & ~1023u) - s0);
  // stage st: tiles Q, dO, K, V (j = 0..3), then lse, δ, dlse, the rows'
  // and the keys' segments, BM values each
  auto tile = [&](int st, int j) {
    return base + st * G::DB_STAGE + j * G::F_Q;
  };
  auto stats = [&](int st) {
    return reinterpret_cast<float*>(base + st * G::DB_STAGE + 4 * G::F_Q);
  };

  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = tid / 32, quad = lane % 4;
  const int nk = (a.Sk + BN - 1) / BN;
  const int q0 = (blockIdx.x / nk) * BM, k0 = (blockIdx.x % nk) * BN;
  const int hb = blockIdx.y, bb = blockIdx.z;
  const int rh = a.Hq / a.Hb;
  const bool live = !a.causal || static_cast<long long>(k0) + a.k_off <=
                                     static_cast<long long>(q0) + BM - 1 +
                                         a.q_off;
  const int steps = live ? (a.B / a.Bb) * rh : 0;
  const int q_rows = min(BM, a.Sq - q0), k_rows = min(BN, a.Sk - k0);
  const bool vec = a.vec != 0;

  // this thread's two rows of the tile, and its bias fragment
  const int row0 = warp * 16 + lane / 4;
  const int qrow[2] = {q0 + row0, q0 + row0 + 8};
  float bias[32];
  {
    const float* bt = a.bias + bb * a.bias_sb + hb * a.bias_sh;
    const bool pair = a.Sk % 2 == 0 &&
                      reinterpret_cast<uintptr_t>(a.bias) % 8 == 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = 4 * j + 2 * hh, c = 8 * j + 2 * quad;
        const float* src = bt + static_cast<long long>(qrow[hh]) * a.Sk + k0;
        if (qrow[hh] >= a.Sq) {
          bias[i] = bias[i + 1] = 0.f;
        } else if (pair && c + 1 < k_rows) {
          const float2 v = *reinterpret_cast<const float2*>(src + c);
          bias[i] = v.x;
          bias[i + 1] = v.y;
        } else {
          bias[i] = c < k_rows ? src[c] : 0.f;
          bias[i + 1] = c + 1 < k_rows ? src[c + 1] : 0.f;
        }
      }
  }

  // sweep step r's copies as one group (an empty one past the last)
  auto load_step = [&](int r) {
    if (r < steps) {
      const int st = r % S;
      const int b = bb + (r / rh) * a.Bb, h = hb + (r % rh) * a.Hb;
      const int hk = h / (a.Hq / a.Hkv);
      const size_t bh = size_t(b) * a.Hq + h;
      const size_t qoff = (bh * a.Sq + q0) * a.D;
      const size_t kvoff = ((size_t(b) * a.Hkv + hk) * a.Sk + k0) * a.D;
      wg::load_tile<T, BM, DP, NTHR>(
          tile(st, 0), static_cast<const T*>(a.q) + qoff, q_rows, a.D, vec);
      wg::load_tile<T, BM, DP, NTHR>(
          tile(st, 1), static_cast<const T*>(a.dout) + qoff, q_rows, a.D,
          vec);
      wg::load_tile<T, BN, DP, NTHR>(
          tile(st, 2), static_cast<const T*>(a.k) + kvoff, k_rows, a.D, vec);
      wg::load_tile<T, BN, DP, NTHR>(
          tile(st, 3), static_cast<const T*>(a.v) + kvoff, k_rows, a.D, vec);
      float* sts = stats(st);
      if (tid < BM) {  // a query row's statistics
        const bool in = tid < q_rows;
        const size_t i = bh * a.Sq + q0 + tid;
        cp_async4(sts + tid, in ? a.lse_in + i : a.lse_in, in ? 4 : 0);
        cp_async4(sts + BM + tid, in ? a.delta + i : a.delta, in ? 4 : 0);
        if (a.dlse != nullptr)
          cp_async4(sts + 2 * BM + tid, in ? a.dlse + i : a.dlse,
                    in ? 4 : 0);
        if (a.qseg != nullptr) {
          const int* src = a.qseg + size_t(b) * a.Sq + q0 + tid;
          cp_async4(sts + 3 * BM + tid, in ? src : a.qseg, in ? 4 : 0);
        }
      } else if (a.kseg != nullptr) {  // a key's segment
        const int key = tid - BM;
        const bool in = key < k_rows;
        const int* src = a.kseg + size_t(b) * a.Sk + k0 + key;
        cp_async4(sts + 4 * BM + key, in ? src : a.kseg, in ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
  for (int t = 0; t < S - 1; ++t) load_step(t);

  for (int r = 0; r < steps; ++r) {
    cp_async_wait_group<S - 2>();
    wg::fence_async_smem();
    __syncthreads();  // step r has landed; step r - 1's stage is free
    load_step(r + S - 1);
    const int st = r % S;
    const int b = bb + (r / rh) * a.Bb, h = hb + (r % rh) * a.Hb;

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = 0.f;
      dp[i] = 0.f;
    }
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wg::mma_ss<T, 64, 0, 0>(s, wg::desc_k(tile(st, 0), BM, 0, kk),
                              wg::desc_k(tile(st, 2), BN, 0, kk), kk > 0);
      wg::mma_ss<T, 64, 0, 0>(dp, wg::desc_k(tile(st, 1), BM, 0, kk),
                              wg::desc_k(tile(st, 3), BN, 0, kk), kk > 0);
    }
    wg::commit();
    wg::wait<0>();
    wg::keep(s);
    wg::keep(dp);

    const float* sts = stats(st);
    const int* isg = reinterpret_cast<const int*>(sts);
    float lse[2], dlt[2], dls[2];
    int qs[2];
    uint32_t rk[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rr = row0 + 8 * hh;
      lse[hh] = sts[rr];
      dlt[hh] = sts[BM + rr];
      dls[hh] = a.dlse != nullptr ? sts[2 * BM + rr] : 0.f;
      qs[hh] = a.qseg != nullptr ? isg[3 * BM + rr] : 0;
      rk[hh] = DROP ? drop_row_key(a, b, h, qrow[hh]) : 0u;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i)
      s[i] = __fadd_rn(__fmul_rn(s[i], a.scale), bias[i]);
    mask_logits(s, a, isg + 4 * BM, quad, q0, k0, qrow, qs);
    // dS of the full logit (no trailing ·scale), dP' = keep ? dP·inv : 0
    // with dropout
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hh + e;
          const float pv = expf(s[i] - lse[hh]);
          float dpv = dp[i];
          if constexpr (DROP)
            dpv = drop_keep(a, rk[hh], k0 + 8 * j + 2 * quad + e)
                      ? __fmul_rn(dpv, a.inv)
                      : 0.f;
          acc[i] += pv * (dpv - dlt[hh] + dls[hh]);
        }
  }
  cp_async_wait_all();

  float* dst = a.dbias + (size_t(bb) * a.Hb + hb) * a.Sq * a.Sk;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (qrow[hh] >= a.Sq) continue;
    float* out = dst + static_cast<long long>(qrow[hh]) * a.Sk + k0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      store_pair(out, 8 * j + 2 * quad, k_rows, acc[4 * j + 2 * hh],
                 acc[4 * j + 2 * hh + 1], a.Sk % 2 == 0);
  }
}

// launch the forward (which == kFwd; the merge epilogue when prev_lse is
// set), dq, dk/dv or dbias for T in {bf16, fp16}
template <typename T, int DP, bool DROP>
static int launch_wg(int which, const FlashArgs& a, cudaStream_t st) {
  using G = WgGeom<DP>;
  static bool attr_set[5] = {false, false, false, false, false};
  void (*kern)(const FlashArgs);
  size_t smem, most;
  dim3 grid;
  int slot;
  if (which == kFwd) {
    if constexpr (DROP) {
      kern = flash_fwd_wg_kernel<T, DP, true, false>;
      slot = 0;
    } else {
      const bool merge = a.prev_lse != nullptr;
      kern = merge ? flash_fwd_wg_kernel<T, DP, false, true>
                   : flash_fwd_wg_kernel<T, DP, false, false>;
      slot = merge ? 1 : 0;
    }
    smem = G::FWD;
    most = G::FWD + G::STAGES * G::F_BIAS;
    grid = dim3((a.Sq + G::BM - 1) / G::BM, a.Hq, a.B);
  } else if (which == kDq) {
    kern = flash_dq_wg_kernel<T, DP, DROP>;
    slot = 3;
    smem = G::DQ;
    most = G::DQ + G::STAGES * G::F_BIAS;
    grid = dim3((a.Sq + G::BM - 1) / G::BM, a.Hq, a.B);
  } else if (which == kDkv) {
    kern = flash_dkv_wg_kernel<T, DP, DROP>;
    slot = 2;
    smem = G::DKV;
    most = G::DKV + G::STAGES * G::B_BIAS;
    grid = dim3((a.Sk + G::BK - 1) / G::BK, a.Hkv, a.B);
  } else {
    kern = flash_dbias_wg_kernel<T, DP, DROP>;
    slot = 4;
    smem = most = G::DB;
    grid = dim3(((a.Sq + G::BM - 1) / G::BM) * ((a.Sk + G::BN - 1) / G::BN),
                a.Hb, a.Bb);
  }
  if (a.bias != nullptr) smem = most;
  if (!attr_set[slot]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(most));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set[slot] = true;
  }
  note_launch(kern, smem, G::NTHR);
  kern<<<grid, G::NTHR, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
