// Flash attention forward, dq, dk/dv and dbias for Hopper (sm_90a).
//
// Replaces: apex1_tpu/ops/attention.py::_fwd_kernel (launched by
// _flash_fwd_impl), ::_bwd_dq_kernel, ::_bwd_dkv_kernel and
// ::_dbias_kernel (launched by _flash_bwd_impl), the Pallas TPU kernels
// behind flash_attention, with their additive bias operand and their
// in-kernel attention-probability dropout.
//
//   forward:  s = q·kᵀ·scale (+ bias), invalid positions NEG_INF; online
//             softmax
//             over key tiles: m_new = max(m, max s), corr = exp(m - m_new),
//             e = valid ? exp(s - m_new) : 0, l = l·corr + Σe,
//             acc = acc·corr + e·v (e rounded to v's type);
//             out = acc / (l > 0 ? l : 1), lse = l > 0 ? m + log l : NEG_INF
//   dq:       p = valid ? exp(s - lse) : 0, dp = dO·vᵀ,
//             ds = p·(dp - δ + dlse)·scale, dq = ds·k (ds rounded to k's type)
//   dk, dv:   dv = pᵀ·dO, dk = dsᵀ·q, summed over the q heads of the kv
//             head's GQA group (p, ds rounded to dO's and q's type)
//   dbias:    Σ over the (b, h) a bias entry broadcasts to of
//             p·(dp - δ + dlse), fp32, with no trailing ·scale (that factor
//             belongs to d(q·kᵀ), not to d(bias))
//
// The bias is fp32 (Bb, Hb, Sq, Sk), Bb in {1, B}, Hb in {1, Hq}, read
// through broadcast strides (0 along a size-1 dimension) and added to the
// scaled score of every kernel before the mask: s·scale and + bias are
// rounded apart. The wgmma kernels stage the bias tile with their K/V or
// Q/dO tile (dbias: once, into registers) and add it in registers; fp32's
// kernels in a pass of the whole block over the fp32 score tile (coalesced
// rows). A null bias skips it.
// The causal tile skip stays exact: a bias never makes a masked position
// valid.
//
// Valid means: row < Sq, col < Sk, causal ⇒ col + k_off <= row + q_off,
// segments ⇒ qseg[row] == kseg[col]. A ragged Sq or Sk edge is masked
// here; nothing is padded in device memory.
//
// Dropout (p > 0; the reference's _keep_tile): keep = hash(seed,
// b·Hq + h, row + q_off, col + k_off) >= thr (dropout_hash.cuh), h the
// QUERY head (in dk/dv, hkv·group + g), inv = 1 / (1 - p) in fp32:
//   forward:  l and lse take the undropped e; P·V takes keep ? e·inv : 0,
//             rounded to v's type
//   dq:       dp = keep ? dp·inv : 0 before ds = p·(dp - δ + dlse)·scale
//   dk, dv:   dv takes keep ? p·inv : 0 (rounded to dO's type), ds as dq
// Forward and backward evaluate the mask at the same positions, so no
// mask is stored. A row's key is formed once (the wgmma forward and dq: a
// thread's two rows once a kernel; dk/dv: a q tile's 64 staged with it;
// dbias: a thread's two rows once a sweep step; fp32: once a tile), so an
// element costs one mix32. p == 0 launches
// the kernels without the dropout code (template DROP), as before. The
// kernels live in flash_attn.cuh and flash_wg.cuh; this file holds the
// entry points and
// the variants without dropout, flash_attn_dropout.cu the variants with
// it (two translation units, which nvcc compiles in parallel).
//
// dbias's blocks each own one (bb, hb, q tile, key tile) of the output and
// sweep the broadcast (b, h) onto it in a fixed order, summing in
// registers: one write per output tile, no atomics, equal bits on every
// launch (the reference's grid puts the sweep innermost with a VMEM
// accumulator for the same reason).
//
// Bound on the H100: operations. At GPT-2's training shape (B=16, H=12,
// S=1024, D=64, causal, bf16) the forward does 25.8 GFLOP against about
// 100 MB of operands, far above the card's ~295 flop/byte ridge.
//
// Design. The TPU kernels walk the key axis as the innermost, sequential
// grid axis and carry (m, l, acc) in VMEM scratch. Here one block owns a
// whole output tile and loops over the other axis itself:
// - forward and dq: one block per (b, h, q tile), looping over key tiles;
//   a causal loop stops at the diagonal tile (the TPU's skip test
//   ki·bk + k_off <= qi·bq + bq - 1 + q_off);
// - dk/dv: one block per (b, kv head, key tile), looping over the group's
//   q heads and over the q tiles from the diagonal on; the group sum
//   stays in the block's accumulators, as the TPU kernel keeps it in
//   scratch. No atomics anywhere: two runs give the same bits.
// bf16/fp16 forward (with the merge epilogue), dq, dk/dv and dbias: wgmma
// on register-resident fp32 accumulators, fed by a cp.async ring of
// 128B-swizzled shared tiles (flash_wg.cuh, which says how; dbias's sweep
// steps are its ring's stages, and the bias tile, the same at every step,
// stays in registers). fp32, all four: 128 threads staging every tile in
// shared memory with plain FMA on the CUDA cores (no TF32), 32-row tiles,
// the fp32 score tile through shared memory for the softmax and masking,
// done by 128 / rows threads per row. The head dimension is padded with
// zeros in shared memory to 64 or 128. Not yet: TMA, warp specialisation.

#include "flash_attn.cuh"

static int dispatch(int which, FlashArgs& a, int dropout, int dtype,
                    void* stream) {
  if (a.B <= 0 || a.Hq <= 0 || a.Sq <= 0 || a.Sk <= 0) return 0;
  if (a.Hkv <= 0 || a.Hq % a.Hkv != 0 || a.D <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.bias != nullptr && (a.Bb <= 0 || a.Hb <= 0 || a.B % a.Bb != 0 ||
                            a.Hq % a.Hb != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = as_stream(stream);
  return dropout ? flash_launch_dropout(which, a, dtype, st)
                 : launch_typed<false>(which, a, dtype, st);
}

static FlashArgs make_args(const void* q, const void* k, const void* v,
                           const void* qseg, const void* kseg,
                           const void* bias, int Bb, int Hb, int B, int Hq,
                           int Hkv, int Sq, int Sk, int D, float scale,
                           int causal, int q_off, int k_off, int vec,
                           unsigned seed, unsigned thr, float inv) {
  FlashArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.qseg = static_cast<const int*>(qseg);
  a.kseg = static_cast<const int*>(kseg);
  a.bias = static_cast<const float*>(bias);
  a.Bb = Bb;
  a.Hb = Hb;
  const long long plane = static_cast<long long>(Sq) * Sk;
  a.bias_sh = Hb == 1 ? 0 : plane;
  a.bias_sb = Bb == 1 ? 0 : Hb * plane;
  a.B = B;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.D = D;
  a.scale = scale;
  a.causal = causal;
  a.q_off = q_off;
  a.k_off = k_off;
  a.vec = vec;
  a.seed = seed;
  a.thr = thr;
  a.inv = inv;
  return a;
}

// q, out: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D), contiguous in `dtype`;
// qseg (B, Sq) and kseg (B, Sk) int32 or both null; bias fp32
// (Bb, Hb, Sq, Sk) with Bb in {1, B}, Hb in {1, Hq}, or null; lse
// (B, Hq, Sq) fp32.
// vec: D is 64 or 128 and every operand is 16-byte aligned. dropout: 1
// for p > 0, with the seed word, the threshold round(p·2^32) and
// inv = 1 / (1 - p); 0 ignores them.
extern "C" int apex1_flash_fwd(const void* q, const void* k, const void* v,
                               const void* qseg, const void* kseg,
                               const void* bias, void* out, void* lse, int B,
                               int Hq, int Hkv, int Sq, int Sk, int D, int Bb,
                               int Hb, float scale, int causal, int q_off,
                               int k_off, int vec, int dropout, unsigned seed,
                               unsigned thr, float inv, int dtype,
                               void* stream) {
  FlashArgs a = make_args(q, k, v, qseg, kseg, bias, Bb, Hb, B, Hq, Hkv, Sq,
                          Sk, D, scale, causal, q_off, k_off, vec, seed, thr,
                          inv);
  a.out = out;
  a.lse = static_cast<float*>(lse);
  return dispatch(kFwd, a, dropout, dtype, stream);
}

// The forward's merge mode (the all-gather flash attention's ring step):
// prev_out and out fp32 (B, Hq, Sq, D), prev_lse and lse fp32 (B, Hq, Sq);
// the other operands as apex1_flash_fwd's, without bias or dropout. out
// and lse may not alias prev_out and prev_lse.
extern "C" int apex1_flash_fwd_merge(const void* q, const void* k,
                                     const void* v, const void* qseg,
                                     const void* kseg, const void* prev_out,
                                     const void* prev_lse, void* out,
                                     void* lse, int B, int Hq, int Hkv,
                                     int Sq, int Sk, int D, float scale,
                                     int causal, int q_off, int k_off,
                                     int vec, int dtype, void* stream) {
  if (prev_out == nullptr || prev_lse == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  FlashArgs a = make_args(q, k, v, qseg, kseg, nullptr, 1, 1, B, Hq, Hkv, Sq,
                          Sk, D, scale, causal, q_off, k_off, vec, 0u, 0u,
                          0.f);
  a.prev_out = static_cast<const float*>(prev_out);
  a.prev_lse = static_cast<const float*>(prev_lse);
  a.out = out;
  a.lse = static_cast<float*>(lse);
  return dispatch(kFwd, a, 0, dtype, stream);
}

// dout, dq like q; lse, delta, dlse (B, Hq, Sq) fp32, dlse may be null
extern "C" int apex1_flash_dq(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, const void* dlse,
                              const void* qseg, const void* kseg,
                              const void* bias, void* dq, int B, int Hq,
                              int Hkv, int Sq, int Sk, int D, int Bb, int Hb,
                              float scale, int causal, int q_off, int k_off,
                              int vec, int dropout, unsigned seed,
                              unsigned thr, float inv, int dtype,
                              void* stream) {
  FlashArgs a = make_args(q, k, v, qseg, kseg, bias, Bb, Hb, B, Hq, Hkv, Sq,
                          Sk, D, scale, causal, q_off, k_off, vec, seed, thr,
                          inv);
  a.dout = dout;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dlse = static_cast<const float*>(dlse);
  a.dq = dq;
  return dispatch(kDq, a, dropout, dtype, stream);
}

// dk, dv like k, in k's dtype, or fp32 when dkv_f32 is 1
extern "C" int apex1_flash_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, const void* dlse,
                               const void* qseg, const void* kseg,
                               const void* bias, void* dk, void* dv,
                               int dkv_f32, int B,
                               int Hq, int Hkv, int Sq, int Sk, int D, int Bb,
                               int Hb, float scale, int causal, int q_off,
                               int k_off, int vec, int dropout, unsigned seed,
                               unsigned thr, float inv, int dtype,
                               void* stream) {
  FlashArgs a = make_args(q, k, v, qseg, kseg, bias, Bb, Hb, B, Hq, Hkv, Sq,
                          Sk, D, scale, causal, q_off, k_off, vec, seed, thr,
                          inv);
  a.dout = dout;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dlse = static_cast<const float*>(dlse);
  a.dk = dk;
  a.dv = dv;
  a.dkv_f32 = dkv_f32;
  return dispatch(kDkv, a, dropout, dtype, stream);
}

// dbias fp32 (Bb, Hb, Sq, Sk), written whole; the other operands as dq's,
// bias required
extern "C" int apex1_flash_dbias(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* dlse,
                                 const void* qseg, const void* kseg,
                                 const void* bias, void* dbias, int B,
                                 int Hq, int Hkv, int Sq, int Sk, int D,
                                 int Bb, int Hb, float scale, int causal,
                                 int q_off, int k_off, int vec, int dropout,
                                 unsigned seed, unsigned thr, float inv,
                                 int dtype, void* stream) {
  if (bias == nullptr || dbias == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  FlashArgs a = make_args(q, k, v, qseg, kseg, bias, Bb, Hb, B, Hq, Hkv, Sq,
                          Sk, D, scale, causal, q_off, k_off, vec, seed, thr,
                          inv);
  a.dout = dout;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dlse = static_cast<const float*>(dlse);
  a.dbias = static_cast<float*>(dbias);
  return dispatch(kDbias, a, dropout, dtype, stream);
}
