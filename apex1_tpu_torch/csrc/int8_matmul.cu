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
// there and feeds the MXU, so the bf16 matrix never exists in HBM. Here
// the weight lies on wgmma's 64-row side and the tokens on its N side, so
// one design covers decode's 8 rows (m64n8) and prefill's 1024 (m64n192
// tiles): a block of NWG warpgroups owns BM = 64·NWG weight rows x BT
// tokens. K runs in 64-deep steps through a ring of STAGES stages,
// STAGES - 2 ahead: a stage holds the x tile (BT x 64 bf16, the
// 128B-swizzled K-major B operand) and the raw int8 rows (BM x 64 bytes,
// 64B-swizzled). Where x and w are 16-byte aligned and K % 16 == 0,
// thread 0 fills a stage with two TMA tensor copies (each box swizzled by
// the copy itself; ragged edges arrive as zeros) that complete on the
// stage's mbarrier; else every thread loads its share value by value.
// The weight never goes to shared memory as bf16: each
// thread loads the int8 of its own wgmma A fragment (two 4-byte loads and
// a byte permute per row and k16 step; the swizzle keeps a warp's eight
// rows in distinct banks) and converts it in registers, two values at a
// time, with two bit masks and one bf16x2 subtraction (exact: |q| <= 128,
// no cvt); the products take A from registers (wgmma's register form),
// two fragment sets in turn: step k + 1's load as soon as step k - 1's
// products are done, behind step k's. One barrier a step guards the
// ring. The accumulators are Cᵀ (weight rows x tokens); the epilogue
// stages them through shared memory so that y's rows are stored as
// coalesced float4s, the scale applied there, once, after the whole K
// sum, as the TPU kernel does on its last K block. Prefill is bound by
// the tiles' traffic from L2 and each step's fixed work (the weight's
// conversion, the barrier): 128 x 192 tiles (two waves of 132 at 1024 x
// 5632) move less than 128 x 128 and waste less of a wave than 128 x 256.
//
// A grid too small for the 132 SMs (decode's narrow projections) splits
// K inside the same launch: each tile's `splits` blocks store their fp32
// partial sums, then take a ticket from the tile's counter; the tile's
// last block adds the slices in split order, applies the scale, stores y
// and resets the counter for the next launch. The counter only orders the
// blocks; it never holds a value of the sum. Fixed order and no atomic
// sums: two launches give the same bits.
//
// Every shape is taken: ragged N, T and K tiles are zero-filled in shared
// memory; K % 16 != 0 or unaligned pointers take plain loads (no TMA).
// Not yet: warp specialisation (a producer warp and mbarriers for the
// ring in place of the block barrier), a persistent grid.

#include "gemm_wg.cuh"

#include <cuda.h>
#include <cudaTypedefs.h>

namespace {

constexpr int kBK = 64;
constexpr int kMaxTiles = 1024;  // the counters the wrapper allocates
constexpr int kMaxSplits = 16;   // the wrapper's most K splits

struct I8Args {
  CUtensorMap tx, tw;      // x's and w's TMA descriptors (`vec` launches)
  const __nv_bfloat16* x;  // (T, K)
  const int8_t* w;         // (N, K)
  const float* scale;      // (N,)
  float* out;              // (T, N)
  float* part;             // (tiles, splits, bt, bm) partial sums, or null
  int* counters;           // a ticket counter a tile, all 0
  int T, N, K, kc, splits;
  bool vec;
};

template <int NWG, int BT>
struct I8Tile {
  static constexpr int NTHR = 128 * NWG, BM = 64 * NWG;
  // stages deep enough to keep a decode grid's weight bytes streaming;
  // NWG = 1 blocks share an SM two to five at a time
  static constexpr int STAGES = BT == 256   ? 5
                                : BT == 192 ? 6
                                : NWG == 2 || BT <= 32 ? 8
                                : BT == 64             ? 6
                                                       : 5;
  static constexpr size_t X_TILE = size_t(BT) * kBK * 2;  // bf16 tokens
  static constexpr size_t W_TILE = size_t(BM) * kBK;      // int8 staging
  static constexpr size_t STAGE = X_TILE + W_TILE;
  // the ring, and 1024 bytes to align it for the swizzle
  static constexpr size_t SMEM = 1024 + STAGES * STAGE;
  static constexpr int LDC = BM + 4;  // the epilogue's fp32 Cᵀ row stride
  static_assert(SMEM <= 232448, "shared memory");
  static_assert(size_t(BT) * LDC * 4 <= STAGES * STAGE,
                "the epilogue tile fits in the ring");
};

// two int8 (the low bytes of the 16-bit lanes of p) -> bf16x2, exactly:
// with b a byte, (0x4300 | (b & 0x7F)) is the bf16 128 + (b & 127) and
// (0x4300 | (b & 0x80)) the bf16 128 or 256 by its sign bit, so their
// difference is the two's-complement value q (exact: |q| <= 128)
__device__ __forceinline__ uint32_t i8x2_to_bf16(uint32_t p) {
  const uint32_t m = (p & 0x007F007Fu) | 0x43004300u;
  const uint32_t s = (p & 0x00800080u) | 0x43004300u;
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(m), "r"(s));
  return d;
}

// four int8 (one word, b0 lowest) -> bf16x2 (b0, b1) and (b2, b3)
__device__ __forceinline__ void i8x4_to_bf16(uint32_t v, uint32_t& lo,
                                             uint32_t& hi) {
  lo = i8x2_to_bf16(__byte_perm(v, 0u, 0x4140u));
  hi = i8x2_to_bf16(__byte_perm(v, 0u, 0x4342u));
}

// mbarrier and TMA (cp.async.bulk.tensor) primitives: a stage's barrier
// is armed with the bytes its two copies bring and completes when they
// have landed
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
      wg::smem_u32(bar)));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          wg::smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(wg::smem_u32(bar)),
      "r"(phase)
      : "memory");
}

// the box of `map` at (c0 innermost, c1) into shared `dst`, completing on
// `bar`; parts outside the tensor arrive as zeros
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(wg::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(wg::smem_u32(bar))
      : "memory");
}


// byte offset of 16-byte chunk c (of four) of int8 row r in a staged
// tile: rows of 64 bytes, the chunk swizzled by bits 1-2 of the row (the
// TMA copy's 64-byte swizzle), so the fragment loads of a warp's eight
// rows fall in distinct banks
__device__ __forceinline__ int i8_offset(int r, int c) {
  return 64 * r + 16 * (c ^ ((r >> 1) & 3));
}

// the step's loads into stage `st` by every thread (no TMA: x or w not
// 16-byte aligned, or K % 16 != 0): the x tile (tokens [t0, T), depth
// [k0, kend)) and two int8 chunks of rows [n0, N) a thread at the same
// depth, value by value; zero outside
template <int NWG, int BT>
__device__ __forceinline__ void load_stage(unsigned char* st,
                                           const I8Args& a, int n0, int t0,
                                           int k0, int kend) {
  using L = I8Tile<NWG, BT>;
  wg::load_tile_ld<__nv_bfloat16, BT, kBK, L::NTHR>(
      st, a.x + size_t(t0) * a.K + k0, a.K, a.T - t0, kend - k0, false);
  unsigned char* sw = st + L::X_TILE;
  const int rows = a.N - n0, cols = kend - k0;
  const int8_t* src = a.w + size_t(n0) * a.K + k0;
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int i = threadIdx.x + L::NTHR * it, r = i / 4, c = i % 4;
    alignas(16) int8_t v[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int k = c * 16 + e;
      v[e] = (r < rows && k < cols) ? src[size_t(r) * a.K + k] : 0;
    }
    *reinterpret_cast<uint4*>(sw + i8_offset(r, c)) =
        *reinterpret_cast<uint4*>(v);
  }
}

// TMA (x and w 16-byte aligned, K % 16 == 0): thread 0 fills each stage
// with two tensor copies completing on the stage's mbarrier; else every
// thread loads its share (`load_stage`)
template <int NWG, int BT, bool TMA>
__global__ void __launch_bounds__(128 * NWG, 1)
    int8_mm_wg_kernel(const __grid_constant__ I8Args a) {
  using L = I8Tile<NWG, BT>;
  constexpr int BM = L::BM, STAGES = L::STAGES;
  extern __shared__ __align__(1024) unsigned char i8_smem[];
  __shared__ __align__(8) uint64_t full[STAGES];  // TMA: the stage landed
  const uint32_t s0 = wg::smem_u32(i8_smem);
  unsigned char* ring = i8_smem + (((s0 + 1023u) & ~1023u) - s0);
  // the block's output tile (numbered along N first) and K slice: a
  // tile's `splits` blocks are adjacent
  const int tile = blockIdx.x / a.splits, z = blockIdx.x % a.splits;
  const int tiles_n = (a.N + BM - 1) / BM;
  const int n0 = (tile % tiles_n) * BM, t0 = (tile / tiles_n) * BT;
  const int kbeg = z * a.kc, kend = min(a.K, kbeg + a.kc);
  const int KT = (kend - kbeg + kBK - 1) / kBK;  // at least 1
  if constexpr (TMA) {
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&a.tx))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&a.tw))
                   : "memory");
      for (int s = 0; s < STAGES; ++s) mbar_init(&full[s]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  // step k into its stage (k % STAGES)
  const auto fill = [&](int k) {
    unsigned char* st = ring + (k % STAGES) * L::STAGE;
    if constexpr (TMA) {
      if (threadIdx.x == 0) {
        uint64_t* bar = &full[k % STAGES];
        mbar_expect_tx(bar, static_cast<uint32_t>(L::STAGE));
        tma_2d(st, &a.tx, kbeg + k * kBK, t0, bar);
        tma_2d(st + L::X_TILE, &a.tw, kbeg + k * kBK, n0, bar);
      }
    } else {
      load_stage<NWG, BT>(st, a, n0, t0, kbeg + k * kBK, kend);
    }
  };
  // this thread's rows of the A fragments (its warp's 16: r0 and r0 + 8,
  // one swizzle) and the byte pair of each it takes (q = lane % 4)
  const int lane = threadIdx.x % 32, q = lane % 4;
  const int r0 = 16 * (threadIdx.x / 32) + lane / 4;
  const uint32_t pick = (q & 1) ? 0x7632u : 0x5410u;
  // step k's A fragments once the stage has landed: for each k16 step and
  // row, the int8 at depth 2q, 2q + 1 and 2q + 8, 2q + 9 (two 4-byte loads
  // and a byte permute), converted to bf16 in registers
  const auto frag = [&](int k, uint32_t (&f)[16]) {
    if constexpr (TMA) {
      mbar_wait(&full[k % STAGES], (k / STAGES) & 1);
    } else {
      wg::fence_async_smem();  // the x tile, for the products
      __syncthreads();         // every thread's loads of step k
    }
    const unsigned char* sw = ring + (k % STAGES) * L::STAGE + L::X_TILE;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned char* p =
            sw + i8_offset(r0 + 8 * h, kk) + 4 * (q >> 1);
        const uint32_t v =
            __byte_perm(*reinterpret_cast<const uint32_t*>(p),
                        *reinterpret_cast<const uint32_t*>(p + 8), pick);
        i8x4_to_bf16(v, f[4 * kk + h], f[4 * kk + 2 + h]);
      }
  };
  // the x tile's descriptor in stage 0; another stage or k16 step is an
  // offset in 16-byte units
  const uint64_t dx0 = wg::desc_k(ring, BT, 0, 0);

  float acc[BT / 2];
  // step k's products on fragments `cur`; then, once step k - 1's are done,
  // step k + 1's fragments into `nxt` (which those products read)
  const auto step = [&](int k, uint32_t (&cur)[16], uint32_t (&nxt)[16]) {
    // every product of step k - 2 is done and its fragments were loaded
    // long ago: its stage is refilled
    __syncthreads();
    if (k + STAGES - 2 < KT) fill(k + STAGES - 2);
    const uint64_t dx = dx0 + (k % STAGES) * (L::STAGE >> 4);
    wg::keep(acc);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t f[4] = {cur[4 * kk], cur[4 * kk + 1], cur[4 * kk + 2],
                             cur[4 * kk + 3]};
      wg::mma_rs<__nv_bfloat16, BT, 0>(acc, f, dx + 2 * kk,
                                       !(k == 0 && kk == 0));
    }
    wg::commit();
    wg::wait<1>();
    wg::keep(acc);
    wg::keep(nxt);
    if (k + 1 < KT) frag(k + 1, nxt);
  };

  uint32_t fa[16], fb[16];
  for (int s = 0; s < STAGES - 2 && s < KT; ++s) fill(s);
  frag(0, fa);
  for (int kt = 0; kt < KT; kt += 2) {
    step(kt, fa, fb);
    if (kt + 1 < KT) step(kt + 1, fb, fa);
  }
  wg::wait<0>();
  wg::keep(acc);
  const int rows = min(BT, a.T - t0), cols = min(BM, a.N - n0);
  const auto al16 = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const bool v4 = a.N % 4 == 0 && al16(a.out) && al16(a.scale);
  // f(t, c, n): the four columns c..c+3 of token row t, n of them inside
  const auto tile_quads = [&](auto f) {
    for (int i = threadIdx.x; i < BT * (BM / 4); i += L::NTHR) {
      const int t = i / (BM / 4), c = 4 * (i % (BM / 4));
      if (t < rows && c < cols) f(t, c, min(4, cols - c));
    }
  };
  // y's four columns c..c+3 of token row t (n inside): v times the scale
  const auto put = [&](int t, int c, int n, float4 v) {
    float* dst = a.out + size_t(t0 + t) * a.N + n0 + c;
    const float* sc = a.scale + n0 + c;
    if (v4 && n == 4) {
      const float4 s4 = *reinterpret_cast<const float4*>(sc);
      *reinterpret_cast<float4*>(dst) =
          make_float4(v.x * s4.x, v.y * s4.y, v.z * s4.z, v.w * s4.w);
    } else {
      const float e[4] = {v.x, v.y, v.z, v.w};
      for (int k = 0; k < n; ++k) dst[k] = e[k] * sc[k];
    }
  };
  // f(t, n, v): this thread's accumulators, Cᵀ's (weight row n, token t)
  const auto each_acc = [&](auto f) {
#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          f(2 * q + 8 * j + e, r0 + 8 * hh, acc[4 * j + 2 * hh + e]);
  };
  if (a.splits == 1) {
    // Cᵀ -> shared ct[t][n] (row stride LDC: the 32 lanes of a store hit
    // 32 banks), then y's rows as float4s
    __syncthreads();
    float* ct = reinterpret_cast<float*>(ring);
    each_acc([&](int t, int n, float v) { ct[t * L::LDC + n] = v; });
    __syncthreads();
    tile_quads([&](int t, int c, int n) {
      put(t, c, n, *reinterpret_cast<const float4*>(ct + t * L::LDC + c));
    });
    return;
  }
  // this slice's BT x BM partial sums (tile-local rows of BM, from the
  // registers: 32-byte runs), a ticket, and the tile's last block adds
  // the slices in order
  constexpr int TILE = BT * BM;
  const float* tile_part = a.part + size_t(tile) * a.splits * TILE;
  float* mine = a.part + (size_t(tile) * a.splits + z) * TILE;
  each_acc([&](int t, int n, float v) { mine[t * BM + n] = v; });
  // the block's partial stores precede thread 0's ticket, which releases
  // them to the tile's last block and, there, acquires the others'
  __syncthreads();
  __shared__ int last;
  if (threadIdx.x == 0) {
    int prev;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(prev)
                 : "l"(a.counters + tile)
                 : "memory");
    last = prev == a.splits - 1;
    if (last) a.counters[tile] = 0;  // every slice has taken its ticket
  }
  __syncthreads();
  if (!last) return;
  tile_quads([&](int t, int c, int n) {
    // the slices' loads four at a time in flight, added in split order
    const auto at = [&](int zz) {
      return __ldcg(reinterpret_cast<const float4*>(tile_part + zz * TILE +
                                                    t * BM + c));
    };
    float4 s = at(0);
    int zz = 1;
    for (; zz + 4 <= a.splits; zz += 4) {
      const float4 p[4] = {at(zz), at(zz + 1), at(zz + 2), at(zz + 3)};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s.x += p[k].x; s.y += p[k].y; s.z += p[k].z; s.w += p[k].w;
      }
    }
    for (; zz < a.splits; ++zz) {
      const float4 p = at(zz);
      s.x += p.x; s.y += p.y; s.z += p.z; s.w += p.w;
    }
    put(t, c, n, s);
  });
}

// the TMA descriptors of x (T x K bf16, boxes of BT x 64, 128B-swizzled:
// the wgmma tile as it lies in shared memory) and w (N x K bytes, boxes
// of BM x 64, 64B-swizzled: `i8_offset`), by the driver's encoder, looked
// up once
int encode_maps(I8Args& a, int bm, int bt) {
  static PFN_cuTensorMapEncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorNotSupported);
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(fn);
  }
  const cuuint32_t one[2] = {1, 1};
  const cuuint64_t xdim[2] = {cuuint64_t(a.K), cuuint64_t(a.T)};
  const cuuint64_t xstride[1] = {cuuint64_t(a.K) * 2};
  const cuuint32_t xbox[2] = {kBK, cuuint32_t(bt)};
  CUresult r = encode(&a.tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                      const_cast<__nv_bfloat16*>(a.x), xdim, xstride, xbox,
                      one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t wdim[2] = {cuuint64_t(a.K), cuuint64_t(a.N)};
  const cuuint64_t wstride[1] = {cuuint64_t(a.K)};
  const cuuint32_t wbox[2] = {kBK, cuuint32_t(bm)};
  r = encode(&a.tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
             const_cast<int8_t*>(a.w), wdim, wstride, wbox, one,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int NWG, int BT, bool TMA>
int launch_tile(I8Args& a, cudaStream_t st) {
  using L = I8Tile<NWG, BT>;
  static bool attr_set = false;
  auto kern = int8_mm_wg_kernel<NWG, BT, TMA>;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::SMEM));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int tiles = ((a.N + L::BM - 1) / L::BM) * ((a.T + BT - 1) / BT);
  if (a.splits > 1 && tiles > kMaxTiles)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (TMA) {
    const int e = encode_maps(a, L::BM, BT);
    if (e != 0) return e;
  }
  note_launch(kern, L::SMEM, L::NTHR);
  kern<<<tiles * a.splits, L::NTHR, L::SMEM, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int NWG, int BT>
int launch(I8Args& a, cudaStream_t st) {
  return a.vec ? launch_tile<NWG, BT, true>(a, st)
               : launch_tile<NWG, BT, false>(a, st);
}

}  // namespace

// x (T, K) bf16, w (N, K) int8, scale (N,) fp32, out (T, N) fp32, all
// contiguous. The tile: bm weight rows (64 or 128) x bt tokens (8, 16, 32,
// 64 or 128 with bm 64; 128, 192 or 256 with bm 128). splits > 1 (at most
// 16):
// each tile's K is cut into `splits` slices of kc (a multiple of 64), part
// holds tiles x splits x bt x bm fp32 partial sums (16-byte aligned) and
// counters one int a tile, all 0 (at most 1024 tiles; the kernel leaves
// them 0). vec: K % 16 == 0 and x, w 16-byte aligned.
extern "C" int apex1_int8_mm(const void* x, const void* w, const void* scale,
                             void* out, void* part, void* counters, int T,
                             int N, int K, int splits, int kc, int bm, int bt,
                             int vec, void* stream) {
  if (T <= 0 || N <= 0) return 0;
  if (K <= 0 || splits < 1 || splits > kMaxSplits ||
      (splits > 1 &&
       (kc <= 0 || kc % kBK != 0 ||
        (splits - 1) * static_cast<long long>(kc) >= K || part == nullptr ||
        counters == nullptr || reinterpret_cast<uintptr_t>(part) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  I8Args a{};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.scale = static_cast<const float*>(scale);
  a.out = static_cast<float*>(out);
  a.part = static_cast<float*>(part);
  a.counters = static_cast<int*>(counters);
  a.T = T;
  a.N = N;
  a.K = K;
  a.kc = splits > 1 ? kc : K;
  a.splits = splits;
  a.vec = vec != 0;
  cudaStream_t st = as_stream(stream);
  if (bm == 128 && bt == 128) return launch<2, 128>(a, st);
  if (bm == 128 && bt == 192) return launch<2, 192>(a, st);
  if (bm == 128 && bt == 256) return launch<2, 256>(a, st);
  if (bm != 64) return static_cast<int>(cudaErrorInvalidValue);
  switch (bt) {
    case 8:
      return launch<1, 8>(a, st);
    case 16:
      return launch<1, 16>(a, st);
    case 32:
      return launch<1, 32>(a, st);
    case 64:
      return launch<1, 64>(a, st);
    case 128:
      return launch<1, 128>(a, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
