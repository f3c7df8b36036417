// Hopper (sm_90a) building blocks of the flash kernels' bf16/fp16 forward
// and dk/dv (flash_wg.cuh), of the tiled product (gemm_wg.cuh) and of the
// int8 weight-only product (int8_matmul.cu): shared tiles in the
// 128-byte-swizzled layout that wgmma's matrix descriptors name, filled by
// cp.async; and wgmma m64nNk16 (N = 8 to 256) with fp32 accumulators in
// registers, B from shared memory and A from shared memory or from
// registers, either operand K-major or MN-major.
//
// A tile of R rows of DP 16-bit values (DP a multiple of 64) is stored as
// DP / 64 blocks of R rows of 128 bytes (64 values); within a block, row r
// sits at r·128 and its 16-byte chunk c at chunk c ^ (r % 8): the 128B
// swizzle, which the hardware applies to address bits [4, 7) ^ [7, 10).
// Tiles therefore start 1024-byte aligned. Read along its rows (K-major:
// the product's depth runs along a row) a block is the canonical K-major
// SW128 layout: 8-row groups 1024 bytes apart (SBO), a k16 step 32 bytes
// along the row. Read across its rows (MN-major: the depth runs down the
// rows, as V in P·V) it is the canonical MN-major SW128 layout: 64 values
// along N a block, 8-row depth groups 1024 bytes apart (SBO), 64-wide
// blocks R·128 bytes apart (LBO, named where one product spans several
// blocks). A transposed (M-major) A operand is read the same way: wgmma's
// transpose bit takes it for 16-bit types.
#pragma once

#include "mma.cuh"

#include <type_traits>

namespace wg {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c of row r in a swizzled tile of R rows
__device__ __forceinline__ uint32_t sw_offset(int R, int r, int c) {
  return static_cast<uint32_t>((c >> 3) * R * 128 + r * 128 +
                               (((c & 7) ^ (r & 7)) << 4));
}

// this thread's shared-memory writes (its finished cp.async copies and its
// stores) become visible to wgmma's reads (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [0, rows) of a device tile (D values a row, row stride D) into the
// swizzled tile of R x DP at `dst`, by NTHR threads; rows past `rows` and
// values past D become zero. vec (D == DP, 16-byte aligned rows): 16-byte
// cp.async (mma.cuh), the zero rows through its src-size 0; else plain
// loads and 16-byte shared stores.
template <typename T, int R, int DP, int NTHR>
__device__ __forceinline__ void load_tile(unsigned char* dst, const T* src,
                                          int rows, int D, bool vec) {
  constexpr int CPR = DP / 8, N = R * CPR;
  static_assert(N % NTHR == 0, "loader geometry");
  if (vec) {
#pragma unroll
    for (int it = 0; it < N / NTHR; ++it) {
      const int i = threadIdx.x + it * NTHR, r = i / CPR, c = i % CPR;
      const bool in = r < rows;
      cp_async16(dst + sw_offset(R, r, c),
                 in ? src + static_cast<size_t>(r) * DP + c * 8 : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < N; i += NTHR) {
      const int r = i / CPR, c = i % CPR;
      alignas(16) T v[8];
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int e = c * 8 + x;
        v[x] = (r < rows && e < D) ? src[static_cast<size_t>(r) * D + e]
                                   : from_f32<T>(0.f);
      }
      *reinterpret_cast<uint4*>(dst + sw_offset(R, r, c)) =
          *reinterpret_cast<uint4*>(v);
    }
  }
}

// Rows [0, rows) and columns [0, cols) of an fp32 device tile (row stride
// ld) into the R x C tile at `dst` (row stride LD floats), by NTHR
// threads; the rest zero. vec (cols and ld multiples of 4, 16-byte aligned
// rows): 16-byte cp.async; else plain loads and stores.
template <int R, int C, int LD, int NTHR>
__device__ __forceinline__ void load_f32_tile(float* dst, const float* src,
                                              int rows, int cols,
                                              long long ld, bool vec) {
  constexpr int CPR = C / 4, N = R * CPR;
  static_assert(N % NTHR == 0 && LD % 4 == 0, "loader geometry");
  if (vec) {
#pragma unroll 4
    for (int it = 0; it < N / NTHR; ++it) {
      const int i = threadIdx.x + it * NTHR, r = i / CPR, c = (i % CPR) * 4;
      const bool in = r < rows && c < cols;
      cp_async16(dst + r * LD + c, in ? src + r * ld + c : src, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < R * C; i += NTHR) {
      const int r = i / C, c = i % C;
      dst[r * LD + c] = (r < rows && c < cols) ? src[r * ld + c] : 0.f;
    }
  }
}

// A wgmma matrix descriptor with the 128B swizzle: shared byte address,
// leading and stride byte offsets (each a multiple of 16)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// K-major operand: k16 step kk of the R-row swizzled tile at `tile`,
// starting at its row r0 (a multiple of 8)
__device__ __forceinline__ uint64_t desc_k(const void* tile, int R, int r0,
                                           int kk) {
  return desc(smem_u32(tile) + (kk >> 2) * R * 128 + r0 * 128 + (kk & 3) * 32,
              16, 1024);
}

// MN-major operand: depth rows [16·t, 16·t + 16) of the 64-wide block n of
// the R-row swizzled tile at `tile`
__device__ __forceinline__ uint64_t desc_mn(const void* tile, int R, int n,
                                            int t) {
  return desc(smem_u32(tile) + n * R * 128 + t * 2048, 1024, 1024);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Registers an asynchronous wgmma reads or writes: after wait(), `keep`
// makes every later use depend on them, so the compiler neither hoists a
// read of an accumulator above the wait nor reuses an A register early.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// two fp32 values as a packed pair of T (the low half the first)
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  } else {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
}

// MN-major operand spanning every 64-wide block of the R-row swizzled tile
// at `tile` (an N = 64, 128 or 256 product): depth rows [16·t, 16·t + 16)
__device__ __forceinline__ uint64_t desc_mn_wide(const void* tile, int R,
                                                 int t) {
  return desc(smem_u32(tile) + t * 2048, R * 128, 1024);
}

// The accumulator lists of an m64nN product (N / 2 registers a thread)
#define WG_REGS_8 "%0, %1, %2, %3"
#define WG_REGS_16 WG_REGS_8 ", %4, %5, %6, %7"
#define WG_REGS_32 WG_REGS_16 \
  ", %8, %9, %10, %11, %12, %13, %14, %15"
#define WG_REGS_64 WG_REGS_32 \
  ", %16, %17, %18, %19, %20, %21, %22, %23" \
  ", %24, %25, %26, %27, %28, %29, %30, %31"
#define WG_REGS_128 WG_REGS_64 \
  ", %32, %33, %34, %35, %36, %37, %38, %39" \
  ", %40, %41, %42, %43, %44, %45, %46, %47" \
  ", %48, %49, %50, %51, %52, %53, %54, %55" \
  ", %56, %57, %58, %59, %60, %61, %62, %63"
#define WG_REGS_192 WG_REGS_128 \
  ", %64, %65, %66, %67, %68, %69, %70, %71" \
  ", %72, %73, %74, %75, %76, %77, %78, %79" \
  ", %80, %81, %82, %83, %84, %85, %86, %87" \
  ", %88, %89, %90, %91, %92, %93, %94, %95"
#define WG_REGS_256 WG_REGS_128 \
  ", %64, %65, %66, %67, %68, %69, %70, %71" \
  ", %72, %73, %74, %75, %76, %77, %78, %79" \
  ", %80, %81, %82, %83, %84, %85, %86, %87" \
  ", %88, %89, %90, %91, %92, %93, %94, %95" \
  ", %96, %97, %98, %99, %100, %101, %102, %103" \
  ", %104, %105, %106, %107, %108, %109, %110, %111" \
  ", %112, %113, %114, %115, %116, %117, %118, %119" \
  ", %120, %121, %122, %123, %124, %125, %126, %127"

#define WG_ACC4(d, i) \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_ACC_8(d) WG_ACC4(d, 0)
#define WG_ACC_16(d) WG_ACC_8(d), WG_ACC4(d, 4)
#define WG_ACC_32(d) WG_ACC_16(d), \
  WG_ACC4(d, 8), WG_ACC4(d, 12)
#define WG_ACC_64(d) WG_ACC_32(d), \
  WG_ACC4(d, 16), WG_ACC4(d, 20), WG_ACC4(d, 24), WG_ACC4(d, 28)
#define WG_ACC_128(d) WG_ACC_64(d), \
  WG_ACC4(d, 32), WG_ACC4(d, 36), WG_ACC4(d, 40), WG_ACC4(d, 44), \
  WG_ACC4(d, 48), WG_ACC4(d, 52), WG_ACC4(d, 56), WG_ACC4(d, 60)
#define WG_ACC_192(d) WG_ACC_128(d), \
  WG_ACC4(d, 64), WG_ACC4(d, 68), WG_ACC4(d, 72), WG_ACC4(d, 76), \
  WG_ACC4(d, 80), WG_ACC4(d, 84), WG_ACC4(d, 88), WG_ACC4(d, 92)
#define WG_ACC_256(d) WG_ACC_128(d), \
  WG_ACC4(d, 64), WG_ACC4(d, 68), WG_ACC4(d, 72), WG_ACC4(d, 76), \
  WG_ACC4(d, 80), WG_ACC4(d, 84), WG_ACC4(d, 88), WG_ACC4(d, 92), \
  WG_ACC4(d, 96), WG_ACC4(d, 100), WG_ACC4(d, 104), WG_ACC4(d, 108), \
  WG_ACC4(d, 112), WG_ACC4(d, 116), WG_ACC4(d, 120), WG_ACC4(d, 124)

#define WG_SS_ASM(N, TY, REGS, DA, DB, ACC, TA, TB)                        \
  "{\n.reg .pred p;\nsetp.ne.b32 p, " ACC ", 0;\n"                         \
  "wgmma.mma_async.sync.aligned.m64n" N "k16.f32." TY "." TY " {" REGS    \
  "}, " DA ", " DB ", p, 1, 1, " TA ", " TB ";\n}\n"

// one m64nNN case of mma_ss: the accumulators, then the operands from
// index A0 on (the descriptors, acc, the transpose bits)
#define WG_SS(NN, REGS, ACCS, A0, A1, A2, A3, A4)                          \
  if constexpr (N == NN) {                                                 \
    if constexpr (F16)                                                     \
      asm volatile(WG_SS_ASM(#NN, "f16", REGS, A0, A1, A2, A3, A4)         \
                   : ACCS(d)                                               \
                   : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));        \
    else                                                                   \
      asm volatile(WG_SS_ASM(#NN, "bf16", REGS, A0, A1, A2, A3, A4)        \
                   : ACCS(d)                                               \
                   : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));        \
  }

// d (64 x N, fp32, N = 64, 128 or 256) = (acc ? d : 0) + A·B: A (64 x 16)
// and B (16 x N) in shared memory, named by the descriptors da and db; TA,
// TB 1 where that operand is MN-major (wgmma's transpose bits), else 0
template <typename T, int N, int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da,
                                       uint64_t db, int acc) {
  static_assert(N == 64 || N == 128 || N == 256,
                "m64n64, m64n128 or m64n256 products");
  constexpr bool F16 = std::is_same<T, __half>::value;
  WG_SS(64, WG_REGS_64, WG_ACC_64, "%32", "%33", "%34", "%35", "%36")
  WG_SS(128, WG_REGS_128, WG_ACC_128, "%64", "%65", "%66", "%67", "%68")
  WG_SS(256, WG_REGS_256, WG_ACC_256, "%128", "%129", "%130", "%131",
        "%132")
}

#define WG_RS_ASM(N, TY, REGS, A0, A1, A2, A3, DB, ACC, TB)                \
  "{\n.reg .pred p;\nsetp.ne.b32 p, " ACC ", 0;\n"                         \
  "wgmma.mma_async.sync.aligned.m64n" N "k16.f32." TY "." TY " {" REGS    \
  "}, {" A0 ", " A1 ", " A2 ", " A3 "}, " DB ", p, 1, 1, " TB ";\n}\n"

// one m64nNN case of mma_rs: the accumulators, then the operands from
// index A0 on (the A fragment, the B descriptor, acc, B's transpose bit)
#define WG_RS(NN, REGS, ACCS, A0, A1, A2, A3, A4, A5, A6)                  \
  if constexpr (N == NN) {                                                 \
    if constexpr (F16)                                                     \
      asm volatile(WG_RS_ASM(#NN, "f16", REGS, A0, A1, A2, A3, A4, A5, A6) \
                   : ACCS(d)                                               \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),  \
                     "r"(acc), "n"(TB));                                   \
    else                                                                   \
      asm volatile(WG_RS_ASM(#NN, "bf16", REGS, A0, A1, A2, A3, A4, A5,    \
                             A6)                                           \
                   : ACCS(d)                                               \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),  \
                     "r"(acc), "n"(TB));                                   \
  }

// d (64 x N, fp32, N = 8 to 256, 192 included) = (acc ? d : 0) + A·B:
// A (64 x 16) in
// registers (this thread's m64k16 fragment `a`: rows r and r + 8 of its
// warp's 16, depth 2q, 2q + 1 and 2q + 8, 2q + 9, q = lane % 4), B
// (16 x N) in shared memory (db); TB 1 where B is MN-major, else 0. `a`
// is read asynchronously: keep it until the product's wait.
template <typename T, int N, int TB>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db,
                                       int acc) {
  static_assert(N == 8 || N == 16 || N == 32 || N == 64 || N == 128 ||
                    N == 192 || N == 256,
                "m64nN products for N in 8, 16, 32, 64, 128, 192, 256");
  constexpr bool F16 = std::is_same<T, __half>::value;
  WG_RS(8, WG_REGS_8, WG_ACC_8, "%4", "%5", "%6", "%7", "%8", "%9", "%10")
  WG_RS(16, WG_REGS_16, WG_ACC_16, "%8", "%9", "%10", "%11", "%12", "%13",
        "%14")
  WG_RS(32, WG_REGS_32, WG_ACC_32, "%16", "%17", "%18", "%19", "%20", "%21",
        "%22")
  WG_RS(64, WG_REGS_64, WG_ACC_64, "%32", "%33", "%34", "%35", "%36", "%37",
        "%38")
  WG_RS(128, WG_REGS_128, WG_ACC_128, "%64", "%65", "%66", "%67", "%68",
        "%69", "%70")
  WG_RS(192, WG_REGS_192, WG_ACC_192, "%96", "%97", "%98", "%99", "%100",
        "%101", "%102")
  WG_RS(256, WG_REGS_256, WG_ACC_256, "%128", "%129", "%130", "%131",
        "%132", "%133", "%134")
}

#undef WG_RS
#undef WG_RS_ASM
#undef WG_SS
#undef WG_SS_ASM
#undef WG_REGS_8
#undef WG_REGS_16
#undef WG_REGS_32
#undef WG_REGS_64
#undef WG_REGS_128
#undef WG_REGS_192
#undef WG_REGS_256
#undef WG_ACC4
#undef WG_ACC_8
#undef WG_ACC_16
#undef WG_ACC_32
#undef WG_ACC_64
#undef WG_ACC_128
#undef WG_ACC_192
#undef WG_ACC_256

}  // namespace wg
