// Hopper (sm_90a) building blocks of the flash kernels' bf16/fp16 forward
// and dk/dv (flash_wg.cuh) and of the tiled product (gemm_wg.cuh): shared
// tiles in the 128-byte-swizzled layout that wgmma's matrix descriptors
// name, filled by cp.async; and wgmma m64nNk16 (N = 64, 128, 256) with
// fp32 accumulators in registers, B from shared memory and A from shared
// memory or from registers, either operand K-major or MN-major.
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

// d (64 x 64, fp32) = (acc ? d : 0) + A·B: A (64 x 16) and B (16 x 64)
// K-major in shared memory, named by the descriptors da and db
template <typename T>
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int acc) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(acc));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(acc));
  }
}

// d (64 x 64, fp32) = (acc ? d : 0) + A·B: A (64 x 16) in registers (the
// m64k16 fragment `a`), B (16 x 64) MN-major in shared memory (db)
template <typename T>
__device__ __forceinline__ void mma_rs_n64_t(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int acc) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  }
}


// MN-major operand spanning every 64-wide block of the R-row swizzled tile
// at `tile` (an N = 128 or 256 product): depth rows [16·t, 16·t + 16)
__device__ __forceinline__ uint64_t desc_mn_wide(const void* tile, int R,
                                                 int t) {
  return desc(smem_u32(tile) + t * 2048, R * 128, 1024);
}

#define WG_REGS_128 \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63"

#define WG_ACC_128(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
  "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
  "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define WG_REGS_256 \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, " \
  "%88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, " \
  "%104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, " \
  "%120, %121, %122, %123, %124, %125, %126, %127"

#define WG_ACC_256(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
  "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
  "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
  "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), \
  "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
  "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), \
  "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
  "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
  "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
  "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), \
  "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
  "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
  "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
  "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), \
  "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
  "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), \
  "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
  "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), \
  "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

#define WG_SS_ASM(N, TY, REGS, DA, DB, ACC, TA, TB)                        \
  "{\n.reg .pred p;\nsetp.ne.b32 p, " ACC ", 0;\n"                         \
  "wgmma.mma_async.sync.aligned.m64n" N "k16.f32." TY "." TY " {" REGS    \
  "}, " DA ", " DB ", p, 1, 1, " TA ", " TB ";\n}\n"

// d (64 x N, fp32, N = 128 or 256) = (acc ? d : 0) + A·B: A (64 x 16) and
// B (16 x N) in shared memory, named by the descriptors da and db; TA, TB
// 1 where that operand is MN-major (wgmma's transpose bits), else 0
template <typename T, int N, int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da,
                                       uint64_t db, int acc) {
  static_assert(N == 128 || N == 256, "m64n128 or m64n256");
  constexpr bool F16 = std::is_same<T, __half>::value;
  if constexpr (N == 128 && F16) {
    asm volatile(WG_SS_ASM("128", "f16", WG_REGS_128, "%64", "%65", "%66",
                           "%67", "%68")
                 : WG_ACC_128(d)
                 : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  } else if constexpr (N == 128) {
    asm volatile(WG_SS_ASM("128", "bf16", WG_REGS_128, "%64", "%65", "%66",
                           "%67", "%68")
                 : WG_ACC_128(d)
                 : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  } else if constexpr (F16) {
    asm volatile(WG_SS_ASM("256", "f16", WG_REGS_256, "%128", "%129",
                           "%130", "%131", "%132")
                 : WG_ACC_256(d)
                 : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  } else {
    asm volatile(WG_SS_ASM("256", "bf16", WG_REGS_256, "%128", "%129",
                           "%130", "%131", "%132")
                 : WG_ACC_256(d)
                 : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
}

#undef WG_SS_ASM
#undef WG_REGS_128
#undef WG_REGS_256
#undef WG_ACC_128
#undef WG_ACC_256

}  // namespace wg
