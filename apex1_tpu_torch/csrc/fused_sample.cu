// Fused counter-keyed sampling epilogue for Hopper (sm_90a).
//
// Replaces: apex1_tpu/ops/paged_decode.py::_fused_sample_kernel
// (launched by fused_sample), the Pallas TPU kernel that turns (R, V)
// f32 logits into token ids: vocab mask, temperature, a threefry-2x32
// gumbel draw keyed on fold_in(key(seed), pos), and an exact
// (max, first-index) argmax folded across vocab blocks.
//
// Bound on the H100: at temperature 0 memory (each logit is read once);
// when sampling, the integer pipes: every vocab entry costs one 20-round
// threefry-2x32 block (about 80 integer operations, which Hopper runs
// at half its fp32 rate) and two precise logf, against 4 bytes read.
//
// Design: the vocab is split over the grid, as the TPU kernel splits it
// into blocks. Block (split, row) takes the columns [split·per,
// (split + 1)·per) of one row (ops/paged_decode.py::sample_splits picks
// the split from R, V and the SM count: two blocks an SM or more, spread
// evenly over the SMs), reads
// them as 16-byte loads where the row allows it, and computes per entry
// the vocab mask, the temperature divide, the uint32 draw of either
// threefry stream (partitionable: counter (0, col), output y0 ^ y1;
// original: the iota split in halves, each lane recomputing its
// half-pair partner) and the gumbel transform. Every thread derives the
// row's key itself (key(seed) is (0, seed); fold_in hashes (0, pos)
// under it: one threefry block, cheaper than a broadcast). Each thread
// keeps its first maximum; a warp shuffle and a shared-memory fold keep
// the block's (max, lowest index) pair. With more than one split each
// block writes its pair to a (rows, splits) workspace and takes a ticket
// from its row's counter; the row's last block folds the pairs and
// writes the id, then zeroes the counter for the next launch (or CUDA
// graph replay). The fold is exact and its result does not depend on
// the order (the largest value, the lowest index among equals), so ties
// resolve to the first index exactly as argmax does, whatever the split,
// and every launch gives the same id. The float steps use _rn intrinsics
// and precise logf (no fast math, no contraction into FMA), so the noise
// equals the plain PyTorch version on the card bit for bit. top_k stays
// outside: its sort runs before the kernel, which then sees
// already-scaled logits (scale_in_kernel = 0).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 65535;  // grid rows a launch: gridDim.y's limit
constexpr float kNegInf = -1e30f;
constexpr float kTiny = 1.17549435e-38f;  // np.finfo(np.float32).tiny

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// the 20-round threefry-2x32 block, op for op as jax's threefry2x32
__device__ __forceinline__ void threefry2x32(uint32_t k1, uint32_t k2,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  constexpr int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

__device__ __forceinline__ uint32_t uniform_bits(uint32_t k1, uint32_t k2,
                                                 uint32_t col, uint32_t n,
                                                 bool partitionable) {
  if (partitionable) {
    uint32_t x0 = 0u, x1 = col;
    threefry2x32(k1, k2, x0, x1);
    return x0 ^ x1;
  }
  const uint32_t odd = n & 1u;
  const uint32_t h = (n + odd) / 2u;
  const bool lo = col < h;
  const uint32_t a = lo ? col : col - h;
  uint32_t b = a + h;
  if (odd && b == n) b = 0u;  // the zero pad of an odd count
  uint32_t x0 = a, x1 = b;
  threefry2x32(k1, k2, x0, x1);
  return lo ? x0 : x1;
}

__device__ __forceinline__ float bits_to_gumbel(uint32_t bits) {
  float u = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  u = __fadd_rn(__fmul_rn(u, 1.0f - kTiny), kTiny);
  u = fmaxf(kTiny, u);
  return -logf(-logf(u));
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// the (max, lowest index) pair of a warp, in every lane
__device__ __forceinline__ void warp_best(float& bv, int& bi) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
}

// the block's pair, in thread 0 (every thread of the block calls it)
__device__ __forceinline__ void block_best(float& bv, int& bi, int none) {
  __shared__ float wv[kWarps];
  __shared__ int wi[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  warp_best(bv, bi);
  if (lane == 0) {
    wv[warp] = bv;
    wi[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    bv = lane < kWarps ? wv[lane] : __int_as_float(0xff800000);
    bi = lane < kWarps ? wi[lane] : none;
    warp_best(bv, bi);
  }
}

struct Args {
  const float* logits;
  const int* seeds;
  const int* positions;
  int* out;
  int2* pairs;    // (rows, splits) (value bits, index); splits > 1
  int* counters;  // a ticket counter a grid row, all 0
  int row0, v, v_eff, splits, per;
  float temperature;
  bool scale_in_kernel, partitionable;
};

template <bool GREEDY, bool VEC>
__global__ void __launch_bounds__(kThreads) fused_sample_kernel(Args a) {
  const int row = a.row0 + blockIdx.y;
  const float* lg = a.logits + static_cast<size_t>(row) * a.v;
  uint32_t k1 = 0u, k2 = 0u;
  if (!GREEDY) {
    k2 = static_cast<uint32_t>(a.positions[row]);
    threefry2x32(0u, static_cast<uint32_t>(a.seeds[row]), k1, k2);
  }
  const int c0 = blockIdx.x * a.per, c1 = min(a.v, c0 + a.per);

  float best_v = __int_as_float(0xff800000);  // -inf
  int best_i = a.v;
  // columns rise along each thread's walk, so the first maximum stays
  const auto take = [&](float val, int c) {
    if (a.scale_in_kernel) {
      if (c >= a.v_eff) val = kNegInf;
      if (!GREEDY) val = __fdiv_rn(val, a.temperature);
    }
    if (!GREEDY) {
      const uint32_t bits =
          uniform_bits(k1, k2, static_cast<uint32_t>(c),
                       static_cast<uint32_t>(a.v), a.partitionable);
      val = __fadd_rn(bits_to_gumbel(bits), val);
    }
    if (val > best_v) {
      best_v = val;
      best_i = c;
    }
  };
  if (VEC) {
    // c0, per and V are multiples of 4: a float4 never crosses c1
    for (int c = c0 + 4 * threadIdx.x; c < c1; c += 4 * kThreads) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(lg + c));
      take(x.x, c);
      take(x.y, c + 1);
      take(x.z, c + 2);
      take(x.w, c + 3);
    }
  } else {
    for (int c = c0 + threadIdx.x; c < c1; c += kThreads) take(lg[c], c);
  }
  block_best(best_v, best_i, a.v);
  if (a.splits == 1) {
    if (threadIdx.x == 0) a.out[row] = best_i;
    return;
  }

  // the block's pair, then a ticket: the pair's store precedes thread
  // 0's ticket, which releases it to the row's last block and, there,
  // acquires the other blocks' pairs
  int2* prow = a.pairs + static_cast<size_t>(row) * a.splits;
  __shared__ int last;
  if (threadIdx.x == 0) {
    prow[blockIdx.x] = make_int2(__float_as_int(best_v), best_i);
    int prev;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(prev)
                 : "l"(a.counters + blockIdx.y)
                 : "memory");
    last = prev == a.splits - 1;
    if (last) a.counters[blockIdx.y] = 0;  // every split has its ticket
  }
  __syncthreads();
  if (!last) return;
  best_v = __int_as_float(0xff800000);
  best_i = a.v;
  for (int s = threadIdx.x; s < a.splits; s += kThreads) {
    const int2 p = __ldcg(prow + s);
    if (better(__int_as_float(p.x), p.y, best_v, best_i)) {
      best_v = __int_as_float(p.x);
      best_i = p.y;
    }
  }
  block_best(best_v, best_i, a.v);
  if (threadIdx.x == 0) a.out[row] = best_i;
}

template <bool GREEDY>
cudaError_t launch_rows(Args a, int rows, bool vec, cudaStream_t st) {
  for (int r0 = 0; r0 < rows; r0 += kMaxRows) {
    a.row0 = r0;
    const dim3 grid(a.splits, min(kMaxRows, rows - r0));
    if (vec) {
      note_launch(fused_sample_kernel<GREEDY, true>, 0, kThreads);
      fused_sample_kernel<GREEDY, true><<<grid, kThreads, 0, st>>>(a);
    } else {
      note_launch(fused_sample_kernel<GREEDY, false>, 0, kThreads);
      fused_sample_kernel<GREEDY, false><<<grid, kThreads, 0, st>>>(a);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// logits (rows, v) f32, contiguous; seeds, positions (rows,) int32; out
// (rows,) int32. splits and per from ops/paged_decode.py::sample_splits
// (per a multiple of 4, (splits - 1)·per < v); with splits > 1, pairs
// holds rows·splits int2 and counters 65535 ints, all 0 (the kernel
// leaves them 0). vec: v % 4 == 0 and logits 16-byte aligned.
extern "C" int apex1_fused_sample(const void* logits, const void* seeds,
                                  const void* positions, void* out,
                                  void* pairs, void* counters, int rows,
                                  int v, int v_eff, int splits, int per,
                                  float temperature, int greedy,
                                  int scale_in_kernel, int partitionable,
                                  int vec, void* stream) {
  if (rows <= 0) return 0;
  if (v <= 0 || splits < 1 || per < 1 || per % 4 != 0 ||
      static_cast<long long>(splits - 1) * per >= v ||
      static_cast<long long>(splits) * per < v ||
      (splits > 1 && (pairs == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.logits = static_cast<const float*>(logits);
  a.seeds = static_cast<const int*>(seeds);
  a.positions = static_cast<const int*>(positions);
  a.out = static_cast<int*>(out);
  a.pairs = static_cast<int2*>(pairs);
  a.counters = static_cast<int*>(counters);
  a.row0 = 0;
  a.v = v;
  a.v_eff = v_eff;
  a.splits = splits;
  a.per = per;
  a.temperature = temperature;
  a.scale_in_kernel = scale_in_kernel != 0;
  a.partitionable = partitionable != 0;
  cudaStream_t st = as_stream(stream);
  return static_cast<int>(greedy ? launch_rows<true>(a, rows, vec != 0, st)
                                 : launch_rows<false>(a, rows, vec != 0, st));
}
