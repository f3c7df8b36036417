// Fused counter-keyed sampling epilogue for Hopper (sm_90a).
//
// Replaces: apex1_tpu/ops/paged_decode.py::_fused_sample_kernel
// (launched by fused_sample), the Pallas TPU kernel that turns (R, V)
// f32 logits into token ids: vocab mask, temperature, a threefry-2x32
// gumbel draw keyed on fold_in(key(seed), pos), and an exact
// (max, first-index) argmax folded across vocab blocks.
//
// Bound on the H100: at temperature 0 memory (each logit is read once);
// when sampling, the CUDA cores: every vocab entry costs one 20-round
// threefry-2x32 block (about 130 integer operations) and two precise
// logf, against 4 bytes read.
//
// Design: one block of 1024 threads per row. Every thread derives the
// row's key itself (key(seed) is (0, seed); fold_in hashes (0, pos)
// under it: one threefry block, cheaper than a broadcast), then strides
// over the vocab computing, per entry, the vocab mask, the temperature
// divide, the uint32 draw of either threefry stream (partitionable:
// counter (0, col), output y0 ^ y1; original: the iota split in halves,
// each lane recomputing its half-pair partner) and the gumbel transform.
// Each thread keeps its first maximum; a warp-shuffle and then a
// shared-memory fold keep the (max, lowest index) pair, so ties resolve
// to the first index exactly as argmax does. The float steps use _rn
// intrinsics and precise logf (no fast math, no contraction into FMA),
// so the noise equals the plain PyTorch version on the card bit for bit.
// top_k stays outside: its sort runs before the kernel, which then sees
// already-scaled logits (scale_in_kernel = 0).

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
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

__global__ void __launch_bounds__(kThreads)
    fused_sample_kernel(const float* __restrict__ logits,
                        const int* __restrict__ seeds,
                        const int* __restrict__ positions,
                        int* __restrict__ out, int v, int v_eff,
                        float temperature, bool greedy, bool scale_in_kernel,
                        bool partitionable) {
  const int row = blockIdx.x;
  const float* lg = logits + static_cast<size_t>(row) * v;
  uint32_t k1 = 0u, k2 = static_cast<uint32_t>(positions[row]);
  threefry2x32(0u, static_cast<uint32_t>(seeds[row]), k1, k2);

  float best_v = __int_as_float(0xff800000);  // -inf
  int best_i = v;
  for (int c = threadIdx.x; c < v; c += kThreads) {
    float val = lg[c];
    if (scale_in_kernel) {
      if (c >= v_eff) val = kNegInf;
      if (!greedy) val = __fdiv_rn(val, temperature);
    }
    if (!greedy) {
      const uint32_t bits =
          uniform_bits(k1, k2, static_cast<uint32_t>(c),
                       static_cast<uint32_t>(v), partitionable);
      val = __fadd_rn(bits_to_gumbel(bits), val);
    }
    if (val > best_v) {  // c rises, so the first maximum stays
      best_v = val;
      best_i = c;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best_v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
    if (better(ov, oi, best_v, best_i)) {
      best_v = ov;
      best_i = oi;
    }
  }
  __shared__ float wv[32];
  __shared__ int wi[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    wv[warp] = best_v;
    wi[warp] = best_i;
  }
  __syncthreads();
  if (warp == 0) {
    best_v = wv[lane];
    best_i = wi[lane];
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best_v, o);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
      if (better(ov, oi, best_v, best_i)) {
        best_v = ov;
        best_i = oi;
      }
    }
    if (lane == 0) out[row] = best_i;
  }
}

}  // namespace

extern "C" int apex1_fused_sample(const void* logits, const void* seeds,
                                  const void* positions, void* out, int rows,
                                  int v, int v_eff, float temperature,
                                  int greedy, int scale_in_kernel,
                                  int partitionable, void* stream) {
  if (rows <= 0) return 0;
  fused_sample_kernel<<<rows, kThreads, 0, as_stream(stream)>>>(
      static_cast<const float*>(logits), static_cast<const int*>(seeds),
      static_cast<const int*>(positions), static_cast<int*>(out), v, v_eff,
      temperature, greedy != 0, scale_in_kernel != 0, partitionable != 0);
  return static_cast<int>(cudaGetLastError());
}
