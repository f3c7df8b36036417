// The bf16/fp16 forward of the fused LM-head cross-entropy for Hopper
// (sm_90a): the per-token statistics of softmax(x·Wᵀ) (linear_xent.cu
// states the function) as one wgmma product whose epilogue folds each
// score tile into per-row partials in the accumulator registers, then a
// fold of those partials over the vocab tiles.
//
// Replaces: apex1_tpu/ops/linear_xent.py::_fwd_kernel (launched by
// _fused_fwd :384, shard_stats :286 and shard_stats_packed :316: modes 0,
// 1 and 2 here), for bf16 and fp16 at every H; fp32 keeps linear_xent.cu's
// kernels.
//
//   lxent_wg_stats_kernel: the 128 x 256 tile (m0, n0) of s = x·Wᵀ on
//     gemm_wg.cuh (x and the W shard both K-major), then each row's
//     partial statistics of the tile straight from the fragment: a
//     thread holds two rows (r and r + 8 of its warp's 16) and 64
//     columns of each, the four lanes of a quad one whole row. The
//     masked max over the quad (__shfl_xor 1 and 2, so the four lanes
//     share one max and nothing is rescaled), then over the thread's
//     columns Σ valid exp(s - m), Σ valid s and the label's logit,
//     summed over the quad the same way; a tile whose columns are all
//     valid skips the masks. One lane writes (m, l, tgt, sx) of (row,
//     N-tile) into part[N-tile][row]. No score tile in shared memory, no
//     second walk over it. A tile with no valid column of a row gives
//     m = -1e30 (finite) and l = 0.
//   lxent_wg_fold_kernel: a thread a row merges its partials over the
//     N-tiles in order (m = max, l rescaled by exp of the difference)
//     and writes mode 0, 1 or 2 through one code path, so mode 2 is mode
//     1 bit for bit. The partials lie N-tile-major: a warp's loads of
//     one N-tile are 32 consecutive float4.
// Validity is local column < V_l and global column < K; tgt takes s where
// the global column equals the label (one column of the shard at most)
// with no validity test (the zero columns past V_l give 0). Every output is summed in a fixed order with
// no atomics: the same bits on every run. Precise expf and logf: the loss
// and lse are held to fp32's 1e-5.
//
// Bound on the H100: operations. At the Llama head (T = 8190, V = 32000,
// H = 4096) the product is 2.15 TFLOP on about 0.33 GB of operands, 2.17
// ms at 989 TFLOP/s; at GPT-2's (16368 x 50304 x 768) 1.26 TFLOP, 1.28 ms.
//
// Tiles: 128 x 256 (m64n256 products), four stages, one block an SM, at
// every shape: in development calls on an H100 they beat 128 x 128 tiles
// (one block an SM, or two on three stages so that one block's epilogue
// overlaps the other's products) at the Llama, GPT-2 and BERT heads and
// tied them at the DPO and shard cases, whose grids fill the card less.
// The tile order walks groups of 16 row tiles over the vocab tiles
// together (`tile_of`): the blocks in flight share W's tiles in L2 (groups
// of 8 read W twice as often, and took longer at the Llama head). Each K
// step of a tile brings (128 + 256) x 64 x 2 bytes from L2 to its SM:
// at the Llama head that traffic, not the epilogue, sets the pace, and
// sharing W's tiles between two SMs by TMA multicast would halve it (not
// yet).

#include "gemm_wg.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // finite, as the JAX package's NEG_INF

struct FwdArgs {
  const void* x;      // (T, H)
  const void* w;      // (V, H): the shard
  const int* labels;  // (T,)
  float4* part;       // (nblk, T) partial statistics
  float* out[4];      // by mode
  int T, V, H, K, off;  // off: global column of local row 0
  float smoothing;
  int has_pad, pad, mode, nblk, vec;
};

// the output tile's columns (m64n256 products) and the ring's stages
constexpr int kBN = 256, kStages = 4;
// row tiles a group of the tile order: at the Llama head four groups of
// 16 row tiles (16 MB of x each) walk W's 125 column tiles
constexpr int kGroup = 16;

__device__ __forceinline__ unsigned char* dyn_smem() {
  extern __shared__ __align__(1024) unsigned char lxf_smem[];
  return lxf_smem;
}

// The partial statistics (m, l, tgt, sx) of this thread's two rows of the
// tile from its fragment `acc` (BN/4 columns of each), merged over the
// quad: the element (j, e) of row hh lies at column 8j + e of the thread's
// own, valid where 8j + e < nv (FULL: every column valid), the label's
// where 8j + e == lc[hh]. The two rows' chains run interleaved; selects,
// not branches, inside the unrolled fragment loops.
template <int BN, bool FULL>
__device__ __forceinline__ void row_partials(const float (&acc)[BN / 2],
                                             int nv, const int (&lc)[2],
                                             float4 (&out)[2]) {
  float m[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float s = acc[4 * j + 2 * hh + e];
        m[hh] = fmaxf(m[hh], FULL || 8 * j + e < nv ? s : kNegInf);
      }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 1));
    m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 2));
  }
  // a row's label lies in at most one column: tgt selects it, no sum
  float l[2] = {0.f, 0.f}, tgt[2] = {0.f, 0.f}, sx[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float s = acc[4 * j + 2 * hh + e];
        const bool ok = FULL || 8 * j + e < nv;
        l[hh] += ok ? expf(s - m[hh]) : 0.f;
        sx[hh] += ok ? s : 0.f;
        tgt[hh] = 8 * j + e == lc[hh] ? s : tgt[hh];
      }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], o);
      tgt[hh] += __shfl_xor_sync(0xffffffffu, tgt[hh], o);
      sx[hh] += __shfl_xor_sync(0xffffffffu, sx[hh], o);
    }
    out[hh] = make_float4(m[hh], l[hh], tgt[hh], sx[hh]);
  }
}

// the tile order: groups of kGroup row tiles walk the column tiles
// together, so the blocks in flight share their operand tiles in L2
__device__ __forceinline__ void tile_of(int pid, int tiles_m, int tiles_n,
                                        int& tm, int& tn) {
  const int per = kGroup * tiles_n;
  const int first = (pid / per) * kGroup;
  const int size = min(tiles_m - first, kGroup);
  tm = first + (pid % per) % size;
  tn = (pid % per) / size;
}

template <typename T>
__global__ void __launch_bounds__(256, 1)
    lxent_wg_stats_kernel(const FwdArgs a) {
  using P = wg::Gemm<T, kBN, kStages, false, false>;
  constexpr int BN = kBN;
  int tm, tn;
  tile_of(blockIdx.x, (a.T + P::BM - 1) / P::BM, a.nblk, tm, tn);
  const int m0 = tm * P::BM, n0 = tn * BN;
  // the tile's labels, read before the products so that their latency
  // hides behind them, and kept in shared memory, not in registers the
  // products need (run's first barrier publishes them)
  __shared__ int s_lab[P::BM];
  if (threadIdx.x < P::BM) {
    const int row = m0 + threadIdx.x;
    s_lab[threadIdx.x] = row < a.T ? a.labels[row] : -1;
  }
  P p;
  p.run(dyn_smem(), static_cast<const T*>(a.x), a.H,
        static_cast<const T*>(a.w), a.H, a.T, a.V, a.H, m0, n0, a.vec != 0,
        a.vec != 0);
  const int lane = threadIdx.x % 32;
  const int r = 64 * (threadIdx.x / 128) + 16 * ((threadIdx.x / 32) % 4) +
                lane / 4;
  const int c0 = n0 + 2 * (lane % 4);
  const int nvalid = min(a.V, a.K - a.off);
  const int lc[2] = {s_lab[r] - a.off - c0, s_lab[r + 8] - a.off - c0};
  float4 st[2];
  if (nvalid >= n0 + BN)  // the whole tile valid: no masks
    row_partials<BN, true>(p.acc[0], 0, lc, st);
  else
    row_partials<BN, false>(p.acc[0], nvalid - c0, lc, st);
  if (lane % 4 == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + r + 8 * hh;
      if (row < a.T) a.part[size_t(tn) * a.T + row] = st[hh];
    }
  }
}

// fold each row's partials over the N-tiles in order; write mode 0, 1 or 2
__global__ void lxent_wg_fold_kernel(const FwdArgs a) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= a.T) return;
  float m = kNegInf, l = 0.f, tgt = 0.f, sx = 0.f;
  for (int b = 0; b < a.nblk; ++b) {
    const float4 q = a.part[size_t(b) * a.T + row];
    const float m_new = fmaxf(m, q.x);
    l = l * expf(m - m_new) + q.y * expf(q.x - m_new);
    m = m_new;
    tgt += q.z;
    sx += q.w;
  }
  if (a.mode == 0) {
    const float lse = m + logf(l);
    float loss = (1.f - a.smoothing) * (lse - tgt) +
                 a.smoothing * (lse - sx / static_cast<float>(a.K));
    if (a.has_pad && a.labels[row] == a.pad) loss = 0.f;
    a.out[0][row] = loss;
    a.out[1][row] = lse;
  } else if (a.mode == 1) {
    a.out[0][row] = m;
    a.out[1][row] = l;
    a.out[2][row] = tgt;
    a.out[3][row] = sx;
  } else {
    *reinterpret_cast<float4*>(a.out[0] + size_t(row) * 4) =
        make_float4(m, l, tgt, sx);
  }
}

template <typename T>
int launch_stats(const FwdArgs& a, cudaStream_t st) {
  using P = wg::Gemm<T, kBN, kStages, false, false>;
  const cudaError_t e = cudaFuncSetAttribute(
      lxent_wg_stats_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(P::SMEM));
  if (e != cudaSuccess) return static_cast<int>(e);
  note_launch(lxent_wg_stats_kernel<T>, P::SMEM, 256);
  lxent_wg_stats_kernel<T>
      <<<((a.T + P::BM - 1) / P::BM) * a.nblk, 256, P::SMEM, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (T, H), w (V, H) contiguous in `dtype` (bf16 or fp16), labels (T,)
// int32; mode 0: out0 loss, out1 lse (T,) fp32; mode 1: out0..3 m, l, tgt,
// sx (T,) fp32; mode 2: out0 (T, 4) fp32. part a (nblk, T) float4
// scratch, nblk = ceil(V / 256) (checked). vec: H is a multiple of 8 and
// x, w are 16-byte aligned.
extern "C" int apex1_lxent_wg_fwd(const void* x, const void* w,
                                  const void* labels, void* part, void* out0,
                                  void* out1, void* out2, void* out3, int T,
                                  int V, int H, int K, int off,
                                  float smoothing, int has_pad, int pad,
                                  int mode, int nblk, int vec, int dtype,
                                  void* stream) {
  if (T <= 0 || V <= 0) return 0;
  if (H <= 0 || K <= 0 || mode < 0 || mode > 2 ||
      nblk != (V + kBN - 1) / kBN || (dtype != kBF16 && dtype != kF16))
    return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a{};
  a.x = x;
  a.w = w;
  a.labels = static_cast<const int*>(labels);
  a.part = static_cast<float4*>(part);
  a.out[0] = static_cast<float*>(out0);
  a.out[1] = static_cast<float*>(out1);
  a.out[2] = static_cast<float*>(out2);
  a.out[3] = static_cast<float*>(out3);
  a.T = T;
  a.V = V;
  a.H = H;
  a.K = K;
  a.off = off;
  a.smoothing = smoothing;
  a.has_pad = has_pad;
  a.pad = pad;
  a.mode = mode;
  a.nblk = nblk;
  a.vec = vec;
  cudaStream_t st = as_stream(stream);
  const int err = dtype == kBF16 ? launch_stats<__nv_bfloat16>(a, st)
                                 : launch_stats<__half>(a, st);
  if (err) return err;
  note_launch(lxent_wg_fold_kernel, 0, 128);
  lxent_wg_fold_kernel<<<(T + 127) / 128, 128, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
