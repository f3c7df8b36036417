// Fused LM-head cross-entropy in fp32 for Hopper (sm_90a): the forward
// statistics, dx and dW of softmax(x·Wᵀ), without the (tokens x vocab)
// logits in device memory.
//
// Replaces, in fp32: apex1_tpu/ops/linear_xent.py::_fwd_kernel (launched
// by _fused_fwd :384, shard_stats :286 and shard_stats_packed :316, modes
// 0, 1 and 2 here), ::_bwd_dx_kernel (shard_grads :345) and
// ::_bwd_dw_kernel (shard_grads :357). bf16 and fp16 run on wgmma: the
// forward in linear_xent_fwd.cu, the backward in linear_xent_bwd.cu.
//
//   s = x·Wᵀ (fp32 products and sums). W is one shard of V_l rows; its
//   local column c is the global column g = c + off, and is valid when
//   c < V_l and g < K (num_classes).
//   forward:  over vocab tiles, online: m_new = max(m, max valid s),
//             l = l·exp(m - m_new) + Σ valid exp(s - m_new),
//             tgt += Σ_{g == label} s, sx += Σ valid s;
//             mode 0: lse = m + log l,
//                     loss = (1-ε)(lse - tgt) + ε(lse - sx/K), 0 at padding_idx
//             mode 1: m, l, tgt, sx as four (T,) arrays; mode 2: one (T, 4)
//                     array of the same four values
//   backward: G = (valid ? exp(s - lse) : 0) - (1-ε)[g == label] - ε/K,
//             0 where invalid, times dloss (0 at padding_idx);
//             dx = G·W, dW = Gᵀ·x, fp32 sums
//
// Bound on the H100: operations, on the CUDA cores (no TF32): a head of
// T = 1024 tokens, V = 8192, H = 768 is 2·T·V·H = 12.9 GFLOP of forward
// against about 28 MB of operands, far above the ~20 flop/byte where 67
// TFLOP/s of fp32 meet 3.35 TB/s; dx and dW each recompute s and do a
// second product.
//
// Design. The TPU kernels walk the vocab (forward, dx) or token (dW) axis as
// the innermost sequential grid axis with fp32 accumulators in VMEM. Here a
// block of 256 threads owns a tile of 32 "own" rows (tokens for the forward
// and dx, W rows for dW) and loops over tiles of 32 "inner" rows itself:
// - the own rows' operand (all H columns) is read once into shared memory;
// - each inner tile (all H columns) is loaded once with cp.async and serves
//   both products: the logit tile is recomputed, never stored;
// - dx and dW are one kernel: the score tile of dW is Sᵀ = W·xᵀ, the same
//   "own · innerᵀ" product with the roles of token and vocab swapped, and
//   both accumulate own·H += G·inner;
// - the accumulator (where a 32 x 768 fp32 sum lives): 32 own rows x all
//   of H (H <= 768) spread over the 8 warps' registers, each warp a 32 x 96
//   strip (96 registers a thread), so no split of H and no second
//   recompute of the logits;
// - no atomics: each output row is summed by one block in a fixed order,
//   so two runs give the same bits.
// Products run as plain FMA on the CUDA cores from shared memory. Ragged
// token and vocab edges and H not a multiple of 16 are masked or
// zero-filled in shared memory; nothing is padded in device memory. Heads
// wider than 768 take the wide path at the end of this file.

#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kHMax = 768;  // the widest hidden size the tiles hold
constexpr float kNegInf = -1e30f;  // finite, as the JAX package's NEG_INF

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

__host__ __device__ constexpr size_t max_sz(size_t a, size_t b) {
  return a > b ? a : b;
}

// Tile geometry; BWD: the dx/dW kernel.
template <bool BWD>
struct Geo {
  static constexpr int BO = 32;  // own rows a block
  static constexpr int BI = 32;  // inner rows a loop step
  static constexpr int PAD = 4;  // operand row padding (16 bytes)
  static constexpr int LDS = BI + 4;  // score tile stride
  static constexpr int LDG = BI + PAD;  // G tile stride
  static constexpr int TPR = kThreads / BO;  // forward: threads a row
  static constexpr int CPT = BI / TPR;  // forward: score columns a thread

  static __host__ __device__ int ld(int hp) { return hp + PAD; }
  static __host__ __device__ size_t o_bytes(int hp) {
    return align128(size_t(BO) * ld(hp) * sizeof(float));
  }
  static __host__ __device__ size_t i_bytes(int hp) {
    return align128(size_t(BI) * ld(hp) * sizeof(float));
  }
  static constexpr size_t S_BYTES = align128(size_t(BO) * LDS * 4);
  static constexpr size_t G_BYTES =
      BWD ? align128(size_t(BO) * LDG * sizeof(float)) : 0;
  static constexpr size_t TOK_BYTES = align128(size_t(3) * BI * 4);
  static __host__ __device__ size_t smem(int hp) {
    return o_bytes(hp) + i_bytes(hp) + S_BYTES + G_BYTES + TOK_BYTES;
  }
};

struct LxArgs {
  const float* x;      // (T, H)
  const float* w;      // (V, H): the shard
  const int* labels;   // (T,)
  const float* lse;    // (T,), backward
  const float* dloss;  // (T,), backward
  float* out[4];       // forward outputs, by mode
  float* grad;         // dx (T, H) or dW (V, H)
  int T, V, H, K, off;
  float smoothing;
  int has_pad, pad;
  int mode;  // forward: 0 loss+lse, 1 four stats, 2 packed
  int vec;   // H % 4 == 0 and x, w 16-byte aligned
};

// R rows of H values (row stride H) into an R x hp tile with row stride ld;
// rows past `rows` and columns past H become zero. vec: 16-byte cp.async
// copies, in flight until cp_async_wait_all; else plain loads.
template <int R>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* src, int rows, int H,
                                          int hp, int vec) {
  if (vec) {
    // thread t copies 16-byte chunk t of every row: no division, and the
    // addresses step by a constant
    constexpr int EPV = 4;
    static_assert(kHMax / EPV <= kThreads, "loader geometry");
    const int c = threadIdx.x;
    if (c * EPV < hp) {
      const bool col_in = c * EPV < H;
      float* d = dst + c * EPV;
      const float* s = src + c * EPV;
#pragma unroll 4
      for (int r = 0; r < R; ++r) {
        const bool in = col_in && r < rows;
        cp_async16(d, in ? s : src, in ? 16 : 0);
        d += ld;
        s += H;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  } else {
    for (int i = threadIdx.x; i < R * hp; i += kThreads) {
      const int r = i / hp, c = i % hp;
      dst[r * ld + c] = (r < rows && c < H) ? src[size_t(r) * H + c] : 0.f;
    }
  }
}

// the score tile sS[BO x BI] = sO · sIᵀ, by the whole block: thread t row
// t / 8, columns t % 8 + 8j; float4 steps along H
template <typename G>
__device__ __forceinline__ void scores(const float* sO, const float* sI,
                                       int ld, int hp, float* sS) {
  static_assert(G::BO == 32 && G::BI == 32, "score tile");
  const int r = threadIdx.x / 8, c0 = threadIdx.x % 8;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < hp; k += 4) {
    const float4 av = *reinterpret_cast<const float4*>(sO + r * ld + k);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 b =
          *reinterpret_cast<const float4*>(sI + (c0 + 8 * j) * ld + k);
      acc[j] = fmaf(av.x, b.x, acc[j]);
      acc[j] = fmaf(av.y, b.y, acc[j]);
      acc[j] = fmaf(av.z, b.z, acc[j]);
      acc[j] = fmaf(av.w, b.w, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) sS[r * G::LDS + c0 + 8 * j] = acc[j];
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

// Shared-memory carve-up and the loop over inner tiles that both kernels
// share: `body(sI, i0)` runs once a tile, after the tile has landed and its
// scores are in sS.
template <bool BWD>
struct Walk {
  using G = Geo<BWD>;
  int hp, ld;
  float* sO;  // the own tile
  float* sI;  // the inner tile
  float* sS;
  float* sG;
  float* sTok;  // three BI-long arrays: lse, dl, labels (as int)

  __device__ __forceinline__ Walk(unsigned char* smem, int H) {
    hp = round16(H);
    ld = G::ld(hp);
    unsigned char* p = smem;
    sO = reinterpret_cast<float*>(p);
    p += G::o_bytes(hp);
    sI = reinterpret_cast<float*>(p);
    p += G::i_bytes(hp);
    sS = reinterpret_cast<float*>(p);
    p += G::S_BYTES;
    sG = reinterpret_cast<float*>(p);
    p += G::G_BYTES;
    sTok = reinterpret_cast<float*>(p);
  }

  __device__ __forceinline__ void load_own(const float* src, int rows, int H,
                                           int vec) {
    load_rows<G::BO>(sO, ld, src, rows, H, hp, vec);
    if (vec) cp_async_wait_all();
    __syncthreads();
  }

  template <typename Tokens, typename Body>
  __device__ __forceinline__ void run(const float* src, int n_inner, int H,
                                      int vec, Tokens tokens, Body body) {
    const int n_tiles = (n_inner + G::BI - 1) / G::BI;
    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * G::BI;
      __syncthreads();  // the last tile is read
      load_rows<G::BI>(sI, ld, src + size_t(i0) * H,
                       min(G::BI, n_inner - i0), H, hp, vec);
      if (vec) cp_async_wait_all();
      tokens(i0);
      __syncthreads();  // the tile has landed
      scores<G>(sO, sI, ld, hp, sS);
      __syncthreads();
      body(sI, i0);
    }
  }
};

__global__ void __launch_bounds__(kThreads, 1)
    lxent_fwd_kernel(const LxArgs a) {
  using G = Geo<false>;
  constexpr int BO = G::BO, TPR = G::TPR, CPT = G::CPT;
  extern __shared__ __align__(128) unsigned char smem[];
  Walk<false> walk(smem, a.H);

  const int tid = threadIdx.x, row = tid / TPR, part = tid % TPR;
  const int own0 = blockIdx.x * BO, grow = own0 + row;
  walk.load_own(a.x + size_t(own0) * a.H, min(BO, a.T - own0), a.H, a.vec);
  const int label = grow < a.T ? a.labels[grow] : -1;
  // each thread folds its own columns online; the TPR threads of a row
  // merge their statistics once, after the loop
  float m = kNegInf, l = 0.f, tgt = 0.f, sx = 0.f;
  walk.run(a.w, a.V, a.H, a.vec, [](int) {}, [&](const float*, int i0) {
    float sv[CPT];
    bool ok[CPT];
    float mx = kNegInf, t_add = 0.f, x_add = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = part + TPR * j, g = i0 + c + a.off;
      ok[j] = i0 + c < a.V && g < a.K;
      sv[j] = walk.sS[row * G::LDS + c];
      mx = fmaxf(mx, ok[j] ? sv[j] : kNegInf);
      t_add += g == label ? sv[j] : 0.f;
      x_add += ok[j] ? sv[j] : 0.f;
    }
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) sum += ok[j] ? expf(sv[j] - m_new) : 0.f;
    l = l * corr + sum;
    m = m_new;
    tgt += t_add;
    sx += x_add;
  });
  {
    const float m_row = group_max<TPR>(m);
    l = group_sum<TPR>(l * expf(m - m_row));
    m = m_row;
    tgt = group_sum<TPR>(tgt);
    sx = group_sum<TPR>(sx);
  }
  if (grow >= a.T || part != 0) return;
  if (a.mode == 0) {
    const float lse = m + logf(l);
    float loss = (1.f - a.smoothing) * (lse - tgt) +
                 a.smoothing * (lse - sx / static_cast<float>(a.K));
    if (a.has_pad && label == a.pad) loss = 0.f;
    a.out[0][grow] = loss;
    a.out[1][grow] = lse;
  } else if (a.mode == 1) {
    a.out[0][grow] = m;
    a.out[1][grow] = l;
    a.out[2][grow] = tgt;
    a.out[3][grow] = sx;
  } else {
    *reinterpret_cast<float4*>(a.out[0] + size_t(grow) * 4) =
        make_float4(m, l, tgt, sx);
  }
}

// dx (DW false: own = token rows, inner = W rows) or dW (DW true: own = W
// rows, inner = token rows): own·H += G·inner, G recomputed a tile at a time.
template <bool DW>
__global__ void __launch_bounds__(kThreads, 1)
    lxent_bwd_kernel(const LxArgs a) {
  using G = Geo<true>;
  constexpr int BO = G::BO, BI = G::BI;
  extern __shared__ __align__(128) unsigned char smem[];
  Walk<true> walk(smem, a.H);
  float* sLse = walk.sTok;
  float* sDl = sLse + BI;
  int* sLab = reinterpret_cast<int*>(sDl + BI);

  const int tid = threadIdx.x;
  const int own0 = blockIdx.x * BO;
  const int n_own = DW ? a.V : a.T, n_inner = DW ? a.T : a.V;
  const float on = 1.f - a.smoothing;
  const float eps_k = a.smoothing / static_cast<float>(a.K);
  // the own rows' token statistics (dx), in registers of the G loop
  constexpr int EPT = BO * BI / kThreads;  // G elements a thread
  static_assert(kThreads % BI == 0, "a thread's G elements share a column");

  // the token statistics of token t (0 past T; dloss 0 at padding_idx, as
  // the TPU's _grad_tile masks it)
  auto token = [&](int t, float& lse, float& dl, int& lab) {
    const bool in = t < a.T;
    lab = in ? a.labels[t] : -1;
    lse = in ? a.lse[t] : 0.f;
    dl = (in && !(a.has_pad && lab == a.pad)) ? a.dloss[t] : 0.f;
  };

  walk.load_own((DW ? a.w : a.x) + size_t(own0) * a.H,
                min(BO, n_own - own0), a.H, a.vec);

  // the accumulator: fp32, BO x hp, in registers: thread (tx, ty) rows ty
  // and ty + 16, columns 4·tx + 64j + {0..3}
  constexpr int NJ = kHMax / 64;  // float4 column groups
  float acc[2][NJ][4];
  const int tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  // thread e-th G element: row r0 + e * (kThreads / BI), column c
  const int gc = tid % BI, gr0 = tid / BI;
  float own_lse[DW ? 1 : EPT], own_dl[DW ? 1 : EPT];
  int own_lab[DW ? 1 : EPT];
  if constexpr (!DW) {
#pragma unroll
    for (int e = 0; e < EPT; ++e)
      token(own0 + gr0 + e * (kThreads / BI), own_lse[e], own_dl[e],
            own_lab[e]);
  }

  // dW: the inner tile's token statistics, read one tile ahead so their
  // global latency overlaps a step
  float nx_lse = 0.f, nx_dl = 0.f;
  int nx_lab = -1;
  if (DW && tid < BI) token(tid, nx_lse, nx_dl, nx_lab);
  walk.run(
      DW ? a.x : a.w, n_inner, a.H, a.vec,
      [&](int i0) {
        if constexpr (DW) {
          if (tid < BI) {
            sLse[tid] = nx_lse;
            sDl[tid] = nx_dl;
            sLab[tid] = nx_lab;
            token(i0 + BI + tid, nx_lse, nx_dl, nx_lab);
          }
        }
      },
      [&](const float* tile, int i0) {
        float t_lse = 0.f, t_dl = 0.f;
        int t_lab = -1;
        if constexpr (DW) {
          t_lse = sLse[gc];
          t_dl = sDl[gc];
          t_lab = sLab[gc];
        }
#pragma unroll
        for (int e = 0; e < EPT; ++e) {
          const int r = gr0 + e * (kThreads / BI), c = gc;
          if constexpr (!DW) {
            t_lse = own_lse[e];
            t_dl = own_dl[e];
            t_lab = own_lab[e];
          }
          const int vloc = DW ? own0 + r : i0 + c;  // shard-local W row
          const int g = vloc + a.off;
          const bool valid = vloc < a.V && g < a.K;
          const float s = walk.sS[r * G::LDS + c];
          const float p = valid ? expf(s - t_lse) : 0.f;
          float gv = p - on * (g == t_lab ? 1.f : 0.f) - eps_k;
          gv = valid ? gv * t_dl : 0.f;
          walk.sG[r * G::LDG + c] = gv;
        }
        __syncthreads();
        const int ld = walk.ld, hp = walk.hp;
        for (int k = 0; k < BI; ++k) {
          const float g0 = walk.sG[ty * G::LDG + k];
          const float g1 = walk.sG[(ty + 16) * G::LDG + k];
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int col = 4 * tx + 64 * j;
            if (col < hp) {
              const float4 b =
                  *reinterpret_cast<const float4*>(tile + k * ld + col);
              acc[0][j][0] = fmaf(g0, b.x, acc[0][j][0]);
              acc[0][j][1] = fmaf(g0, b.y, acc[0][j][1]);
              acc[0][j][2] = fmaf(g0, b.z, acc[0][j][2]);
              acc[0][j][3] = fmaf(g0, b.w, acc[0][j][3]);
              acc[1][j][0] = fmaf(g1, b.x, acc[1][j][0]);
              acc[1][j][1] = fmaf(g1, b.y, acc[1][j][1]);
              acc[1][j][2] = fmaf(g1, b.z, acc[1][j][2]);
              acc[1][j][3] = fmaf(g1, b.w, acc[1][j][3]);
            }
          }
        }
      });

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = own0 + ty + 16 * i;
    if (r >= n_own) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = 4 * tx + 64 * j + q;
        if (col < a.H) a.grad[size_t(r) * a.H + col] = acc[i][j][q];
      }
  }
}

enum Which { kFwd = 0, kDx = 1, kDw = 2 };

int launch(int which, const LxArgs& a, cudaStream_t st) {
  static bool attr_set[3] = {false, false, false};
  const int hp = round16(a.H);
  void (*kern)(const LxArgs);
  size_t smem, max_smem;
  int rows;
  if (which == kFwd) {
    kern = lxent_fwd_kernel;
    smem = Geo<false>::smem(hp);
    max_smem = Geo<false>::smem(kHMax);
    rows = (a.T + Geo<false>::BO - 1) / Geo<false>::BO;
  } else {
    kern = which == kDx ? lxent_bwd_kernel<false> : lxent_bwd_kernel<true>;
    smem = Geo<true>::smem(hp);
    max_smem = Geo<true>::smem(kHMax);
    const int n_own = which == kDx ? a.T : a.V;
    rows = (n_own + Geo<true>::BO - 1) / Geo<true>::BO;
  }
  if (!attr_set[which]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(max_smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set[which] = true;
  }
  note_launch(kern, smem, kThreads);
  kern<<<rows, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// fp32 only: bf16/fp16 run linear_xent_fwd.cu and linear_xent_bwd.cu
int dispatch(int which, LxArgs& a, int dtype, void* stream) {
  if (a.T <= 0 || a.V <= 0) return 0;
  if (a.H <= 0 || a.H > kHMax || a.K <= 0 || dtype != kF32)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(which, a, as_stream(stream));
}

LxArgs make_args(const void* x, const void* w, const void* labels, int T,
                 int V, int H, int K, int off, float smoothing, int has_pad,
                 int pad, int vec) {
  LxArgs a{};
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const float*>(w);
  a.labels = static_cast<const int*>(labels);
  a.T = T;
  a.V = V;
  a.H = H;
  a.K = K;
  a.off = off;
  a.smoothing = smoothing;
  a.has_pad = has_pad;
  a.pad = pad;
  a.vec = vec;
  return a;
}

}  // namespace

// fp32 only. x (T, H), w (V, H) contiguous, labels (T,) int32. mode 0: out0
// loss, out1 lse (T,) fp32; mode 1: out0..3 m, l, tgt, sx (T,) fp32; mode 2:
// out0 (T, 4) fp32. H <= 768.
extern "C" int apex1_lxent_fwd(const void* x, const void* w,
                               const void* labels, void* out0, void* out1,
                               void* out2, void* out3, int T, int V, int H,
                               int K, int off, float smoothing, int has_pad,
                               int pad, int mode, int vec, int dtype,
                               void* stream) {
  LxArgs a = make_args(x, w, labels, T, V, H, K, off, smoothing, has_pad, pad,
                       vec);
  a.out[0] = static_cast<float*>(out0);
  a.out[1] = static_cast<float*>(out1);
  a.out[2] = static_cast<float*>(out2);
  a.out[3] = static_cast<float*>(out3);
  a.mode = mode;
  return dispatch(kFwd, a, dtype, stream);
}

// fp32 only. lse, dloss (T,) fp32; dx (T, H) fp32
extern "C" int apex1_lxent_dx(const void* x, const void* w,
                              const void* labels, const void* lse,
                              const void* dloss, void* dx, int T, int V, int H,
                              int K, int off, float smoothing, int has_pad,
                              int pad, int vec, int dtype, void* stream) {
  LxArgs a = make_args(x, w, labels, T, V, H, K, off, smoothing, has_pad, pad,
                       vec);
  a.lse = static_cast<const float*>(lse);
  a.dloss = static_cast<const float*>(dloss);
  a.grad = static_cast<float*>(dx);
  return dispatch(kDx, a, dtype, stream);
}

// fp32 only; dw (V, H) fp32
extern "C" int apex1_lxent_dw(const void* x, const void* w,
                              const void* labels, const void* lse,
                              const void* dloss, void* dw, int T, int V, int H,
                              int K, int off, float smoothing, int has_pad,
                              int pad, int vec, int dtype, void* stream) {
  LxArgs a = make_args(x, w, labels, T, V, H, K, off, smoothing, has_pad, pad,
                       vec);
  a.lse = static_cast<const float*>(lse);
  a.dloss = static_cast<const float*>(dloss);
  a.grad = static_cast<float*>(dw);
  return dispatch(kDw, a, dtype, stream);
}

// ---- the wide path (H > 768) ----------------------------------------------
//
// The resident tiles above hold at most 768 columns of H; a wider fp32 head
// (H = 4096: 32 x 4096 fp32 is 512 KB) cannot keep its own rows in shared
// memory (227 KB a block). So it runs as tiled products with H streamed in
// K-steps (`Gemm`, mma.cuh), 128 x 128 output tiles:
// - forward: one product kernel forms the score tiles x·Wᵀ over the whole
//   shard and folds each tile's 128 columns into per-row partial statistics
//   (m, l, tgt, sx) in its epilogue, written to a (T, V/128) buffer; a
//   second kernel folds a row's partials in column order and writes mode
//   0, 1 or 2 (one code path, so mode 2 is mode 1 bit for bit);
// - backward, per vocab chunk of rows [c0, c0 + n): a product kernel forms
//   the chunk's score tiles once and writes G_c to a (T, n) buffer; then
//   dx += G_c·W_c (an fp32 (T, H) sum in device memory, chunks added in
//   order, the last chunk writing dx) and dW_c = G_cᵀ·x are two more
//   products over it. The logits are formed once a chunk, not once for dx
//   and once for dW as above.
// Every output element is summed by one block in a fixed order: no atomics,
// the same bits on every run. ptxas (-Xptxas -v, sm_90a on an H100): the
// forward scores 143 registers, 234 with the G epilogue, dx 168, dW 167; no
// spills.

namespace {

constexpr int kWBM = 128, kWBN = 128;

struct WideArgs {
  const void* x;      // (T, H)
  const void* w;      // (V, H): the shard, or the chunk's rows
  const int* labels;  // (T,)
  const float* lse;   // (T,), backward
  const float* dloss;
  float4* part;       // forward: (T, nblk) partial statistics
  float* out[4];      // forward outputs, by mode
  void* g;            // backward: the chunk's G, (T, V)
  int T, V, H, K, off;  // off: global column of local row 0
  float smoothing;
  int has_pad, pad, mode, nblk, vec;
};

// The score tiles x·Wᵀ of a (T, V) product; GRAD false: per-row partial
// statistics of each 128-column tile; GRAD true: the G tile.
template <typename T, bool GRAD>
__global__ void __launch_bounds__(256, 1) lxw_scores_kernel(const WideArgs a) {
  using G = Gemm<T, kWBM, kWBN, 1, true, true>;
  constexpr int LDS = kWBN + 4;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int tm, tn;
  swizzle(blockIdx.x, (a.T + kWBM - 1) / kWBM, (a.V + kWBN - 1) / kWBN, tm,
          tn);
  const int m0 = tm * kWBM, n0 = tn * kWBN;
  const Operand<T> A{static_cast<const T*>(a.x), a.H};
  const Operand<T> B[1] = {{static_cast<const T*>(a.w), a.H}};
  G g;
  g.run(reinterpret_cast<T*>(smem_raw), A, B, a.T, a.V, a.H, m0, n0, a.vec);
  if constexpr (GRAD) {
    const float on = 1.f - a.smoothing;
    const float eps_k = a.smoothing / static_cast<float>(a.K);
    T* out = static_cast<T*>(a.g);
    const bool pair = a.V % 2 == 0;
    g.for_each([&](int r, int c, const float (&v)[1][2]) {
      const int row = m0 + r;
      if (row >= a.T) return;
      const int lab = a.labels[row];
      const float lse = a.lse[row];
      const float dl = (a.has_pad && lab == a.pad) ? 0.f : a.dloss[row];
      float gv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = n0 + c + h, gcol = col + a.off;
        const bool valid = col < a.V && gcol < a.K;
        const float p = valid ? expf(v[0][h] - lse) : 0.f;
        const float e = p - on * (gcol == lab ? 1.f : 0.f) - eps_k;
        gv[h] = valid ? e * dl : 0.f;
      }
      store_pair<T>(out + size_t(row) * a.V + n0, c, a.V - n0, gv[0], gv[1],
                    pair);
    });
  } else {
    float* sS = reinterpret_cast<float*>(smem_raw);
    g.for_each([&](int r, int c, const float (&v)[1][2]) {
      sS[r * LDS + c] = v[0][0];
      sS[r * LDS + c + 1] = v[0][1];
    });
    __syncthreads();
    // two threads a row, 64 columns each, then one shuffle
    const int r = threadIdx.x / 2, part = threadIdx.x % 2;
    const int row = m0 + r;
    const int lab = row < a.T ? a.labels[row] : -1;
    const float* srow = sS + r * LDS + 64 * part;
    const int c0 = n0 + 64 * part;
    float m = kNegInf;
    for (int c = 0; c < 64; ++c) {
      const int col = c0 + c;
      if (col < a.V && col + a.off < a.K) m = fmaxf(m, srow[c]);
    }
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    float l = 0.f, tgt = 0.f, sx = 0.f;
    for (int c = 0; c < 64; ++c) {
      const int col = c0 + c;
      if (col >= a.V) break;
      const float s = srow[c];
      if (col + a.off < a.K) {
        l += expf(s - m);
        sx += s;
      }
      tgt += col + a.off == lab ? s : 0.f;
    }
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    tgt += __shfl_xor_sync(0xffffffffu, tgt, 1);
    sx += __shfl_xor_sync(0xffffffffu, sx, 1);
    if (row < a.T && part == 0)
      a.part[size_t(row) * a.nblk + tn] = make_float4(m, l, tgt, sx);
  }
}

// fold each row's partials in column order; write mode 0, 1 or 2
__global__ void lxw_merge_kernel(const WideArgs a) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= a.T) return;
  float m = kNegInf, l = 0.f, tgt = 0.f, sx = 0.f;
  const float4* p = a.part + size_t(row) * a.nblk;
  for (int b = 0; b < a.nblk; ++b) {
    const float4 q = p[b];
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

struct WideProdArgs {
  const void* a;  // A operand (see the kernels)
  const void* b;
  float* acc;     // dx: the fp32 (T, H) running sum
  void* out;
  int M, N, K;
  int first, last, vec;
};

// dx: (T, H) += G (T, n) · W_c (n, H); the last chunk writes dx
template <typename T>
__global__ void __launch_bounds__(256, 1) lxw_dx_kernel(const WideProdArgs a) {
  using G = Gemm<T, kWBM, kWBN, 1, true, false>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int tm, tn;
  swizzle(blockIdx.x, (a.M + kWBM - 1) / kWBM, (a.N + kWBN - 1) / kWBN, tm,
          tn);
  const int m0 = tm * kWBM, n0 = tn * kWBN;
  const Operand<T> A{static_cast<const T*>(a.a), a.K};
  const Operand<T> B[1] = {{static_cast<const T*>(a.b), a.N}};
  G g;
  g.run(reinterpret_cast<T*>(smem_raw), A, B, a.M, a.N, a.K, m0, n0, a.vec);
  T* out = static_cast<T*>(a.out);
  const bool pair = a.N % 2 == 0;
  g.for_each([&](int r, int c, const float (&v)[1][2]) {
    const int row = m0 + r;
    if (row >= a.M) return;
    const size_t base = size_t(row) * a.N + n0;
    float s0 = v[0][0], s1 = v[0][1];
    const int n = a.N - n0;
    if (!a.first) {
      if (c < n) s0 += a.acc[base + c];
      if (c + 1 < n) s1 += a.acc[base + c + 1];
    }
    if (a.last) {
      store_pair<T>(out + base, c, n, s0, s1, pair);
    } else {
      store_pair<float>(a.acc + base, c, n, s0, s1, pair);
    }
  });
}

// dW_c (n, H) = G_cᵀ · x: A(m, k) = G[k][m] (the stored G is (T, n)),
// B = x (T, H)
template <typename T>
__global__ void __launch_bounds__(256, 1) lxw_dw_kernel(const WideProdArgs a) {
  using G = Gemm<T, kWBM, kWBN, 1, false, false>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int tm, tn;
  swizzle(blockIdx.x, (a.M + kWBM - 1) / kWBM, (a.N + kWBN - 1) / kWBN, tm,
          tn);
  const int m0 = tm * kWBM, n0 = tn * kWBN;
  const Operand<T> A{static_cast<const T*>(a.a), a.M};
  const Operand<T> B[1] = {{static_cast<const T*>(a.b), a.N}};
  G g;
  g.run(reinterpret_cast<T*>(smem_raw), A, B, a.M, a.N, a.K, m0, n0, a.vec);
  T* out = static_cast<T*>(a.out);
  const bool pair = a.N % 2 == 0;
  g.for_each([&](int r, int c, const float (&v)[1][2]) {
    const int row = m0 + r;
    if (row >= a.M) return;
    store_pair<T>(out + size_t(row) * a.N + n0, c, a.N - n0, v[0][0],
                  v[0][1], pair);
  });
}

template <typename Args>
int launch_tiles(void (*kern)(const Args), size_t smem, int M, int N,
                 const Args& a, cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = ((M + kWBM - 1) / kWBM) * ((N + kWBN - 1) / kWBN);
  note_launch(kern, smem, 256);
  kern<<<tiles, 256, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int wide_scores(const WideArgs& a, bool grad, cudaStream_t st) {
  using G = Gemm<T, kWBM, kWBN, 1, true, true>;
  if (grad)
    return launch_tiles(lxw_scores_kernel<T, true>, G::SMEM, a.T, a.V, a,
                        st);
  const size_t stage = size_t(kWBM) * (kWBN + 4) * sizeof(float);
  int err = launch_tiles(lxw_scores_kernel<T, false>, max_sz(G::SMEM, stage),
                         a.T, a.V, a, st);
  if (err) return err;
  note_launch(lxw_merge_kernel, 0, 128);
  lxw_merge_kernel<<<(a.T + 127) / 128, 128, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int wide_prod(const WideProdArgs& a, bool dw, cudaStream_t st) {
  if (dw)
    return launch_tiles(lxw_dw_kernel<T>,
                        Gemm<T, kWBM, kWBN, 1, false, false>::SMEM, a.M, a.N,
                        a, st);
  return launch_tiles(lxw_dx_kernel<T>,
                      Gemm<T, kWBM, kWBN, 1, true, false>::SMEM, a.M, a.N, a,
                      st);
}

// fp32 only: bf16/fp16 run linear_xent_fwd.cu and linear_xent_bwd.cu
int wide_scores_dtype(const WideArgs& a, bool grad, int dtype, void* stream) {
  if (a.T <= 0 || a.V <= 0) return 0;
  if (a.H <= 0 || a.K <= 0 || dtype != kF32 ||
      (!grad && a.nblk != (a.V + kWBN - 1) / kWBN))
    return static_cast<int>(cudaErrorInvalidValue);
  return wide_scores<float>(a, grad, as_stream(stream));
}

// fp32 only: the half backward is linear_xent_bwd.cu's
int wide_prod_dtype(const WideProdArgs& a, bool dw, int dtype, void* stream) {
  if (a.M <= 0 || a.N <= 0 || a.K <= 0) return 0;
  if (dtype != kF32) return static_cast<int>(cudaErrorInvalidValue);
  return wide_prod<float>(a, dw, as_stream(stream));
}

WideArgs wide_args(const void* x, const void* w, const void* labels, int T,
                   int V, int H, int K, int off, float smoothing, int has_pad,
                   int pad, int vec) {
  WideArgs a{};
  a.x = x;
  a.w = w;
  a.labels = static_cast<const int*>(labels);
  a.T = T;
  a.V = V;
  a.H = H;
  a.K = K;
  a.off = off;
  a.smoothing = smoothing;
  a.has_pad = has_pad;
  a.pad = pad;
  a.vec = vec;
  return a;
}

}  // namespace

// The wide forward, fp32 only: x (T, H), w (V, H) as apex1_lxent_fwd, any
// H; part a (T, nblk) float4 scratch, nblk = ceil(V / 128). vec: H is a
// multiple of 4 and x, w are 16-byte aligned.
extern "C" int apex1_lxent_wide_fwd(const void* x, const void* w,
                                    const void* labels, void* part,
                                    void* out0, void* out1, void* out2,
                                    void* out3, int T, int V, int H, int K,
                                    int off, float smoothing, int has_pad,
                                    int pad, int mode, int nblk, int vec,
                                    int dtype, void* stream) {
  WideArgs a = wide_args(x, w, labels, T, V, H, K, off, smoothing, has_pad,
                         pad, vec);
  a.part = static_cast<float4*>(part);
  a.out[0] = static_cast<float*>(out0);
  a.out[1] = static_cast<float*>(out1);
  a.out[2] = static_cast<float*>(out2);
  a.out[3] = static_cast<float*>(out3);
  a.mode = mode;
  a.nblk = nblk;
  return wide_scores_dtype(a, false, dtype, stream);
}

// fp32 only. G of one vocab chunk: w the
// chunk's n rows (V = n), off the global column of its first row; g (T, n)
extern "C" int apex1_lxent_wide_grad(const void* x, const void* w,
                                     const void* labels, const void* lse,
                                     const void* dloss, void* g, int T, int V,
                                     int H, int K, int off, float smoothing,
                                     int has_pad, int pad, int vec, int dtype,
                                     void* stream) {
  WideArgs a = wide_args(x, w, labels, T, V, H, K, off, smoothing, has_pad,
                         pad, vec);
  a.lse = static_cast<const float*>(lse);
  a.dloss = static_cast<const float*>(dloss);
  a.g = g;
  return wide_scores_dtype(a, true, dtype, stream);
}

// dx += G (T, n) · W_c (n, H): acc the fp32 (T, H) sum (unread with first,
// unwritten with last), dx (T, H) written with last; fp32 only
extern "C" int apex1_lxent_wide_dx(const void* g, const void* w, void* acc,
                                   void* dx, int T, int n, int H, int first,
                                   int last, int vec, int dtype,
                                   void* stream) {
  WideProdArgs a{g, w, static_cast<float*>(acc), dx, T, H, n, first, last,
                 vec};
  return wide_prod_dtype(a, false, dtype, stream);
}

// dW_c (n, H) = Gᵀ · x, G (T, n), x (T, H); fp32 only
extern "C" int apex1_lxent_wide_dw(const void* g, const void* x, void* dw,
                                   int T, int n, int H, int vec, int dtype,
                                   void* stream) {
  WideProdArgs a{g, x, nullptr, dw, n, H, T, 0, 0, vec};
  return wide_prod_dtype(a, true, dtype, stream);
}
