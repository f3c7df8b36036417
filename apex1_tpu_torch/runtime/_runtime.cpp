// apex1_tpu_torch host runtime: native byte-moving for the data path
// (a copy of the JAX package's `runtime/_runtime.cpp`, ABI version 4;
// the port keeps its own so it never reads the JAX package's files).
//
// Reference capabilities covered:
// - csrc/flatten_unflatten.cpp :: flatten/unflatten ("apex_C"): pack
//   many host arrays into ONE contiguous staging buffer (and back), so
//   a batch or a bucket is one host->device copy. Multi-threaded memcpy
//   saturates host memory bandwidth.
// - examples/imagenet/main_amp.py :: data_prefetcher: the reference
//   normalizes uint8 NHWC images to fp32 on a CUDA side stream; here the
//   normalize (u8 -> f32, per-channel mean/std) runs in native threads on
//   the host, off the training loop's thread, and the Python
//   PrefetchLoader copies the result to the card on its own stream.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11, no PyTorch
// headers): g++ builds it in seconds at first use.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Run fn(i) for i in [0, n) across up to `threads` hardware threads.
template <typename F>
void parallel_for(int64_t n, int threads, F fn) {
  if (n <= 0) return;
  int tn = std::min<int64_t>(threads, n);
  if (tn <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(tn);
  for (int t = 0; t < tn; ++t) {
    pool.emplace_back([=] {
      for (int64_t i = t; i < n; i += tn) fn(i);
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Pack n_src source buffers (sizes in bytes) back-to-back into dst.
// Offsets are the exclusive prefix sum of sizes; dst must hold sum(sizes).
void apex1_flatten(const void** srcs, const int64_t* sizes, int64_t n_src,
                   void* dst, int threads) {
  std::vector<int64_t> offs(n_src);
  int64_t acc = 0;
  for (int64_t i = 0; i < n_src; ++i) { offs[i] = acc; acc += sizes[i]; }
  parallel_for(n_src, threads, [&](int64_t i) {
    std::memcpy(static_cast<char*>(dst) + offs[i], srcs[i],
                static_cast<size_t>(sizes[i]));
  });
}

// Inverse: split src into n_dst buffers of the given sizes.
void apex1_unflatten(const void* src, const int64_t* sizes, int64_t n_dst,
                     void** dsts, int threads) {
  std::vector<int64_t> offs(n_dst);
  int64_t acc = 0;
  for (int64_t i = 0; i < n_dst; ++i) { offs[i] = acc; acc += sizes[i]; }
  parallel_for(n_dst, threads, [&](int64_t i) {
    std::memcpy(dsts[i], static_cast<const char*>(src) + offs[i],
                static_cast<size_t>(sizes[i]));
  });
}

// uint8 NHWC image batch -> float32, (x/255 - mean[c]) / std[c].
// n = total elements; c = channel count (innermost dim).
void apex1_normalize_u8_f32(const uint8_t* src, float* dst, int64_t n,
                            const float* mean, const float* stddev,
                            int64_t c, int threads) {
  // precompute per-channel scale/bias: y = x * (1/(255*std)) - mean/std
  std::vector<float> scale(c), bias(c);
  for (int64_t ch = 0; ch < c; ++ch) {
    scale[ch] = 1.0f / (255.0f * stddev[ch]);
    bias[ch] = -mean[ch] / stddev[ch];
  }
  const int64_t kChunk = 1 << 16;
  int64_t n_chunks = (n + kChunk - 1) / kChunk;
  parallel_for(n_chunks, threads, [&](int64_t chunk) {
    int64_t lo = chunk * kChunk, hi = std::min(n, lo + kChunk);
    for (int64_t i = lo; i < hi; ++i) {
      int64_t ch = i % c;
      dst[i] = static_cast<float>(src[i]) * scale[ch] + bias[ch];
    }
  });
}

// bf16 (as uint16 bit patterns) <-> f32 host conversion for staging
// checkpoint/comm buffers without a device round-trip.
void apex1_f32_to_bf16(const float* src, uint16_t* dst, int64_t n,
                       int threads) {
  const int64_t kChunk = 1 << 16;
  int64_t n_chunks = (n + kChunk - 1) / kChunk;
  parallel_for(n_chunks, threads, [&](int64_t chunk) {
    int64_t lo = chunk * kChunk, hi = std::min(n, lo + kChunk);
    for (int64_t i = lo; i < hi; ++i) {
      uint32_t bits;
      std::memcpy(&bits, &src[i], 4);
      if ((bits & 0x7FFFFFFFu) > 0x7F800000u) {
        // NaN: rounding could carry out of the mantissa (e.g. 0x7FFFFFFF
        // -> -0.0); keep a quiet NaN with the top payload bits instead
        dst[i] = static_cast<uint16_t>((bits >> 16) | 0x0040u);
        continue;
      }
      // round-to-nearest-even on the dropped 16 bits
      uint32_t rounding = 0x7FFF + ((bits >> 16) & 1);
      dst[i] = static_cast<uint16_t>((bits + rounding) >> 16);
    }
  });
}

void apex1_bf16_to_f32(const uint16_t* src, float* dst, int64_t n,
                       int threads) {
  const int64_t kChunk = 1 << 16;
  int64_t n_chunks = (n + kChunk - 1) / kChunk;
  parallel_for(n_chunks, threads, [&](int64_t chunk) {
    int64_t lo = chunk * kChunk, hi = std::min(n, lo + kChunk);
    for (int64_t i = lo; i < hi; ++i) {
      uint32_t bits = static_cast<uint32_t>(src[i]) << 16;
      std::memcpy(&dst[i], &bits, 4);
    }
  });
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Token-dataset loader: memory-mapped LM pretraining data.
//
// Reference capability: the examples' input pipelines (imagenet
// data_prefetcher lineage) generalized to the LM-pretrain configs this
// framework benches. Design choice: batches are addressed by
// STEP INDEX, not by iterator state — `next(step)` is a pure function of
// (file, seed, step), so checkpoint/resume needs only the step counter
// (matching the framework's functional checkpoint story) and any worker
// can prefetch any step. Shuffling is an exact per-epoch permutation via
// an LCG over the next power of two with cycle-walking (no index table,
// O(1) memory for arbitrarily large corpora).
// ---------------------------------------------------------------------------

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// splitmix64 — per-(seed, epoch) parameter derivation.
uint64_t mix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

struct TokenLoader {
  const uint8_t* map = nullptr;
  size_t map_len = 0;
  int64_t n_tokens = 0;
  int dtype_size = 0;   // 2 (uint16) or 4 (int32/uint32)
  int64_t seq_len = 0;
  int64_t batch = 0;
  uint64_t seed = 0;
  int shuffle = 0;
  int64_t n_seqs = 0;   // sequences per epoch
  uint64_t pow2 = 1;    // next power of two >= n_seqs

  // exact permutation of [0, n_seqs) for one epoch: affine step over the
  // pow2 ring, walking past out-of-range points. a must be odd (unit mod
  // 2^k); a fixed small number of extra walks amortizes to O(1).
  int64_t perm(uint64_t epoch, uint64_t i) const {
    if (!shuffle) return static_cast<int64_t>(i);
    uint64_t a = mix64(seed ^ mix64(epoch)) | 1ull;
    uint64_t c = mix64(seed ^ mix64(epoch ^ 0xD1B54A32D192ED03ull));
    uint64_t m = pow2 - 1;
    uint64_t x = i;
    do {
      x = (a * x + c) & m;
    } while (x >= static_cast<uint64_t>(n_seqs));
    return static_cast<int64_t>(x);
  }
};

}  // namespace

extern "C" {

void* apex1_loader_open(const char* path, int dtype_size, int64_t seq_len,
                        int64_t batch, uint64_t seed, int shuffle) {
  if ((dtype_size != 2 && dtype_size != 4) || seq_len <= 0 || batch <= 0)
    return nullptr;
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < dtype_size * seq_len) {
    ::close(fd);
    return nullptr;
  }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  ::close(fd);  // mapping keeps the file alive
  if (map == MAP_FAILED) return nullptr;
  auto* L = new TokenLoader();
  L->map = static_cast<const uint8_t*>(map);
  L->map_len = st.st_size;
  L->n_tokens = st.st_size / dtype_size;
  L->dtype_size = dtype_size;
  L->seq_len = seq_len;
  L->batch = batch;
  L->seed = seed;
  L->shuffle = shuffle;
  L->n_seqs = L->n_tokens / seq_len;
  while (static_cast<int64_t>(L->pow2) < L->n_seqs) L->pow2 <<= 1;
  return L;
}

int64_t apex1_loader_num_sequences(void* h) {
  return h ? static_cast<TokenLoader*>(h)->n_seqs : -1;
}

// Fill out (batch, seq_len) int32 with the tokens of global step `step`.
// Row r reads epoch-permuted sequence ((step*batch + r) % n_seqs) of epoch
// ((step*batch + r) / n_seqs). Returns 0 on success.
int apex1_loader_next(void* h, int64_t step, int32_t* out, int threads) {
  if (!h || step < 0) return 1;
  auto* L = static_cast<TokenLoader*>(h);
  parallel_for(L->batch, threads, [&](int64_t r) {
    uint64_t g = static_cast<uint64_t>(step) * L->batch + r;
    uint64_t epoch = g / L->n_seqs;
    int64_t s = L->perm(epoch, g % L->n_seqs);
    const uint8_t* src = L->map + s * L->seq_len * L->dtype_size;
    int32_t* dst = out + r * L->seq_len;
    if (L->dtype_size == 2) {
      auto* p = reinterpret_cast<const uint16_t*>(src);
      for (int64_t i = 0; i < L->seq_len; ++i) dst[i] = p[i];
    } else {
      std::memcpy(dst, src, L->seq_len * 4);
    }
  });
  return 0;
}

// Fetch ONE sequence by raw index (no permutation) — the building block
// for multi-shard datasets whose global shuffle lives above the shards.
int apex1_loader_fetch(void* h, int64_t seq_index, int32_t* out) {
  if (!h) return 1;
  auto* L = static_cast<TokenLoader*>(h);
  if (seq_index < 0 || seq_index >= L->n_seqs) return 2;
  const uint8_t* src = L->map + seq_index * L->seq_len * L->dtype_size;
  if (L->dtype_size == 2) {
    auto* p = reinterpret_cast<const uint16_t*>(src);
    for (int64_t i = 0; i < L->seq_len; ++i) out[i] = p[i];
  } else {
    std::memcpy(out, src, L->seq_len * 4);
  }
  return 0;
}

void apex1_loader_close(void* h) {
  if (!h) return;
  auto* L = static_cast<TokenLoader*>(h);
  munmap(const_cast<uint8_t*>(L->map), L->map_len);
  delete L;
}

// Packed-batch PLAN (the policy half of runtime.pack_documents): greedy
// first-fit of doc chunks over a bounded window of open rows — must
// match the Python fallback's semantics exactly (same MAX_OPEN window,
// same age eviction). Outputs one record per chunk into caller-allocated
// arrays sized n_chunks = sum(ceil(len/seq_len)); returns the row count.
int64_t apex1_pack_plan(const int64_t* doc_lens, const int64_t* doc_starts,
                        int64_t n_docs, int64_t seq_len,
                        int restart_positions, int64_t* starts,
                        int64_t* lens, int64_t* row, int64_t* col,
                        int32_t* seg, int32_t* pos0) {
  constexpr int64_t kMaxOpen = 256;
  std::vector<int64_t> space, fill;
  std::vector<int32_t> nseg;
  std::vector<int64_t> open;  // age-ordered open-row window
  int64_t ci = 0;
  for (int64_t d = 0; d < n_docs; ++d) {
    for (int64_t lo = 0; lo < doc_lens[d]; lo += seq_len) {
      int64_t ln = std::min(seq_len, doc_lens[d] - lo);
      int64_t r = -1;
      for (size_t k = 0; k < open.size(); ++k) {
        if (space[open[k]] >= ln) { r = open[k]; break; }
      }
      if (r < 0) {
        r = static_cast<int64_t>(space.size());
        space.push_back(seq_len);
        fill.push_back(0);
        nseg.push_back(0);
        if (ln < seq_len) {  // full rows never enter the window
          open.push_back(r);
          if (static_cast<int64_t>(open.size()) > kMaxOpen)
            open.erase(open.begin());  // evict by age, stays bounded
        }
      }
      starts[ci] = doc_starts[d] + lo;
      lens[ci] = ln;
      row[ci] = r;
      col[ci] = fill[r];
      seg[ci] = nseg[r];
      pos0[ci] = restart_positions ? 0 : static_cast<int32_t>(lo);
      space[r] -= ln;
      fill[r] += ln;
      nseg[r] += 1;
      if (space[r] == 0) {
        for (size_t k = 0; k < open.size(); ++k) {
          if (open[k] == r) { open.erase(open.begin() + k); break; }
        }
      }
      ++ci;
    }
  }
  return static_cast<int64_t>(space.size());
}

// Packed-batch fill (the byte-moving half of runtime.pack_documents —
// placement comes from apex1_pack_plan or the Python fallback):
// chunk i is flat_tokens[starts[i] : starts[i]+lens[i]], destined for
// (row[i], col[i]) with segment id seg[i] and first position pos0[i].
// tokens/segments/positions are (n_rows, seq_len) int32; this fills the
// pad/-1/0 background by row, then scatters all chunks — both passes
// threaded.
void apex1_pack_fill(const int32_t* flat_tokens, const int64_t* starts,
                     const int64_t* lens, const int64_t* row,
                     const int64_t* col, const int32_t* seg,
                     const int32_t* pos0, int64_t n_chunks,
                     int32_t* tokens, int32_t* segments,
                     int32_t* positions, int64_t n_rows,
                     int64_t seq_len, int32_t pad_id, int threads) {
  parallel_for(n_rows, threads, [&](int64_t r) {
    int32_t* t = tokens + r * seq_len;
    int32_t* s = segments + r * seq_len;
    int32_t* p = positions + r * seq_len;
    for (int64_t i = 0; i < seq_len; ++i) t[i] = pad_id;
    for (int64_t i = 0; i < seq_len; ++i) s[i] = -1;
    std::memset(p, 0, seq_len * 4);
  });
  parallel_for(n_chunks, threads, [&](int64_t i) {
    int64_t off = row[i] * seq_len + col[i];
    std::memcpy(tokens + off, flat_tokens + starts[i], lens[i] * 4);
    int32_t* s = segments + off;
    int32_t* p = positions + off;
    for (int64_t j = 0; j < lens[i]; ++j) s[j] = seg[i];
    for (int64_t j = 0; j < lens[i]; ++j) p[j] = pos0[i] + j;
  });
}

int apex1_runtime_abi_version() { return 4; }

}  // extern "C"
