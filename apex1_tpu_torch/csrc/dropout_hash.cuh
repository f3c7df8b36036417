// The counter hash of apex1_tpu/ops/stochastic.py::hash_bits_u32, shared
// by the dropout kernels (bias_dropout_add.cu, flash_attn.cu).
//
//   s    = mix32(mix32(seed + GOLDEN) ^ salt * C_ROW)   a stream key
//   h    = mix32(s ^ row * C_ROW)                        a row key
//   bits = mix32(h ^ col * C_COL)                        one word
//   keep = bits >= threshold_u32(p) = round(p * 2^32)
//
// Plain 32-bit unsigned arithmetic: products wrap mod 2^32, as the
// reference's uint32 lanes do, so the mask equals the reference's XLA and
// interpret-mode masks bit for bit at the same (seed, salt, row, col).
// The stream key is per launch (row kernels) or per (batch, head)
// (attention), the row key per row: an element costs one mix32.
#pragma once

#include <stdint.h>

constexpr uint32_t kGolden = 0x9E3779B9u;  // 2^32 / golden ratio
constexpr uint32_t kCRow = 0x85EBCA6Bu;    // murmur3 finalizer constants
constexpr uint32_t kCCol = 0xC2B2AE35u;

__host__ __device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

__host__ __device__ __forceinline__ uint32_t stream_key(uint32_t seed,
                                                        uint32_t salt) {
  return mix32(mix32(seed + kGolden) ^ salt * kCRow);
}

__host__ __device__ __forceinline__ uint32_t row_key(uint32_t key,
                                                     uint32_t row) {
  return mix32(key ^ row * kCRow);
}

__host__ __device__ __forceinline__ bool keep_bit(uint32_t rk, uint32_t col,
                                                  uint32_t thr) {
  return mix32(rk ^ col * kCCol) >= thr;
}
