// 16-byte chunks of a row held in registers: the memory-bound row passes
// (the norm forward and backward, the softmax forward) load and store
// their rows as uint4 and widen them to fp32 in registers.
#pragma once

#include "common.cuh"

// N values of G at p (16-byte aligned) as P = N·sizeof(G)/16 16-byte
// pieces, and those pieces widened to fp32
template <typename G, int N>
struct Pieces {
  static constexpr int P = N * int(sizeof(G)) / 16;
  static_assert(P * 16 == N * int(sizeof(G)), "16-byte pieces");
  static __device__ __forceinline__ void load(const G* p, uint4 (&r)[P]) {
#pragma unroll
    for (int i = 0; i < P; ++i) r[i] = reinterpret_cast<const uint4*>(p)[i];
  }
  static __device__ __forceinline__ void widen(const uint4 (&r)[P],
                                               float (&v)[N]) {
    alignas(16) G buf[N];
#pragma unroll
    for (int i = 0; i < P; ++i) reinterpret_cast<uint4*>(buf)[i] = r[i];
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = to_f32(buf[i]);
  }
};

// one 16-byte chunk of T as fp32 values, and back
template <typename T>
struct Chunk {
  static constexpr int N = 16 / int(sizeof(T));
  static __device__ __forceinline__ void widen(uint4 raw, float (&v)[N]) {
    alignas(16) T buf[N];
    *reinterpret_cast<uint4*>(buf) = raw;
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = to_f32(buf[i]);
  }
  static __device__ __forceinline__ uint4 narrow(const float (&v)[N]) {
    alignas(16) T buf[N];
#pragma unroll
    for (int i = 0; i < N; ++i) buf[i] = from_f32<T>(v[i]);
    return *reinterpret_cast<uint4*>(buf);
  }
};

static inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}
