// Shared helpers for the port's kernels: dtype codes (kept in step with
// ops/_common.py::DTYPE_CODES), loads to f32 and stores from f32, warp
// reductions, and the programmatic dependent launch of a second pass.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// programmatic dependent launch (Hopper): a kernel launched by
// `launch_after` may be scheduled while the kernel before it on the
// stream finishes (once every block of that kernel has called
// `let_next_start` or ended), and waits in `wait_prior` until its writes
// are visible: a short second pass does not pay a whole launch
__device__ __forceinline__ void wait_prior() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void let_next_start() {
  asm volatile("griddepcontrol.launch_dependents;");
}

// launch records: while recording is on (apex1_launch_record(1), in
// launch_records.cu), every launch site notes its kernel's attributes as
// cudaFuncGetAttributes reads them (static shared memory, registers a
// thread, the most threads a block) beside the dynamic shared memory and
// the threads a block it passes, so that the budget model
// (apex1_tpu_torch/vmem_model.py) is held against what really launched.
// Off (the default), a launch site tests one flag.
struct LaunchRecord {
  int static_smem, regs, max_threads, dyn_smem, threads, local_bytes;
};
constexpr int kMaxLaunchRecords = 64;
inline bool g_launch_recording = false;
inline int g_launch_count = 0;
inline LaunchRecord g_launch_records[kMaxLaunchRecords];

template <typename K>
inline void note_launch(K* kern, size_t smem, int threads) {
  if (!g_launch_recording || g_launch_count >= kMaxLaunchRecords) return;
  cudaFuncAttributes fa{};
  if (cudaFuncGetAttributes(&fa, reinterpret_cast<const void*>(kern)) !=
      cudaSuccess)
    return;
  g_launch_records[g_launch_count++] = {
      static_cast<int>(fa.sharedSizeBytes), fa.numRegs,
      fa.maxThreadsPerBlock, static_cast<int>(smem), threads,
      static_cast<int>(fa.localSizeBytes)};
}

template <typename... Params, typename... Args>
cudaError_t launch_after_smem(void (*kern)(Params...), dim3 grid,
                              dim3 block, size_t smem, cudaStream_t st,
                              Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  note_launch(kern, smem, static_cast<int>(block.x * block.y * block.z));
  return cudaLaunchKernelEx(&cfg, kern, args...);
}

template <typename... Params, typename... Args>
cudaError_t launch_after(void (*kern)(Params...), dim3 grid, dim3 block,
                         cudaStream_t st, Args... args) {
  return launch_after_smem(kern, grid, block, 0, st, args...);
}

static inline cudaStream_t as_stream(void* s) {
  return reinterpret_cast<cudaStream_t>(s);
}
