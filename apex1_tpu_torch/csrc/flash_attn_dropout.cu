// The flash kernels' dropout variants (template DROP = true): a
// translation unit of their own, compiled beside flash_attn.cu, which
// holds the entry points and the variants without dropout.

#include "flash_attn.cuh"

int flash_launch_dropout(int which, const FlashArgs& a, int dtype,
                         cudaStream_t st) {
  return launch_typed<true>(which, a, dtype, st);
}
