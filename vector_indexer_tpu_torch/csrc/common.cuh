// Shared declarations of the port's CUDA kernels.
//
// Every entry point has a plain C interface (loaded from Python with
// ctypes): pointers and the stream arrive as void*, sizes as int. An entry
// point launches its kernel on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() so that a refused
// launch (too many threads, too much shared memory) is reported.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define VITORCH_API extern "C" __attribute__((visibility("default")))

// Rows at or above this stored norm are layout gap/tail/pad sentinels
// (storage/layout.py SENTINEL_NORM = 1e30).
#define VITORCH_SENTINEL 1e29f

namespace vitorch {

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// Sum of a float across the 32 lanes of a warp; every lane gets the sum.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace vitorch
