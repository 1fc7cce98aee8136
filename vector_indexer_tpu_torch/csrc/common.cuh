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

// Stream-table row types (kernels/build.py ROW_TYPES).
enum RowType { ROW_BF16 = 0, ROW_INT8 = 1, ROW_F32 = 2 };

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// Exact widening of a stored table element to f32.
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float widen(float v) { return v; }

// A cluster's dequant scale: int8 rows hold round(r / s_c); the other row
// types store r itself (their scale is 1).
template <typename T>
__device__ __forceinline__ float row_scale(const float* __restrict__ scales, int cid) {
  return 1.f;
}
template <>
__device__ __forceinline__ float row_scale<int8_t>(const float* __restrict__ scales, int cid) {
  return scales[cid];
}

// Sum of a float across the 32 lanes of a warp; every lane gets the sum.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace vitorch
