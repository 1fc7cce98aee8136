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

// ---------------------------------------------------------------------------
// Hopper asynchronous staging: mbarriers and bulk copies (PTX, sm_90).
// A ring of shared-memory stages has a "full" barrier per stage (one
// producer arrival plus the copy's transaction bytes) and an "empty"
// barrier per stage (one arrival per consumer that has finished reading).
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Make the barriers' initialisation visible before any thread uses them.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Spin until the barrier's phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Contiguous global -> shared copy of `bytes` (a multiple of 16, both
// addresses 16-byte aligned), completing on `bar`'s transaction count.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Order this thread's generic-proxy shared-memory writes before later
// asynchronous-proxy accesses (wgmma operand reads, bulk copies).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier over `count` threads (a multiple of 32) on hardware barrier `id`
// (1-15; 0 is __syncthreads).
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

}  // namespace vitorch
