// Hopper tensor-core building blocks shared by K1 (assign.cu) and K3 / K7
// (flat_sweep.cu): wgmma descriptors and issue (raw PTX, sm_90a), TMA 2D
// loads of 128-byte-swizzled K panels, the 3xTF32 split, and the
// cuTensorMapEncodeTiled lookup through the runtime.
//
// Operands are K-major and stored in "panels": a panel holds `rows` rows of
// 128 bytes of K (32 f32 or 128 int8 values), 128B-swizzled, so a wgmma
// descriptor walks it in k8 (tf32) or k32 (s8) steps of 32 bytes. One
// m64n64 product leaves GMMA_NACC = 32 accumulator elements per thread of
// the warpgroup; element i of thread t sits at row
//     (t / 32) * 16 + (t % 32) / 4 + 8 * ((i >> 1) & 1)
// and column
//     (t % 4) * 2 + 8 * (i >> 2) + (i & 1)
// of the 64 x 64 tile.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace vitorch {

constexpr int GMMA_SPAN = 128;  // bytes of K per panel (the 128B swizzle span)
constexpr int GMMA_NACC = 32;   // f32 / s32 accumulator elements per thread of an m64n64 product

// Shared-memory matrix descriptor, K-major, 128-byte swizzle: 8-row groups
// 1024 B apart (SBO), the leading offset unused for this layout.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous product's issue and wait.
__device__ __forceinline__ void fence_regs(float (&r)[GMMA_NACC]) {
#pragma unroll
  for (int i = 0; i < GMMA_NACC; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(int (&r)[GMMA_NACC]) {
#pragma unroll
  for (int i = 0; i < GMMA_NACC; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define VITORCH_ACC32(C, A)                                                                      \
  C(A[0]), C(A[1]), C(A[2]), C(A[3]), C(A[4]), C(A[5]), C(A[6]), C(A[7]), C(A[8]), C(A[9]),      \
      C(A[10]), C(A[11]), C(A[12]), C(A[13]), C(A[14]), C(A[15]), C(A[16]), C(A[17]), C(A[18]),  \
      C(A[19]), C(A[20]), C(A[21]), C(A[22]), C(A[23]), C(A[24]), C(A[25]), C(A[26]), C(A[27]),  \
      C(A[28]), C(A[29]), C(A[30]), C(A[31])
#define VITORCH_F(x) "+f"(x)
#define VITORCH_R(x) "+r"(x)
#define VITORCH_OPS32                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "

// d (64 x 64 f32) (+)= A (64 x 8 tf32) . B (64 x 8 tf32)^T
__device__ __forceinline__ void wgmma_tf32(float (&d)[GMMA_NACC], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " VITORCH_OPS32
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : VITORCH_ACC32(VITORCH_F, d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 s32) (+)= A (64 x 32 s8) . B (64 x 32 s8)^T
__device__ __forceinline__ void wgmma_s8(int (&d)[GMMA_NACC], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " VITORCH_OPS32
      "%32, %33, p;\n"
      "}\n"
      : VITORCH_ACC32(VITORCH_R, d)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// a = big + small with big = tf32(a), small = tf32(a - big), both rounded to
// nearest (their low 13 mantissa bits are zero, so the tensor cores read
// them exactly).
__device__ __forceinline__ float tf32_rna(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return __uint_as_float(r);
}
__device__ __forceinline__ void split_tf32(float4 v, float4& big, float4& small) {
  big = make_float4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z), tf32_rna(v.w));
  small = make_float4(tf32_rna(v.x - big.x), tf32_rna(v.y - big.y), tf32_rna(v.z - big.z),
                      tf32_rna(v.w - big.w));
}

// Byte offset of 16-byte chunk `kc` (along K) of row `r` in a K-major,
// 128B-swizzled operand whose panels hold `panel_bytes` bytes.
__device__ __forceinline__ int swizzled(int r, int kc, int panel_bytes) {
  return (kc >> 3) * panel_bytes + r * GMMA_SPAN + (((kc & 7) ^ (r & 7)) << 4);
}

// A kernel has a host-side stub with external linkage, so each source that
// includes this header gets its own copy (unnamed namespace).
namespace {

// f32 rows (n4 float4s in all) -> their tf32 big and small parts.
__global__ void split_tf32_kernel(const float4* __restrict__ src, size_t n4,
                                  float4* __restrict__ big, float4* __restrict__ small) {
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; e < n4;
       e += static_cast<size_t>(gridDim.x) * blockDim.x)
    split_tf32(src[e], big[e], small[e]);
}

// Launch split_tf32_kernel over `floats` floats (a multiple of 4).
inline cudaError_t split_tf32_rows(const void* src, size_t floats, void* big, void* small,
                                   cudaStream_t st) {
  const size_t n4 = floats / 4;
  if (n4 == 0) return cudaGetLastError();
  const size_t blocks = (n4 + 255) / 256;
  split_tf32_kernel<<<blocks < 4096 ? static_cast<unsigned>(blocks) : 4096u, 256, 0, st>>>(
      static_cast<const float4*>(src), n4, static_cast<float4*>(big),
      static_cast<float4*>(small));
  return cudaGetLastError();
}

}  // namespace

// ---- host side ---------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (so the
// library links against no driver stub).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &res);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (res == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2D map over a K-major (rows, d) operand whose box is one panel: `box_rows`
// rows x 128 bytes, 128B-swizzled; rows past the operand and columns past d
// read as zeros.
inline bool make_panel_map(CUtensorMap* map, const void* base, bool f32, int d, int rows,
                           int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const int esize = f32 ? 4 : 1;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows > 0 ? rows : 1)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * esize};
  cuuint32_t box[2] = {static_cast<cuuint32_t>(GMMA_SPAN / esize),
                       static_cast<cuuint32_t>(box_rows)};
  cuuint32_t estr[2] = {1, 1};
  return fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
            const_cast<void*>(base), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace vitorch
