// K5 - the block-major shared stream: one stream block scored against the
// up to Q_SHARE = 8 queries that probe it.
//
// Replaces vector_indexer_tpu/ops/pallas/block_stream.py:
// _shared_kernel_factory (reached through block_stream_search_shared ->
// _block_stream_shared_call).
//
// A task is one (block, <= 8 query rows) group built in PyTorch by
// inverting the (query, slot) pairs (ops/block_stream.py::
// build_shared_tasks). Task t scores the `chunk` residual rows r^ of block
// blk[t] against its 8 pre-subtracted query rows qc[t, j] (q - c for l2, q
// for ip) and writes the task-major plane rows plane[t, j, :]:
//     l2:  |r^|^2 - 2 qc.r^              ip:  penalty - q.r^
// (penalty = the stored norm on sentinel pad rows, else 0). The per-pair
// lane-constant bias (|q - c|^2 or -q.c) is added in PyTorch after the
// gather back to query order, as in the reference. Pad rows of a cluster's
// last block are zero with a 1e30 norm, so their lanes stay >= 1e29 and
// never become results; no lane mask is needed. A task with blk[t] < 0 is
// unused (the task budget t_cap exceeds the task count) and writes nothing:
// no pair reads its rows.
//
// The row type is a template parameter, as in K2/K4: bf16 and f32 rows
// widen exactly, int8 rows are scaled once per task by the owning
// cluster's scale scl[t], so each cross term is the exact dot with the
// stored (dequantized) row up to f32 summation order.
//
// One CUDA block per task. The 8 query rows sit in shared memory; each warp
// reads a table row once (lanes stride over d) and accumulates its 8 dots,
// which is where the sharing pays: the row's bytes serve 8 queries. The 8
// partial sums are reduced across the warp by a transpose-reduce (9
// shuffles instead of 8 x 5), after which lane 4j holds query j's dot.
//
// Bound on the H100: bytes, with 8x the arithmetic intensity of K2 (up to
// 16 FLOP/byte on an int8 table). The TPU design's FAN_S (8 tasks per
// grid step, amortising Mosaic's per-step cost) is dropped: a CUDA block
// per task costs nothing comparable. Left for later: tensor cores for the
// (8, d) x (d, chunk) product (mma.sync m16n8k16 with the 8 queries as N),
// cp.async/TMA prefetch of the next block, 16-byte loads, dp4a for int8.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int QS = 8;  // query rows per task (Q_SHARE in ops/block_stream.py)

// acc[0..7] per lane -> lane 4j (j < 8) returns the warp-wide sum of acc[j];
// the other lanes return partial sums.
__device__ __forceinline__ float reduce8(float (&acc)[QS], int lane) {
  float a4[4], a2[2];
  const bool hi16 = lane & 16, hi8 = lane & 8, hi4 = lane & 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = hi16 ? acc[i] : acc[i + 4];
    const float keep = hi16 ? acc[i + 4] : acc[i];
    a4[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = hi8 ? a4[i] : a4[i + 2];
    const float keep = hi8 ? a4[i + 2] : a4[i];
    a2[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  const float send = hi4 ? a2[0] : a2[1];
  float a1 = (hi4 ? a2[1] : a2[0]) + __shfl_xor_sync(0xffffffffu, send, 4);
  a1 += __shfl_xor_sync(0xffffffffu, a1, 2);
  a1 += __shfl_xor_sync(0xffffffffu, a1, 1);
  return a1;  // lane L holds the sum for query (L >> 2)
}

template <bool L2, typename T>
__global__ void __launch_bounds__(THREADS) stream_shared_plane_kernel(
    const float* __restrict__ qc, const int* __restrict__ blk_t,
    const float* __restrict__ scl_t, const T* __restrict__ vecs,
    const float* __restrict__ norms, int chunk, int d, float* __restrict__ plane) {
  extern __shared__ float qc_s[];  // QS * d floats
  const int task = blockIdx.x;
  const int blk = blk_t[task];
  if (blk < 0) return;  // unused task: uniform across the block
  const float* src = qc + (size_t)task * QS * d;
  for (int e = threadIdx.x; e < QS * d; e += blockDim.x) qc_s[e] = src[e];
  __syncthreads();

  // int8 rows carry the task's cluster scale; the others are stored as is.
  const float scl = sizeof(T) == 1 ? scl_t[task] : 1.f;
  const size_t base = (size_t)blk * chunk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* out = plane + (size_t)task * QS * chunk;
  for (int l = warp; l < chunk; l += THREADS / 32) {
    const T* row = vecs + (base + l) * d;
    float acc[QS];
#pragma unroll
    for (int j = 0; j < QS; ++j) acc[j] = 0.f;
    for (int t = lane; t < d; t += 32) {
      const float x = vitorch::widen(row[t]);
#pragma unroll
      for (int j = 0; j < QS; ++j) acc[j] = fmaf(qc_s[j * d + t], x, acc[j]);
    }
    const float dot = reduce8(acc, lane) * scl;
    if ((lane & 3) == 0) {
      const float nrm = norms[base + l];
      const float v = L2 ? nrm - 2.f * dot : (nrm >= VITORCH_SENTINEL ? nrm : 0.f) - dot;
      out[(size_t)(lane >> 2) * chunk + l] = v;
    }
  }
}

template <bool L2, typename T>
int launch_shared(const void* qc, const void* blk_t, const void* scl_t, const void* vecs,
                  const void* norms, int t_cap, int chunk, int d, void* plane,
                  cudaStream_t st) {
  const size_t smem = sizeof(float) * QS * (size_t)d;
  auto kern = stream_shared_plane_kernel<L2, T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<dim3(t_cap), THREADS, smem, st>>>(
      static_cast<const float*>(qc), static_cast<const int*>(blk_t),
      static_cast<const float*>(scl_t), static_cast<const T*>(vecs),
      static_cast<const float*>(norms), chunk, d, static_cast<float*>(plane));
  return 0;
}

}  // namespace

VITORCH_API int vitorch_stream_shared_plane(const void* qc, const void* blk_t,
                                            const void* scl_t, const void* vecs,
                                            const void* norms, int t_cap, int q_share,
                                            int chunk, int d, int is_l2, int row_type,
                                            void* plane, void* stream) {
  if (q_share != QS) return static_cast<int>(cudaErrorInvalidValue);
  if (t_cap <= 0) return static_cast<int>(cudaGetLastError());
  auto st = static_cast<cudaStream_t>(stream);
  int rc = 0;
#define VITORCH_K5(L2, T) \
  rc = launch_shared<L2, T>(qc, blk_t, scl_t, vecs, norms, t_cap, chunk, d, plane, st)
  switch (row_type) {
    case vitorch::ROW_BF16:
      if (is_l2) VITORCH_K5(true, __nv_bfloat16); else VITORCH_K5(false, __nv_bfloat16);
      break;
    case vitorch::ROW_INT8:
      if (is_l2) VITORCH_K5(true, int8_t); else VITORCH_K5(false, int8_t);
      break;
    case vitorch::ROW_F32:
      if (is_l2) VITORCH_K5(true, float); else VITORCH_K5(false, float);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VITORCH_K5
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
