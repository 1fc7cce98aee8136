// K2 and K4 - the probed-blocks stream over the bf16 residual table.
//
// K2 replaces vector_indexer_tpu/ops/pallas/block_stream.py:_kernel_factory
// (reached through block_stream_search -> _block_stream_call, cross term
// _cross_term/_bf16_cross). K4 replaces _fused_kernel_factory (reached
// through block_stream_search -> _block_stream_fused_call).
//
// A task is one (query, slot) pair: slot s of query q scores the `chunk`
// residual rows r^ of stream block blk[q, s] against qc = q - c (l2; c is
// the slot's cluster centroid) or q (ip):
//     l2:  bias - 2 qc.r^ + |r^|^2      (bias = |q - c|^2)
//     ip:  bias - q.r^ + penalty        (bias = -q.c; penalty = the stored
//                                        norm on sentinel pad rows, else 0)
// The cross term is f32 FMA over bf16 rows widened exactly by
// __bfloat162float, so it is the exact dot with the quantized row up to f32
// summation order - the contract the TPU kernel's hi/lo split reaches.
//
// K2 writes every task's chunk-wide distance row to out (nq, t_fixed,
// chunk); lane masking and selection stay in PyTorch, as in the reference.
// K4 keeps the selection on chip: one block per query walks the slots in
// the reference's fold order (local slot u outer, fan f inner; slot
// s = f * t_sub + u feeds group g = f % G) and folds each lane below the
// slot's valid count into that (group, lane)'s best and second-best
// (value, slot) pair in shared memory. Only the (2 G chunk)-wide planes
// reach device memory.
//
// Both compute a row's dot with one warp: lanes stride over d (coalesced
// 64-byte reads of the bf16 row), then a shuffle sum.
//
// Bound on the H100: bytes. Each task reads chunk * d * 2 bytes of table
// (64 KB at chunk 256, d 128) for 2 * chunk * d FLOPs - 1 FLOP/byte, far
// below the card's ~20 FLOP/byte f32 balance, so 3.35 TB/s is the roofline.
// The simple design leaves on the table: TMA/cp.async prefetch of the next
// block while the current one is scored, 16-byte vector loads, several
// rows per warp to hide the shuffle, and (for K4) more than one block per
// query so that small batches fill the 132 SMs.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float row_dot(const float* __restrict__ qc_s,
                                         const __nv_bfloat16* __restrict__ row,
                                         int d, int lane) {
  float acc = 0.f;
  for (int t = lane; t < d; t += 32) acc = fmaf(qc_s[t], __bfloat162float(row[t]), acc);
  return vitorch::warp_sum(acc);
}

template <bool L2>
__device__ __forceinline__ float task_distance(float bias, float dot, float nrm) {
  if (L2) return bias - 2.f * dot + nrm;
  return bias - dot + (nrm >= VITORCH_SENTINEL ? nrm : 0.f);
}

// Stage the task's query-side row (q - c for l2, q for ip) in shared memory.
template <bool L2>
__device__ __forceinline__ void load_qc(float* qc_s, const float* __restrict__ queries,
                                        const float* __restrict__ cent, int q, int cid,
                                        int d) {
  for (int t = threadIdx.x; t < d; t += blockDim.x) {
    const float qv = queries[(size_t)q * d + t];
    qc_s[t] = L2 ? qv - cent[(size_t)cid * d + t] : qv;
  }
}

template <bool L2>
__global__ void __launch_bounds__(THREADS) stream_distances_kernel(
    const float* __restrict__ queries, const float* __restrict__ cent,
    const int* __restrict__ cid2d, const int* __restrict__ blk2d,
    const float* __restrict__ bias2d, const __nv_bfloat16* __restrict__ vecs,
    const float* __restrict__ norms, int t_fixed, int chunk, int d,
    float* __restrict__ out) {
  extern __shared__ float qc_s[];  // d floats
  const size_t task = blockIdx.x;  // q * t_fixed + s
  const int q = static_cast<int>(task / t_fixed);
  load_qc<L2>(qc_s, queries, cent, q, cid2d[task], d);
  __syncthreads();
  const size_t base = (size_t)blk2d[task] * chunk;
  const float bias = bias2d[task];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int l = warp; l < chunk; l += THREADS / 32) {
    const size_t srow = base + l;
    const float dot = row_dot(qc_s, vecs + srow * d, d, lane);
    if (lane == 0) out[task * chunk + l] = task_distance<L2>(bias, dot, norms[srow]);
  }
}

template <bool L2>
__global__ void __launch_bounds__(THREADS) stream_fused_plane_kernel(
    const float* __restrict__ queries, const float* __restrict__ cent,
    const int* __restrict__ cid2d, const int* __restrict__ blk2d,
    const int* __restrict__ nval2d, const float* __restrict__ bias2d,
    const __nv_bfloat16* __restrict__ vecs, const float* __restrict__ norms,
    int t_fixed, int t_sub, int chunk, int groups, int d,
    float* __restrict__ dist_plane, int* __restrict__ slot_plane) {
  extern __shared__ float smem[];
  const int width = groups * chunk;
  float* qc_s = smem;               // d
  float* dist_s = qc_s + d;         // chunk
  float* best_v = dist_s + chunk;   // width
  float* second_v = best_v + width; // width
  int* best_s = reinterpret_cast<int*>(second_v + width);  // width
  int* second_s = best_s + width;                           // width

  const int q = blockIdx.x;
  const int fan = t_fixed / t_sub;
  for (int e = threadIdx.x; e < width; e += blockDim.x) {
    best_v[e] = vitorch::inf_f();
    second_v[e] = vitorch::inf_f();
    best_s[e] = -1;
    second_s[e] = -1;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int u = 0; u < t_sub; ++u) {
    for (int f = 0; f < fan; ++f) {
      const int s = f * t_sub + u;
      const size_t task = (size_t)q * t_fixed + s;
      const int nval = nval2d[task];
      // Lanes at or past nval are +inf in the reference, and an inf never
      // displaces a plane entry: an empty slot folds to nothing. (nval is
      // uniform across the block, so every thread skips together.)
      if (nval <= 0) continue;
      load_qc<L2>(qc_s, queries, cent, q, cid2d[task], d);
      __syncthreads();
      const size_t base = (size_t)blk2d[task] * chunk;
      const float bias = bias2d[task];
      for (int l = warp; l < nval; l += THREADS / 32) {
        const size_t srow = base + l;
        const float dot = row_dot(qc_s, vecs + srow * d, d, lane);
        if (lane == 0) dist_s[l] = task_distance<L2>(bias, dot, norms[srow]);
      }
      __syncthreads();
      const int off = (f % groups) * chunk;
      for (int l = threadIdx.x; l < nval; l += blockDim.x) {
        const float dv = dist_s[l];
        const int e = off + l;
        const float b = best_v[e];
        const int bi = best_s[e];
        const bool better = dv < b;
        const float disp = better ? b : dv;   // the displaced candidate
        const int disp_i = better ? bi : s;
        if (better) {
          best_v[e] = dv;
          best_s[e] = s;
        }
        if (disp < second_v[e]) {
          second_v[e] = disp;
          second_s[e] = disp_i;
        }
      }
      __syncthreads();  // dist_s and qc_s are rewritten by the next task
    }
  }

  float* dp = dist_plane + (size_t)q * 2 * width;
  int* sp = slot_plane + (size_t)q * 2 * width;
  for (int e = threadIdx.x; e < width; e += blockDim.x) {
    dp[e] = best_v[e];
    dp[width + e] = second_v[e];
    sp[e] = best_s[e];
    sp[width + e] = second_s[e];
  }
}

}  // namespace

VITORCH_API int vitorch_stream_distances(
    const void* queries, const void* cent, const void* cid2d, const void* blk2d,
    const void* bias2d, const void* vecs, const void* norms, int nq, int t_fixed,
    int chunk, int d, int is_l2, void* out, void* stream) {
  const size_t tasks = (size_t)nq * t_fixed;
  if (tasks > 0) {
    const size_t smem = sizeof(float) * d;
    auto st = static_cast<cudaStream_t>(stream);
    auto kern = is_l2 ? stream_distances_kernel<true> : stream_distances_kernel<false>;
    kern<<<dim3(static_cast<unsigned>(tasks)), THREADS, smem, st>>>(
        static_cast<const float*>(queries), static_cast<const float*>(cent),
        static_cast<const int*>(cid2d), static_cast<const int*>(blk2d),
        static_cast<const float*>(bias2d), static_cast<const __nv_bfloat16*>(vecs),
        static_cast<const float*>(norms), t_fixed, chunk, d,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

VITORCH_API int vitorch_stream_fused_plane(
    const void* queries, const void* cent, const void* cid2d, const void* blk2d,
    const void* nval2d, const void* bias2d, const void* vecs, const void* norms,
    int nq, int t_fixed, int t_sub, int chunk, int groups, int d, int is_l2,
    void* dist_plane, void* slot_plane, void* stream) {
  if (nq > 0) {
    const int width = groups * chunk;
    const size_t smem = sizeof(float) * ((size_t)d + chunk + 4 * (size_t)width);
    auto kern = is_l2 ? stream_fused_plane_kernel<true> : stream_fused_plane_kernel<false>;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kern<<<dim3(nq), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(queries), static_cast<const float*>(cent),
        static_cast<const int*>(cid2d), static_cast<const int*>(blk2d),
        static_cast<const int*>(nval2d), static_cast<const float*>(bias2d),
        static_cast<const __nv_bfloat16*>(vecs), static_cast<const float*>(norms),
        t_fixed, t_sub, chunk, groups, d, static_cast<float*>(dist_plane),
        static_cast<int*>(slot_plane));
  }
  return static_cast<int>(cudaGetLastError());
}
