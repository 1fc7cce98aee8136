// K2 and K4 - the probed-blocks stream over the residual stream table.
//
// K2 replaces vector_indexer_tpu/ops/pallas/block_stream.py:_kernel_factory
// (reached through block_stream_search -> _block_stream_call, cross term
// _cross_term with _bf16_cross / _int8_cross / the f32 HIGHEST dot). K4
// replaces _fused_kernel_factory (reached through block_stream_search ->
// _block_stream_fused_call).
//
// A task is one (query, slot) pair: slot s of query q scores the `chunk`
// residual rows r^ of stream block blk[q, s] against qc = q - c (l2; c is
// the slot's cluster centroid) or q (ip):
//     l2:  bias - 2 qc.r^ + |r^|^2      (bias = |q - c|^2)
//     ip:  bias - q.r^ + penalty        (bias = -q.c; penalty = the stored
//                                        norm on sentinel pad rows, else 0)
// The row type is a template parameter (ROW_* codes below):
//   bf16  - rows widened exactly by __bfloat162float;
//   int8  - rows hold round(r / s_c); each element widens exactly to f32,
//           the dot (q-c).x8 is f32 FMA, and the task's cluster scale
//           scales[cid] multiplies it once: the exact dot with the
//           dequantized row s_c x8, up to f32 summation order (the TPU
//           kernel splits the query into two int8 passes instead, which
//           leaves a per-component query error of <= s1/254);
//   f32   - the exact f32 dot (the reference's HIGHEST-precision dot).
// So the cross term is the exact dot with the stored row up to f32
// summation order, and the norms (of the stored, dequantized rows) make
// the distance exact to the quantized point.
//
// K2 writes every task's chunk-wide distance row to out (nq, t_fixed,
// chunk); lane masking and selection stay in PyTorch, as in the reference.
// K4 keeps the selection on chip: one block per query walks the slots in
// the reference's fold order (local slot u outer, fan f inner; slot
// s = f * t_sub + u feeds group g = f % G) and folds each lane below the
// slot's valid count into that (group, lane)'s best and second-best
// (value, slot) pair in shared memory. Only the (2 G chunk)-wide planes
// reach device memory. K4 takes bf16 and int8 tables (the f32 table serves
// stream_exact, which never fuses).
//
// Both compute a row's dot with one warp: lanes stride over d (coalesced
// reads of the row), then a shuffle sum.
//
// Bound on the H100: bytes. Each task reads chunk * d * itemsize bytes of
// table (64 KB at chunk 256, d 128, bf16; 32 KB int8; 128 KB f32) for
// 2 * chunk * d FLOPs - at most 2 FLOP/byte, far below the card's ~20
// FLOP/byte f32 balance, so 3.35 TB/s is the roofline. The simple design
// leaves on the table: TMA/cp.async prefetch of the next block while the
// current one is scored, 16-byte vector loads (an int8 lane reads 1 byte),
// dp4a for the int8 rows, several rows per warp to hide the shuffle, and
// (for K4) more than one block per query so that small batches fill the
// 132 SMs.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__device__ __forceinline__ float row_dot(const float* __restrict__ qc_s,
                                         const T* __restrict__ row, int d, int lane) {
  float acc = 0.f;
  for (int t = lane; t < d; t += 32) acc = fmaf(qc_s[t], vitorch::widen(row[t]), acc);
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

template <bool L2, typename T>
__global__ void __launch_bounds__(THREADS) stream_distances_kernel(
    const float* __restrict__ queries, const float* __restrict__ cent,
    const int* __restrict__ cid2d, const int* __restrict__ blk2d,
    const float* __restrict__ bias2d, const T* __restrict__ vecs,
    const float* __restrict__ norms, const float* __restrict__ scales, int t_fixed,
    int chunk, int d, float* __restrict__ out) {
  extern __shared__ float qc_s[];  // d floats
  const size_t task = blockIdx.x;  // q * t_fixed + s
  const int q = static_cast<int>(task / t_fixed);
  const int cid = cid2d[task];
  load_qc<L2>(qc_s, queries, cent, q, cid, d);
  __syncthreads();
  const size_t base = (size_t)blk2d[task] * chunk;
  const float bias = bias2d[task];
  const float scl = vitorch::row_scale<T>(scales, cid);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int l = warp; l < chunk; l += THREADS / 32) {
    const size_t srow = base + l;
    const float dot = row_dot(qc_s, vecs + srow * d, d, lane) * scl;
    if (lane == 0) out[task * chunk + l] = task_distance<L2>(bias, dot, norms[srow]);
  }
}

template <bool L2, typename T>
__global__ void __launch_bounds__(THREADS) stream_fused_plane_kernel(
    const float* __restrict__ queries, const float* __restrict__ cent,
    const int* __restrict__ cid2d, const int* __restrict__ blk2d,
    const int* __restrict__ nval2d, const float* __restrict__ bias2d,
    const T* __restrict__ vecs, const float* __restrict__ norms,
    const float* __restrict__ scales, int t_fixed, int t_sub, int chunk, int groups,
    int d, float* __restrict__ dist_plane, int* __restrict__ slot_plane) {
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
      const int cid = cid2d[task];
      load_qc<L2>(qc_s, queries, cent, q, cid, d);
      __syncthreads();
      const size_t base = (size_t)blk2d[task] * chunk;
      const float bias = bias2d[task];
      const float scl = vitorch::row_scale<T>(scales, cid);
      for (int l = warp; l < nval; l += THREADS / 32) {
        const size_t srow = base + l;
        const float dot = row_dot(qc_s, vecs + srow * d, d, lane) * scl;
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

template <bool L2, typename T>
void launch_distances(const void* queries, const void* cent, const void* cid2d,
                      const void* blk2d, const void* bias2d, const void* vecs,
                      const void* norms, const void* scales, size_t tasks, int t_fixed,
                      int chunk, int d, void* out, cudaStream_t st) {
  stream_distances_kernel<L2, T><<<dim3(static_cast<unsigned>(tasks)), THREADS,
                                   sizeof(float) * d, st>>>(
      static_cast<const float*>(queries), static_cast<const float*>(cent),
      static_cast<const int*>(cid2d), static_cast<const int*>(blk2d),
      static_cast<const float*>(bias2d), static_cast<const T*>(vecs),
      static_cast<const float*>(norms), static_cast<const float*>(scales), t_fixed, chunk,
      d, static_cast<float*>(out));
}

template <bool L2, typename T>
int launch_fused(const void* queries, const void* cent, const void* cid2d,
                 const void* blk2d, const void* nval2d, const void* bias2d,
                 const void* vecs, const void* norms, const void* scales, int nq,
                 int t_fixed, int t_sub, int chunk, int groups, int d, void* dist_plane,
                 void* slot_plane, cudaStream_t st) {
  const int width = groups * chunk;
  const size_t smem = sizeof(float) * ((size_t)d + chunk + 4 * (size_t)width);
  auto kern = stream_fused_plane_kernel<L2, T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<dim3(nq), THREADS, smem, st>>>(
      static_cast<const float*>(queries), static_cast<const float*>(cent),
      static_cast<const int*>(cid2d), static_cast<const int*>(blk2d),
      static_cast<const int*>(nval2d), static_cast<const float*>(bias2d),
      static_cast<const T*>(vecs), static_cast<const float*>(norms),
      static_cast<const float*>(scales), t_fixed, t_sub, chunk, groups, d,
      static_cast<float*>(dist_plane), static_cast<int*>(slot_plane));
  return 0;
}

}  // namespace

VITORCH_API int vitorch_stream_distances(
    const void* queries, const void* cent, const void* cid2d, const void* blk2d,
    const void* bias2d, const void* vecs, const void* norms, const void* scales, int nq,
    int t_fixed, int chunk, int d, int is_l2, int row_type, void* out, void* stream) {
  const size_t tasks = (size_t)nq * t_fixed;
  if (tasks == 0) return static_cast<int>(cudaGetLastError());
  auto st = static_cast<cudaStream_t>(stream);
#define VITORCH_K2(L2, T)                                                               \
  launch_distances<L2, T>(queries, cent, cid2d, blk2d, bias2d, vecs, norms, scales, tasks, \
                          t_fixed, chunk, d, out, st)
  switch (row_type) {
    case vitorch::ROW_BF16:
      if (is_l2) VITORCH_K2(true, __nv_bfloat16); else VITORCH_K2(false, __nv_bfloat16);
      break;
    case vitorch::ROW_INT8:
      if (is_l2) VITORCH_K2(true, int8_t); else VITORCH_K2(false, int8_t);
      break;
    case vitorch::ROW_F32:
      if (is_l2) VITORCH_K2(true, float); else VITORCH_K2(false, float);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VITORCH_K2
  return static_cast<int>(cudaGetLastError());
}

VITORCH_API int vitorch_stream_fused_plane(
    const void* queries, const void* cent, const void* cid2d, const void* blk2d,
    const void* nval2d, const void* bias2d, const void* vecs, const void* norms,
    const void* scales, int nq, int t_fixed, int t_sub, int chunk, int groups, int d,
    int is_l2, int row_type, void* dist_plane, void* slot_plane, void* stream) {
  if (nq <= 0) return static_cast<int>(cudaGetLastError());
  auto st = static_cast<cudaStream_t>(stream);
  int rc = 0;
#define VITORCH_K4(L2, T)                                                                 \
  rc = launch_fused<L2, T>(queries, cent, cid2d, blk2d, nval2d, bias2d, vecs, norms, scales, \
                           nq, t_fixed, t_sub, chunk, groups, d, dist_plane, slot_plane, st)
  switch (row_type) {
    case vitorch::ROW_BF16:
      if (is_l2) VITORCH_K4(true, __nv_bfloat16); else VITORCH_K4(false, __nv_bfloat16);
      break;
    case vitorch::ROW_INT8:
      if (is_l2) VITORCH_K4(true, int8_t); else VITORCH_K4(false, int8_t);
      break;
    default:  // K4 has no f32 mode (stream_exact never fuses)
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VITORCH_K4
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
