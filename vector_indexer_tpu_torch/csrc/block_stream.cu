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
// K2 computes a row's dot with one warp: lanes stride over d (coalesced
// reads of the row), then a shuffle sum.
//
// K4 keeps the selection on chip. The fold of the reference (local slot u
// outer, fan f inner; slot s = f * t_sub + u feeds group g = f % G; each
// lane below the slot's valid count enters that (group, lane)'s best and
// second-best (value, slot) pair) is independent per (group, lane), so
// one block per (query, group) folds the group's slots in the same order
// and writes the same planes, bit for bit, with G times more blocks than
// one block per query. Inside a block a producer warp prefetches the
// slots' valid rows by cp.async.bulk (16 KB sub-blocks, 4-stage mbarrier
// ring) while eight consumer warps score the staged rows with 16-byte
// shared-memory reads (several rows per warp, q - c for the lane's chunks
// in registers, computed once per slot) and fold them. Rows wider than
// 1024 elements (the registers' limit) take a wide mode: one row per warp,
// q - c in shared memory (double-buffered per slot), sub-blocks of as few
// rows as keep the copies 16-byte multiples. Only the (2 G chunk)-wide
// planes reach device memory. K4 takes bf16 and int8 tables (the f32 table
// serves stream_exact, which never fuses) up to d = 12,288.
//
// Bound on the H100: bytes. A task reads at most chunk * d * itemsize bytes
// of table (64 KB at chunk 256, d 128, bf16; 32 KB int8; 128 KB f32), K4
// only its valid rows, for 2 FLOPs per element - at most 2 FLOP/byte, far
// below the card's ~20 FLOP/byte f32 balance, so 3.35 TB/s is the
// roofline. K2 keeps its first, simple design (no prefetch, 2-byte or
// 1-byte lane reads).
#include <numeric>

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

// ---- K4 -------------------------------------------------------------------

constexpr int K4_CONSUMERS = 256;              // 8 consumer warps
constexpr int K4_THREADS = K4_CONSUMERS + 32;  // + one producer warp
constexpr int K4_STAGE_TARGET = 16 * 1024;     // bytes per staged sub-block
constexpr int K4_STAGES = 4;
constexpr int K4_SMEM_LIMIT = 232448;          // a block's dynamic shared memory on sm_90

// q_c . (the 16 stored bytes of chunk c of a row): 8 bf16 or 16 int8 values,
// widened exactly, f32 FMAs in element order. VEC reads the chunk as one
// 16-byte word (rows of a multiple of 16 bytes); otherwise element by
// element, dropping elements past d.
template <bool VEC>
__device__ __forceinline__ float chunk_dot(const float (&qc)[8], const uint8_t* row, int c,
                                           int d, __nv_bfloat16) {
  float acc = 0.f;
  if (VEC) {
    const uint4 v = *reinterpret_cast<const uint4*>(row + c * 16);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc = fmaf(qc[2 * i], __uint_as_float(w[i] << 16), acc);
      acc = fmaf(qc[2 * i + 1], __uint_as_float(w[i] & 0xffff0000u), acc);
    }
  } else {
    const __nv_bfloat16* r = reinterpret_cast<const __nv_bfloat16*>(row);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (c * 8 + e < d) acc = fmaf(qc[e], vitorch::widen(r[c * 8 + e]), acc);
  }
  return acc;
}

template <bool VEC>
__device__ __forceinline__ float chunk_dot(const float (&qc)[16], const uint8_t* row, int c,
                                           int d, int8_t) {
  float acc = 0.f;
  if (VEC) {
    const uint4 v = *reinterpret_cast<const uint4*>(row + c * 16);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        acc = fmaf(qc[4 * i + b],
                   static_cast<float>(static_cast<int>(w[i] << (24 - 8 * b)) >> 24), acc);
  } else {
    const int8_t* r = reinterpret_cast<const int8_t*>(row);
#pragma unroll
    for (int e = 0; e < 16; ++e)
      if (c * 16 + e < d) acc = fmaf(qc[e], static_cast<float>(r[c * 16 + e]), acc);
  }
  return acc;
}

// One block per (query, group g): the group's slots s = f * t_sub + u
// (f = g mod G) in the reference's order, u outer, f inner. A producer warp
// streams each slot's valid rows (rounded up to `row_align`) in sub-blocks
// of `sub_rows` rows by cp.async.bulk into a ring of K4_STAGES stages;
// eight consumer warps score each staged sub-block, `lpr` lanes per row
// (NCH 16-byte chunks of the row per lane, q - c for those chunks in
// registers, computed once per slot; NCH = 0: the wide mode, every 32nd
// chunk per lane, q - c read from shared memory), reduce each row's dot
// across its lanes with shuffles, and the row's first lane folds the
// distance into that lane's (best, second) pair in shared memory. A row
// index always maps to the same thread, so the pairs need no barrier.
template <bool L2, typename T, int NCH, bool VEC>
__global__ void __launch_bounds__(K4_THREADS, NCH == 4 ? 1 : 2) stream_fused_plane_kernel(
    const float* __restrict__ queries, const float* __restrict__ cent,
    const int* __restrict__ cid2d, const int* __restrict__ blk2d,
    const int* __restrict__ nval2d, const float* __restrict__ bias2d,
    const T* __restrict__ vecs, const float* __restrict__ norms,
    const float* __restrict__ scales, int t_fixed, int t_sub, int chunk, int groups, int d,
    int lpr, int sub_rows, int row_align, int stage_bytes, float* __restrict__ dist_plane,
    int* __restrict__ slot_plane) {
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  extern __shared__ __align__(128) uint8_t smem_k4[];
  uint8_t* ring = smem_k4;
  float* best_v = reinterpret_cast<float*>(ring + K4_STAGES * stage_bytes);  // chunk each
  float* second_v = best_v + chunk;
  int* best_s = reinterpret_cast<int*>(second_v + chunk);
  int* second_s = best_s + chunk;
  uint64_t* full = reinterpret_cast<uint64_t*>(second_s + chunk);
  uint64_t* empty = full + K4_STAGES;
  float* qc_s = reinterpret_cast<float*>(empty + K4_STAGES);  // wide: 2 x (cpr * EPC) floats

  const int q = blockIdx.x, g = blockIdx.y;
  const int fan = t_fixed / t_sub;
  const size_t row_bytes = static_cast<size_t>(d) * sizeof(T);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < K4_STAGES; ++s) {
      vitorch::mbar_init(&full[s], 1);
      vitorch::mbar_init(&empty[s], K4_CONSUMERS / 32);
    }
    vitorch::mbar_init_fence();
  }
  for (int e = tid; e < chunk; e += K4_THREADS) {
    best_v[e] = vitorch::inf_f();
    second_v[e] = vitorch::inf_f();
    best_s[e] = -1;
    second_s[e] = -1;
  }
  __syncthreads();

  if (warp == K4_CONSUMERS / 32) {
    // ---- producer: one thread streams the group's slots, in fold order ----
    if (lane == 0) {
      int n = 0;
      for (int u = 0; u < t_sub; ++u) {
        for (int f = g; f < fan; f += groups) {
          const size_t task = static_cast<size_t>(q) * t_fixed + f * t_sub + u;
          const int nval = nval2d[task];
          if (nval <= 0) continue;  // an empty slot folds to nothing
          // row_align rows are a 16-byte multiple; chunk % 16 == 0 keeps
          // the rounded count inside the block.
          const int rows_a = (nval + row_align - 1) / row_align * row_align;
          const uint8_t* src = reinterpret_cast<const uint8_t*>(vecs) +
                               static_cast<size_t>(blk2d[task]) * chunk * row_bytes;
          for (int r0 = 0; r0 < nval; r0 += sub_rows, ++n) {
            const int st = n % K4_STAGES;
            if (n >= K4_STAGES) vitorch::mbar_wait(&empty[st], ((n / K4_STAGES) - 1) & 1);
            const int nr = min(sub_rows, rows_a - r0);
            const uint32_t bytes = static_cast<uint32_t>(nr * row_bytes);
            vitorch::mbar_expect_tx(&full[st], bytes);
            vitorch::bulk_copy_g2s(ring + st * stage_bytes, src + r0 * row_bytes, bytes, &full[st]);
          }
        }
      }
    }
    return;
  }

  // ---- consumers ------------------------------------------------------------
  const int li = lane % lpr;                       // lane within the row's lanes
  const int rpw = 32 / lpr;                        // rows per warp per pass
  const int rpp = (K4_CONSUMERS / 32) * rpw;       // rows per pass
  const int my_row = warp * rpw + lane / lpr;      // this lane's row within a pass
  const int cpr = (d + EPC - 1) / EPC;             // 16-byte chunks per row
  int n = 0, slots = 0;
  for (int u = 0; u < t_sub; ++u) {
    for (int f = g; f < fan; f += groups) {
      const int s = f * t_sub + u;
      const size_t task = static_cast<size_t>(q) * t_fixed + s;
      const int nval = nval2d[task];
      if (nval <= 0) continue;
      const int cid = cid2d[task];
      const float bias = bias2d[task];
      const float scl = vitorch::row_scale<T>(scales, cid);
      const size_t base = static_cast<size_t>(blk2d[task]) * chunk;
      float qc[NCH > 0 ? NCH : 1][EPC];  // q - c (l2) or q (ip) on this lane's chunks
      // Wide mode: q - c of this slot in shared memory, one buffer per slot
      // parity. A warp writes slot n's buffer only after every warp has
      // passed slot n - 1's barrier, so none still reads slot n - 2's.
      float* qcw = qc_s + (slots++ & 1) * (cpr * EPC);
      if constexpr (NCH == 0) {
        for (int k = tid; k < cpr * EPC; k += K4_CONSUMERS) {
          float v = 0.f;
          if (k < d) {
            v = queries[static_cast<size_t>(q) * d + k];
            if (L2) v -= cent[static_cast<size_t>(cid) * d + k];
          }
          qcw[k] = v;
        }
        vitorch::named_bar_sync(1, K4_CONSUMERS);
      } else {
#pragma unroll
        for (int m = 0; m < NCH; ++m) {
          const int c = li + m * lpr;
#pragma unroll
          for (int e = 0; e < EPC; ++e) {
            const int k = c * EPC + e;
            float v = 0.f;
            if (c < cpr && k < d) {
              v = queries[static_cast<size_t>(q) * d + k];
              if (L2) v -= cent[static_cast<size_t>(cid) * d + k];
            }
            qc[m][e] = v;
          }
        }
      }
      for (int r0 = 0; r0 < nval; r0 += sub_rows, ++n) {
        const int st = n % K4_STAGES;
        vitorch::mbar_wait(&full[st], (n / K4_STAGES) & 1);
        const uint8_t* buf = ring + st * stage_bytes;
        const int nr = min(sub_rows, nval - r0);
        for (int b = 0; b < nr; b += rpp) {  // uniform across the warp
          const int rl = b + my_row;
          const bool ok = rl < nr;
          float dot = 0.f;
          if (ok) {
            const uint8_t* row = buf + rl * row_bytes;
            if constexpr (NCH == 0) {
              for (int c = li; c < cpr; c += lpr) {
                float qv[EPC];
#pragma unroll
                for (int e = 0; e < EPC; e += 4) {
                  const float4 f = *reinterpret_cast<const float4*>(qcw + c * EPC + e);
                  qv[e] = f.x;
                  qv[e + 1] = f.y;
                  qv[e + 2] = f.z;
                  qv[e + 3] = f.w;
                }
                dot += chunk_dot<VEC>(qv, row, c, d, T());
              }
            } else {
#pragma unroll
              for (int m = 0; m < NCH; ++m) {
                const int c = li + m * lpr;
                if (c < cpr) dot += chunk_dot<VEC>(qc[m], row, c, d, T());
              }
            }
          }
          for (int off = lpr >> 1; off > 0; off >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          if (ok && li == 0) {
            const int l = r0 + rl;
            const float dv = task_distance<L2>(bias, dot * scl, norms[base + l]);
            const float bv = best_v[l];
            const int bi = best_s[l];
            const bool better = dv < bv;
            const float disp = better ? bv : dv;  // the displaced candidate
            const int disp_i = better ? bi : s;
            if (better) {
              best_v[l] = dv;
              best_s[l] = s;
            }
            if (disp < second_v[l]) {
              second_v[l] = disp;
              second_s[l] = disp_i;
            }
          }
        }
        __syncwarp();
        if (lane == 0) vitorch::mbar_arrive(&empty[st]);  // this warp is done with the stage
      }
    }
  }

  vitorch::named_bar_sync(1, K4_CONSUMERS);
  const int width = groups * chunk;
  float* dp = dist_plane + static_cast<size_t>(q) * 2 * width + static_cast<size_t>(g) * chunk;
  int* sp = slot_plane + static_cast<size_t>(q) * 2 * width + static_cast<size_t>(g) * chunk;
  for (int e = tid; e < chunk; e += K4_CONSUMERS) {
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

template <bool L2, typename T, int NCH, bool VEC>
int launch_fused_mode(dim3 grid, size_t smem, cudaStream_t st, const void* queries,
                      const void* cent, const void* cid2d, const void* blk2d,
                      const void* nval2d, const void* bias2d, const void* vecs,
                      const void* norms, const void* scales, int t_fixed, int t_sub,
                      int chunk, int groups, int d, int lpr, int sub_rows, int row_align,
                      int stage_bytes, void* dist_plane, void* slot_plane) {
  auto kern = stream_fused_plane_kernel<L2, T, NCH, VEC>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<grid, K4_THREADS, smem, st>>>(
      static_cast<const float*>(queries), static_cast<const float*>(cent),
      static_cast<const int*>(cid2d), static_cast<const int*>(blk2d),
      static_cast<const int*>(nval2d), static_cast<const float*>(bias2d),
      static_cast<const T*>(vecs), static_cast<const float*>(norms),
      static_cast<const float*>(scales), t_fixed, t_sub, chunk, groups, d, lpr, sub_rows,
      row_align, stage_bytes, static_cast<float*>(dist_plane), static_cast<int*>(slot_plane));
  return 0;
}

template <bool L2, typename T>
int launch_fused(const void* queries, const void* cent, const void* cid2d,
                 const void* blk2d, const void* nval2d, const void* bias2d,
                 const void* vecs, const void* norms, const void* scales, int nq,
                 int t_fixed, int t_sub, int chunk, int groups, int d, void* dist_plane,
                 void* slot_plane, cudaStream_t st) {
  constexpr int EPC = 16 / sizeof(T);
  const int cpr = (d + EPC - 1) / EPC;
  if (chunk % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  // Up to 4 chunks per lane in registers for bf16 rows and 2 for int8 (16
  // values each), d <= 1024 either way; wider rows take the wide mode (0).
  const int nch = cpr <= 32 ? 1 : cpr <= 64 ? 2 : cpr <= 128 && sizeof(T) == 2 ? 4 : 0;
  int lpr = 32;  // lanes per row: a power of two covering the row's chunks
  if (nch > 0) {
    lpr = 1;
    while (lpr * nch < cpr) lpr <<= 1;
  }
  const size_t row_bytes = static_cast<size_t>(d) * sizeof(T);
  // Sub-blocks of ~16 KB. Register modes: a multiple of 16 rows (a 16-byte
  // multiple at any d). Wide mode: a multiple of the fewest rows that are.
  int row_align = 16, sub_rows;
  if (nch > 0) {
    sub_rows = static_cast<int>(K4_STAGE_TARGET / row_bytes) & ~15;
    sub_rows = sub_rows < 16 ? 16 : sub_rows;
  } else {
    row_align = static_cast<int>(16 / std::gcd(row_bytes, static_cast<size_t>(16)));
    sub_rows = static_cast<int>(K4_STAGE_TARGET / row_bytes) / row_align * row_align;
    sub_rows = sub_rows < row_align ? row_align : sub_rows;
  }
  sub_rows = sub_rows > chunk ? chunk : sub_rows;
  const int stage_bytes = static_cast<int>((sub_rows * row_bytes + 127) & ~static_cast<size_t>(127));
  const size_t smem = static_cast<size_t>(K4_STAGES) * stage_bytes + 16 * static_cast<size_t>(chunk) +
                      2 * K4_STAGES * sizeof(uint64_t) +
                      (nch > 0 ? 0 : 2 * sizeof(float) * static_cast<size_t>(cpr) * EPC);
  if (smem > static_cast<size_t>(K4_SMEM_LIMIT)) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = row_bytes % 16 == 0;
  const dim3 grid(nq, groups);
#define VITORCH_K4_MODE(NCH, VEC)                                                                \
  launch_fused_mode<L2, T, NCH, VEC>(grid, smem, st, queries, cent, cid2d, blk2d, nval2d, bias2d, \
                                     vecs, norms, scales, t_fixed, t_sub, chunk, groups, d, lpr, \
                                     sub_rows, row_align, stage_bytes, dist_plane, slot_plane)
  if (nch == 1) return vec ? VITORCH_K4_MODE(1, true) : VITORCH_K4_MODE(1, false);
  if (nch == 2) return vec ? VITORCH_K4_MODE(2, true) : VITORCH_K4_MODE(2, false);
  if (nch == 0) return vec ? VITORCH_K4_MODE(0, true) : VITORCH_K4_MODE(0, false);
  if constexpr (sizeof(T) == 2) return vec ? VITORCH_K4_MODE(4, true) : VITORCH_K4_MODE(4, false);
  return static_cast<int>(cudaErrorInvalidValue);
#undef VITORCH_K4_MODE
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
