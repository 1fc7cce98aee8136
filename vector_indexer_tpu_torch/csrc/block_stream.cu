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
// chunk); selection stays in PyTorch, as in the reference. With nval2d it
// reads only each task's valid rows (lanes >= nval hold +inf; a task with
// nval 0 reads nothing), and without it every lane is computed. Rows of at
// most 128 16-byte chunks (bf16 d <= 1024, int8 2048, f32 512): a block
// takes a run of one query's slots, stages their q - c once in shared
// memory, and walks the run's valid rows as one sequence with `lpr` lanes
// per row and 16-byte reads, each lane keeping 8 words (and its rows'
// norms) in flight instead of a copy ring: the rows are read once, so
// direct loads need no staging, and the chain per pass is one load. The
// distances are staged in shared memory and stored as 16-byte words. Wider
// rows take the split launch (below, shared with K4): d in slices of <= 4
// KB of the row and each query's valid rows in equal parts over every SM,
// each part's row segments streamed by cp.async.bulk through a 3-stage
// ring (~96 KB in flight a block, two blocks an SM), the partial dots
// through device memory, and a finish kernel that sums them in slice order
// and writes every lane of the distance rows once.
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
// in registers, computed once per slot) and fold them. Only the (2 G
// chunk)-wide planes reach device memory. Rows wider than 1024 elements
// (the registers' limit) take the split launch at every nq (below, shared
// with K2): d in slices and each query's valid rows in equal parts, the
// partial dots through device memory, and a fold kernel in the reference's
// order. K4 takes bf16 and int8 tables (the f32 table serves stream_exact,
// which never fuses) at any d; its launch plans come from the wrapper
// (ops/block_stream.py::stream_fused_plan, stream_fused_split_plan) and
// are checked here.
//
// Bound on the H100: bytes. K2 with nval2d and K4 read only a task's valid
// rows (at most chunk * d * itemsize bytes: 64 KB at chunk 256, d 128,
// bf16; 32 KB int8; 128 KB f32), for 2 FLOPs per element - at most 2
// FLOP/byte, far below the card's ~20 FLOP/byte f32 balance, so 3.35 TB/s
// over the valid rows' bytes (and norms) is the roofline.
#include "common.cuh"

namespace {

template <bool L2>
__device__ __forceinline__ float task_distance(float bias, float dot, float nrm) {
  if (L2) return bias - 2.f * dot + nrm;
  return bias - dot + (nrm >= VITORCH_SENTINEL ? nrm : 0.f);
}

// ---- 16-byte row chunks (K2 and K4) ------------------------------------------

// q_c . (the 16 stored bytes of chunk c of a row): 8 bf16, 16 int8 or 4 f32
// values, widened exactly, f32 FMAs in element order. word_dot takes the
// chunk as one loaded 16-byte word; chunk_dot<VEC> loads it as one word
// (rows of a multiple of 16 bytes) or element by element, dropping
// elements past d.
__device__ __forceinline__ float word_dot(const float (&qc)[8], uint4 v, __nv_bfloat16) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc = fmaf(qc[2 * i], __uint_as_float(w[i] << 16), acc);
    acc = fmaf(qc[2 * i + 1], __uint_as_float(w[i] & 0xffff0000u), acc);
  }
  return acc;
}

__device__ __forceinline__ float word_dot(const float (&qc)[16], uint4 v, int8_t) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      acc = fmaf(qc[4 * i + b], static_cast<float>(static_cast<int>(w[i] << (24 - 8 * b)) >> 24),
                 acc);
  return acc;
}

__device__ __forceinline__ float word_dot(const float (&qc)[4], uint4 v, float) {
  float acc = fmaf(qc[0], __uint_as_float(v.x), 0.f);
  acc = fmaf(qc[1], __uint_as_float(v.y), acc);
  acc = fmaf(qc[2], __uint_as_float(v.z), acc);
  return fmaf(qc[3], __uint_as_float(v.w), acc);
}

template <bool VEC>
__device__ __forceinline__ float chunk_dot(const float (&qc)[8], const uint8_t* row, int c,
                                           int d, __nv_bfloat16) {
  float acc = 0.f;
  if (VEC) {
    acc = word_dot(qc, *reinterpret_cast<const uint4*>(row + c * 16), __nv_bfloat16());
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
    acc = word_dot(qc, *reinterpret_cast<const uint4*>(row + c * 16), int8_t());
  } else {
    const int8_t* r = reinterpret_cast<const int8_t*>(row);
#pragma unroll
    for (int e = 0; e < 16; ++e)
      if (c * 16 + e < d) acc = fmaf(qc[e], static_cast<float>(r[c * 16 + e]), acc);
  }
  return acc;
}

template <bool VEC>
__device__ __forceinline__ float chunk_dot(const float (&qc)[4], const uint8_t* row, int c,
                                           int d, float) {
  if (VEC) return word_dot(qc, *reinterpret_cast<const uint4*>(row + c * 16), float());
  const float* r = reinterpret_cast<const float*>(row);
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (c * 4 + e < d) acc = fmaf(qc[e], r[c * 4 + e], acc);
  return acc;
}

// ---- K2 -------------------------------------------------------------------

constexpr int K2_THREADS = 256;  // 8 warps
constexpr int K2_WARPS = K2_THREADS / 32;
constexpr int K2_MAX_SLOTS = 4;  // slots per block
constexpr int K2_NCH = 4;        // 16-byte chunks of a row per lane (16-byte-multiple rows)
constexpr int K2_MAX_SMEM = 232448;

// One block per (query, run of `spb` consecutive slots), for rows of at
// most 128 16-byte chunks (wider rows take the split launch below). q - c
// (l2) or q (ip) of every slot of the run is staged once in shared memory;
// the slots' valid rows (all `chunk` rows when nval2d is null) are then
// walked as one sequence, `lpr` lanes per row and 32 / lpr rows per warp,
// each lane keeping U rows' 16-byte words and norms in flight before it
// multiplies them (VEC rows: K2_NCH chunks per lane; other rows are read
// element by element, the row's lanes striding over its chunks). A row's
// dot is summed across its lanes by shuffles and its first lane writes the
// distance into the run's staging area in shared memory, where lanes at or
// past nval hold +inf. At the end the block stores the run's rows,
// contiguous in out, as 16-byte words.
template <bool L2, typename T, bool VEC>
__global__ void __launch_bounds__(K2_THREADS, 2) stream_distances_kernel(
    const float* __restrict__ queries, const float* __restrict__ cent,
    const int* __restrict__ cid2d, const int* __restrict__ blk2d,
    const int* __restrict__ nval2d, const float* __restrict__ bias2d,
    const T* __restrict__ vecs, const float* __restrict__ norms,
    const float* __restrict__ scales, int t_fixed, int chunk, int d, int lpr, int spb,
    float* __restrict__ out) {
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  // Rows per lane kept in flight per pass: 8 16-byte words (the
  // element-wise mode: 4 rows).
  constexpr int U = VEC ? 8 / K2_NCH : 4;
  extern __shared__ __align__(16) float smem_k2[];
  __shared__ int s_start[K2_MAX_SLOTS + 1];  // first flattened row of each slot
  __shared__ size_t s_base[K2_MAX_SLOTS];    // its block's first table row
  __shared__ float s_bias[K2_MAX_SLOTS], s_scl[K2_MAX_SLOTS];
  __shared__ int s_cid[K2_MAX_SLOTS];
  const int cpr = (d + EPC - 1) / EPC;       // 16-byte chunks per row
  const int width = cpr * EPC;
  float* qc_s = smem_k2;                     // spb x width: q - c per slot, zero past d
  float* out_s = qc_s + spb * width;         // spb x chunk distances

  const int nsg = (t_fixed + spb - 1) / spb;
  const int q = blockIdx.x / nsg;
  const int s0 = (blockIdx.x % nsg) * spb;
  const int ns = min(spb, t_fixed - s0);
  const size_t task0 = static_cast<size_t>(q) * t_fixed + s0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    int start = 0;
    for (int s = 0; s < ns; ++s) {
      s_start[s] = start;
      start += nval2d == nullptr ? chunk : min(max(nval2d[task0 + s], 0), chunk);
    }
    s_start[ns] = start;
  }
  if (tid < ns) {
    const int cid = cid2d[task0 + tid];
    s_cid[tid] = cid;
    s_base[tid] = static_cast<size_t>(blk2d[task0 + tid]) * chunk;
    s_bias[tid] = bias2d[task0 + tid];
    s_scl[tid] = vitorch::row_scale<T>(scales, cid);
  }
  __syncthreads();
  for (int e = tid; e < ns * chunk; e += K2_THREADS) {  // lanes past nval: +inf
    const int s = e / chunk;
    if (e % chunk >= s_start[s + 1] - s_start[s]) out_s[e] = vitorch::inf_f();
  }
  for (int e = tid; e < ns * width; e += K2_THREADS) {
    const int s = e / width, k = e % width;
    float v = 0.f;
    if (k < d) {
      v = queries[static_cast<size_t>(q) * d + k];
      if (L2) v -= cent[static_cast<size_t>(s_cid[s]) * d + k];
    }
    qc_s[e] = v;
  }
  __syncthreads();

  const int li = lane % lpr;                 // lane within the row's lanes
  const int rpp = K2_WARPS * (32 / lpr);     // rows per pass of the block
  const int my_row = warp * (32 / lpr) + lane / lpr;
  const size_t row_bytes = static_cast<size_t>(d) * sizeof(T);
  const uint8_t* table = reinterpret_cast<const uint8_t*>(vecs);
  int start[K2_MAX_SLOTS + 1];  // the slots' first flattened rows, in registers
#pragma unroll
  for (int j = 0; j <= K2_MAX_SLOTS; ++j) start[j] = j <= ns ? s_start[j] : 0;
  const int total = s_start[ns];
  for (int r0 = 0; r0 < total; r0 += U * rpp) {  // uniform across the block
    int sl[U], rw[U];
    float nrm[U], dot[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {  // flattened row -> (slot, row), its norm
      const int f = r0 + u * rpp + my_row;
      int s = 0, s_first = 0;
#pragma unroll
      for (int j = 1; j < K2_MAX_SLOTS; ++j) {
        if (j < ns && f >= start[j]) {
          s = j;
          s_first = start[j];
        }
      }
      sl[u] = s;
      rw[u] = f < total ? f - s_first : -1;
      nrm[u] = rw[u] >= 0 && li == 0 ? norms[s_base[s] + rw[u]] : 0.f;
      dot[u] = 0.f;
    }
    if constexpr (VEC) {
      uint4 w[U][K2_NCH];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const uint4* row =
            reinterpret_cast<const uint4*>(table + (s_base[sl[u]] + max(rw[u], 0)) * row_bytes);
#pragma unroll
        for (int m = 0; m < K2_NCH; ++m) {
          const int c = li + m * lpr;
          w[u][m] = rw[u] >= 0 && c < cpr ? __ldg(row + c) : make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int m = 0; m < K2_NCH; ++m) {
          const int c = li + m * lpr;
          if (c < cpr) {
            float qv[EPC];
            const float4* qp = reinterpret_cast<const float4*>(qc_s + sl[u] * width + c * EPC);
#pragma unroll
            for (int e = 0; e < EPC / 4; ++e) {
              const float4 f = qp[e];
              qv[4 * e] = f.x;
              qv[4 * e + 1] = f.y;
              qv[4 * e + 2] = f.z;
              qv[4 * e + 3] = f.w;
            }
            dot[u] += word_dot(qv, w[u][m], T());
          }
        }
      }
    } else {
      for (int c = li; c < cpr; c += lpr) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (rw[u] < 0) continue;
          float qv[EPC];
          const float4* qp = reinterpret_cast<const float4*>(qc_s + sl[u] * width + c * EPC);
#pragma unroll
          for (int e = 0; e < EPC / 4; ++e) {
            const float4 f = qp[e];
            qv[4 * e] = f.x;
            qv[4 * e + 1] = f.y;
            qv[4 * e + 2] = f.z;
            qv[4 * e + 3] = f.w;
          }
          dot[u] += chunk_dot<false>(qv, table + (s_base[sl[u]] + rw[u]) * row_bytes, c, d, T());
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)  // across the row's lpr lanes
        if (off < lpr) dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], off);
      if (rw[u] >= 0 && li == 0)
        out_s[sl[u] * chunk + rw[u]] =
            task_distance<L2>(s_bias[sl[u]], dot[u] * s_scl[sl[u]], nrm[u]);
    }
  }
  __syncthreads();
  float* dst = out + task0 * chunk;
  const int n_out = ns * chunk;
  if (n_out % 4 == 0 && (reinterpret_cast<uintptr_t>(dst) & 15u) == 0) {
    for (int e = tid; e < n_out / 4; e += K2_THREADS)
      reinterpret_cast<float4*>(dst)[e] = reinterpret_cast<const float4*>(out_s)[e];
  } else {
    for (int e = tid; e < n_out; e += K2_THREADS) dst[e] = out_s[e];
  }
}

// ---- K4 -------------------------------------------------------------------

constexpr int K4_CONSUMERS = 256;              // 8 consumer warps
constexpr int K4_THREADS = K4_CONSUMERS + 32;  // + one producer warp
constexpr int K4_STAGES = 4;
constexpr int K4_SMEM_LIMIT = 232448;          // a block's dynamic shared memory on sm_90

// Bytes of the 16-byte-aligned envelope of `len` bytes at byte offset `a`
// of the table (whose base is 16-byte aligned): what one bulk copy moves.
__device__ __forceinline__ uint32_t envelope(size_t a, int len) {
  return static_cast<uint32_t>(((a + len + 15) & ~static_cast<size_t>(15)) -
                               (a & ~static_cast<size_t>(15)));
}

// Lane l's (best, second) pair takes the candidate (dv, slot s) with strict
// '<', as the reference folds it.
__device__ __forceinline__ void fold_top2(float* best_v, float* second_v, int* best_s,
                                          int* second_s, int l, float dv, int s) {
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

// One block per (query, group g): the group's slots s = f * t_sub + u
// (f = g mod G) in the reference's order, u outer, f inner. A producer warp
// streams each slot's valid rows (rounded up to `row_align`) in sub-blocks
// of `sub_rows` rows by cp.async.bulk into a ring of K4_STAGES stages;
// eight consumer warps score each staged sub-block, `lpr` lanes per row
// (NCH 16-byte chunks of the row per lane, q - c for those chunks in
// registers, computed once per slot), reduce each row's dot across its
// lanes with shuffles, and the row's first lane folds the distance into
// that lane's (best, second) pair in shared memory. A row index always
// maps to the same thread, so the pairs need no barrier.
template <bool L2, typename T, int NCH, bool VEC>
__global__ void __launch_bounds__(K4_THREADS, NCH == 4 ? 1 : 2) stream_fused_plane_kernel(
    const float* __restrict__ queries, const float* __restrict__ cent,
    const int* __restrict__ cid2d, const int* __restrict__ blk2d,
    const int* __restrict__ nval2d, const float* __restrict__ bias2d,
    const T* __restrict__ vecs, const float* __restrict__ norms,
    const float* __restrict__ scales, int t_fixed, int t_sub, int chunk, int groups, int d,
    int lpr, int sub_rows, int row_align, int stage_bytes, float* __restrict__ dist_plane,
    int* __restrict__ slot_plane) {
  static_assert(NCH == 1 || NCH == 2 || NCH == 4, "K4: 1, 2 or 4 chunks a lane");
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  extern __shared__ __align__(128) uint8_t smem_k4[];
  uint8_t* ring = smem_k4;
  float* best_v = reinterpret_cast<float*>(ring + K4_STAGES * stage_bytes);  // chunk each
  float* second_v = best_v + chunk;
  int* best_s = reinterpret_cast<int*>(second_v + chunk);
  int* second_s = best_s + chunk;
  uint64_t* full = reinterpret_cast<uint64_t*>(second_s + chunk);
  uint64_t* empty = full + K4_STAGES;

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
      const uint8_t* table = reinterpret_cast<const uint8_t*>(vecs);
      for (int u = 0; u < t_sub; ++u) {
        for (int f = g; f < fan; f += groups) {
          const size_t task = static_cast<size_t>(q) * t_fixed + f * t_sub + u;
          const int nval = nval2d[task];
          if (nval <= 0) continue;  // an empty slot folds to nothing
          const size_t blk0 = static_cast<size_t>(blk2d[task]) * chunk * row_bytes;
          // row_align rows are a 16-byte multiple; chunk % 16 == 0 keeps
          // the rounded count inside the block.
          const int rows_a = (nval + row_align - 1) / row_align * row_align;
          const uint8_t* src = table + blk0;
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
  int n = 0;
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
      float qc[NCH][EPC];  // q - c (l2) or q (ip) on this lane's chunks
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
#pragma unroll
            for (int m = 0; m < NCH; ++m) {
              const int c = li + m * lpr;
              if (c < cpr) dot += chunk_dot<VEC>(qc[m], row, c, d, T());
            }
          }
          for (int off = lpr >> 1; off > 0; off >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          if (ok && li == 0) {
            const int l = r0 + rl;
            fold_top2(best_v, second_v, best_s, second_s, l,
                      task_distance<L2>(bias, dot * scl, norms[base + l]), s);
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

// ---- Split launches: K2's and K4's rows past 1024 elements, any nq -------
//
// One block per (query, run of slots) (K2) or per (query, group) (K4)
// leaves most SMs idle when the queries are few (K4: 4 blocks at nq 1),
// and a block that walks whole rows of 16,384 elements keeps too few bytes
// in flight (K4's one-block launch read 1.14-11x slower than the split at
// d 16,384 up to nq 1000, and at most 4.5% faster at d 1,536, on an
// NVIDIA H100 80GB HBM3, 700.00 W).
// The split launch cuts the work twice over instead: d into
// `n_slices` slices of `slice` elements, and each query's valid rows,
// taken in slot order as one sequence, into `parts` runs of equal length
// (a part may start and end inside a slot, so a long list is spread like
// any other). Block (query, part, slice) of stream_partial_kernel streams
// the slice's segment of every row of its part and writes each row's
// partial dot (q - c restricted to the slice, times the row's segment) to
// part_dots[task][slice][lane]. A second kernel sums each row's partials in
// slice order, applies the scale, bias and norm and writes the result: K2's
// every lane of the distance rows (+inf past nval), K4's the per-(group,
// lane) planes, folded in the reference's order. The planes keep the fold
// order exactly, and only the dot's summation order differs from the
// unsplit launches. No float atomics: two runs give the same bits.

constexpr int PART_CONSUMERS = 256;               // 8 consumer warps
constexpr int PART_THREADS = PART_CONSUMERS + 32;  // + one producer warp
constexpr int PART_STAGES = 3;
constexpr int PART_QC_LOADS = 8;                 // q - c elements a consumer thread loads at once
constexpr int K4F_THREADS = 256;                 // K4's fold kernel
constexpr int K4F_LANES = 32;                    // lanes per fold block
constexpr int K4F_BATCH = 32;                    // slots whose distances are staged at a time
constexpr int K2F_THREADS = 256;                 // K2's finish kernel

// Valid rows of slot s of a query's row of nval2d (null: every lane).
template <typename I>
__device__ __forceinline__ int slot_rows(const I* nv, int s, int chunk) {
  if (nv == nullptr) return chunk;
  const I v = nv[s];
  return v <= 0 ? 0 : v >= chunk ? chunk : static_cast<int>(v);
}

// Inclusive prefix sum across a warp.
__device__ __forceinline__ int warp_scan(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  return v;
}

// The split launch keeps q - c of a slice in shared memory as EPC / 4
// planes of float4s: element e of chunk c at ((e / 4) * cstride + c) * 4 +
// e % 4 (cstride: the slice's chunks). A warp's lanes read consecutive
// chunks, so each plane's reads are consecutive 16-byte words, free of the
// bank conflicts that 32- and 64-byte strides (bf16, int8 chunks) cause.
__device__ __forceinline__ int qc_index(int e, int epc, int cstride) {
  return ((e % epc) / 4 * cstride + e / epc) * 4 + e % 4;
}

// The split launch's dot of chunk c of a staged row segment with q - c of
// the slice (qcw, planes cstride apart).
template <bool VEC, typename T>
__device__ __forceinline__ float staged_chunk_dot(const float* qcw, int cstride,
                                                  const uint8_t* seg, int c, int pe, T) {
  constexpr int EPC = 16 / sizeof(T);
  float qv[EPC];
#pragma unroll
  for (int e = 0; e < EPC; e += 4) {
    const float4 f4 = *reinterpret_cast<const float4*>(qcw + ((e / 4) * cstride + c) * 4);
    qv[e] = f4.x;
    qv[e + 1] = f4.y;
    qv[e + 2] = f4.z;
    qv[e + 3] = f4.w;
  }
  return chunk_dot<VEC>(qv, seg, c, pe, T());
}

// Block (q * parts + part, k). The producer warp first finds the part's
// rows: the query's valid-row total T, the part's run [part * ceil(T /
// parts), ...) of the flattened rows, and the slot and row it starts at.
// Then it streams, slot by slot, the slice's segment of each of those rows
// (one cp.async.bulk per row over the segment's 16-byte envelope, issued
// by the warp's lanes together; stages of `sub_rows` segments,
// `seg_stride` bytes apart); the consumer warps take q - c of the slice
// into shared memory (double-buffered per slot; in planes, qc_index), then score the staged segments one row per warp.
// I: the task grid's integer type (K4's int32 grid, K2's int64 one, which
// it reads as build_task_grid makes it, without a cast).
template <bool L2, typename T, bool VEC, typename I>
__global__ void __launch_bounds__(PART_THREADS, 2) stream_partial_kernel(
    const float* __restrict__ queries, const float* __restrict__ cent,
    const I* __restrict__ cid2d, const I* __restrict__ blk2d,
    const I* __restrict__ nval2d, const T* __restrict__ vecs, int t_fixed, int chunk, int d,
    int parts, int slice, int n_slices, int sub_rows, int seg_stride, int stage_bytes,
    float* __restrict__ part_dots) {
  constexpr int EPC = 16 / sizeof(T);
  constexpr int PRODUCER = PART_CONSUMERS / 32;
  extern __shared__ __align__(128) uint8_t smem_part[];
  __shared__ int s_begin, r_begin, n_rows;
  uint8_t* ring = smem_part;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + PART_STAGES * stage_bytes);
  uint64_t* empty = full + PART_STAGES;
  float* qc_s = reinterpret_cast<float*>(empty + PART_STAGES);  // 2 x slice
  const int q = blockIdx.x / parts, part = blockIdx.x % parts, k = blockIdx.y;
  const int k0 = k * slice, pe = min(slice, d - k0);  // this slice's elements
  const int seg = pe * static_cast<int>(sizeof(T));
  const size_t row_bytes = static_cast<size_t>(d) * sizeof(T);
  const I* nv = nval2d == nullptr ? nullptr : nval2d + static_cast<size_t>(q) * t_fixed;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // A second pass launched as a programmatic dependent (K2's finish kernel)
  // may start once every block of this grid is running; it waits for this
  // grid's completion before it reads part_dots. (K4's fold kernel is
  // launched normally: then this is a no-op.)
  asm volatile("griddepcontrol.launch_dependents;");
  if (tid == 0) {
    for (int s = 0; s < PART_STAGES; ++s) {
      vitorch::mbar_init(&full[s], 1);
      vitorch::mbar_init(&empty[s], PART_CONSUMERS / 32);
    }
    vitorch::mbar_init_fence();
  }
  if (warp == PRODUCER) {
    int mine = 0;  // this lane's slots' rows, their loads in flight together
#pragma unroll 8
    for (int s = lane; s < t_fixed; s += 32) mine += slot_rows(nv, s, chunk);
    const int total = __reduce_add_sync(0xffffffffu, mine);
    const int per = (total + parts - 1) / parts;
    const int lo = min(part * per, total), hi = min(lo + per, total);
    int sb = t_fixed, rb = 0, acc = 0;
    for (int b = 0; b < t_fixed && sb == t_fixed && lo < hi; b += 32) {
      const int v = b + lane < t_fixed ? slot_rows(nv, b + lane, chunk) : 0;
      const int incl = warp_scan(v, lane);
      const unsigned hit = __ballot_sync(0xffffffffu, acc + incl - v <= lo && lo < acc + incl);
      if (hit) {
        const int l = __ffs(hit) - 1;
        sb = b + l;
        rb = lo - acc - __shfl_sync(0xffffffffu, incl - v, l);
      }
      acc += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) {
      s_begin = sb;
      r_begin = rb;
      n_rows = hi - lo;
    }
  }
  __syncthreads();

  if (warp == PRODUCER) {
    // ---- producer warp: lane 0 arms each stage, every lane copies rows ----
    const uint8_t* table = reinterpret_cast<const uint8_t*>(vecs);
    int n = 0, left = n_rows;
    for (int s = s_begin, r = r_begin; left > 0; ++s, r = 0) {
      const size_t task = static_cast<size_t>(q) * t_fixed + s;
      const int take = min(slot_rows(nv, s, chunk) - r, left);
      if (take <= 0) continue;  // an empty slot has no rows
      left -= take;
      const size_t a0 = static_cast<size_t>(blk2d[task]) * chunk * row_bytes + k0 * sizeof(T);
      for (int r0 = r; r0 < r + take; r0 += sub_rows, ++n) {
        const int st = n % PART_STAGES;
        if (n >= PART_STAGES) vitorch::mbar_wait(&empty[st], ((n / PART_STAGES) - 1) & 1);
        const int nr = min(sub_rows, r + take - r0);
        uint32_t mine = 0;
        for (int i = lane; i < nr; i += 32) mine += envelope(a0 + (r0 + i) * row_bytes, seg);
        const uint32_t bytes = __reduce_add_sync(0xffffffffu, mine);
        if (lane == 0) vitorch::mbar_expect_tx(&full[st], bytes);
        __syncwarp();
        for (int i = lane; i < nr; i += 32) {
          const size_t a = a0 + (r0 + i) * row_bytes;
          vitorch::bulk_copy_g2s(ring + st * stage_bytes + i * seg_stride,
                                 table + (a & ~static_cast<size_t>(15)), envelope(a, seg),
                                 &full[st]);
        }
      }
    }
    return;
  }

  // ---- consumers --------------------------------------------------------------
  const int cpp = (pe + EPC - 1) / EPC;  // this slice's 16-byte chunks
  const int cstride = slice / EPC;       // a q - c plane's float4s
  int n = 0, slots = 0, left = n_rows;
  for (int s = s_begin, r = r_begin; left > 0; ++s, r = 0) {
    const size_t task = static_cast<size_t>(q) * t_fixed + s;
    const int take = min(slot_rows(nv, s, chunk) - r, left);
    if (take <= 0) continue;
    left -= take;
    const size_t cid = static_cast<size_t>(cid2d[task]);
    const size_t base = static_cast<size_t>(blk2d[task]) * chunk;
    float* qcw = qc_s + (slots++ & 1) * slice;
    const float* qs = queries + static_cast<size_t>(q) * d + k0;
    const float* cs = cent + cid * d + k0;
    for (int e0 = tid; e0 < pe; e0 += PART_CONSUMERS * PART_QC_LOADS) {
      float v[PART_QC_LOADS];  // loaded together: one round trip, not one per element
#pragma unroll
      for (int u = 0; u < PART_QC_LOADS; ++u) {
        const int e = e0 + u * PART_CONSUMERS;
        v[u] = e < pe ? qs[e] - (L2 ? cs[e] : 0.f) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < PART_QC_LOADS; ++u) {
        const int e = e0 + u * PART_CONSUMERS;
        if (e < pe) qcw[qc_index(e, EPC, cstride)] = v[u];
      }
    }
    vitorch::named_bar_sync(1, PART_CONSUMERS);
    float* prow = part_dots + (task * n_slices + k) * chunk;
    for (int r0 = r; r0 < r + take; r0 += sub_rows, ++n) {
      const int st = n % PART_STAGES;
      vitorch::mbar_wait(&full[st], (n / PART_STAGES) & 1);
      const uint8_t* buf = ring + st * stage_bytes;
      const int nr = min(sub_rows, r + take - r0);
      for (int rl = warp; rl < nr; rl += PART_CONSUMERS / 32) {
        const size_t a = (base + r0 + rl) * row_bytes + k0 * sizeof(T);
        const uint8_t* sp = buf + rl * seg_stride + (a & 15);
        float dot = 0.f;
        if constexpr (sizeof(T) == 4) {
#pragma unroll 1  // f32 rows: one chunk per step keeps ptxas from spilling
          for (int c = lane; c < cpp; c += 32)
            dot += staged_chunk_dot<VEC>(qcw, cstride, sp, c, pe, T());
        } else {
          for (int c = lane; c < cpp; c += 32)
            dot += staged_chunk_dot<VEC>(qcw, cstride, sp, c, pe, T());
        }
        dot = vitorch::warp_sum(dot);
        if (lane == 0) prow[r0 + rl] = dot;
      }
      __syncwarp();
      if (lane == 0) vitorch::mbar_arrive(&empty[st]);  // this warp is done with the stage
    }
  }
}

// K2's second pass: one thread per lane of every task. A lane below its
// task's valid count sums its row's partials in slice order and takes the
// scale, bias and norm; the others are +inf. Every lane of out is written
// once, by one thread, so parts that start or end inside a slot never
// share a store, and a slot with no valid row reads nothing.
template <bool L2, typename T>
__global__ void __launch_bounds__(K2F_THREADS) stream_distances_finish_kernel(
    const int64_t* __restrict__ cid2d, const int64_t* __restrict__ blk2d,
    const int64_t* __restrict__ nval2d, const float* __restrict__ bias2d,
    const float* __restrict__ norms, const float* __restrict__ scales,
    const float* __restrict__ part_dots, int chunk, int n_slices, size_t n_out,
    float* __restrict__ out) {
  const size_t e = static_cast<size_t>(blockIdx.x) * K2F_THREADS + threadIdx.x;
  if (e >= n_out) return;
  const size_t task = e / chunk;
  const int l = static_cast<int>(e % chunk);
  // The task's values first, all loads in flight together (launched as a
  // programmatic dependent of the partial kernel, this overlaps its tail);
  // the partials and the norm after.
  const int rows = slot_rows(nval2d == nullptr ? nullptr : nval2d + task, 0, chunk);
  const size_t blk = static_cast<size_t>(blk2d[task]);
  const float bias = bias2d[task];
  const float scl = vitorch::row_scale<T>(scales, static_cast<int>(cid2d[task]));
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the partial dots are complete
  float v = vitorch::inf_f();
  if (l < rows) {
    const float* pp = part_dots + task * n_slices * chunk + l;
    float dot = 0.f;
#pragma unroll 8
    for (int k = 0; k < n_slices; ++k) dot += pp[static_cast<size_t>(k) * chunk];
    v = task_distance<L2>(bias, dot * scl, norms[blk * chunk + l]);
  }
  out[e] = v;
}

// Block (q, g, lane tile): K4F_LANES lanes of group g. The group's slots
// are taken in the reference's fold order (u outer, f = g, g + G, ...
// inner) in batches of K4F_BATCH: every thread sums some (slot, lane)
// pairs' partials in slice order into that pair's distance in shared
// memory (+inf past the slot's valid count), then warp 0 folds the batch,
// one lane per thread, with strict '<'.
template <bool L2, typename T>
__global__ void __launch_bounds__(K4F_THREADS) stream_fused_fold_kernel(
    const int* __restrict__ cid2d, const int* __restrict__ blk2d,
    const int* __restrict__ nval2d, const float* __restrict__ bias2d,
    const float* __restrict__ norms, const float* __restrict__ scales,
    const float* __restrict__ part_dots, int t_fixed, int t_sub, int chunk, int groups,
    int n_slices, float* __restrict__ dist_plane, int* __restrict__ slot_plane) {
  __shared__ float dist_s[K4F_BATCH][K4F_LANES];
  const int q = blockIdx.x, g = blockIdx.y, lane0 = blockIdx.z * K4F_LANES;
  const int fpg = t_fixed / t_sub / groups;  // fans per group
  const int n_group = t_sub * fpg;           // the group's slots
  const int tid = threadIdx.x;
  float bv = vitorch::inf_f(), sv = vitorch::inf_f();
  int bi = -1, si = -1;
  for (int i0 = 0; i0 < n_group; i0 += K4F_BATCH) {
    const int nb = min(K4F_BATCH, n_group - i0);
    for (int e = tid; e < nb * K4F_LANES; e += K4F_THREADS) {
      const int i = i0 + e / K4F_LANES, l = lane0 + e % K4F_LANES;
      const int s = (g + (i % fpg) * groups) * t_sub + i / fpg;
      const size_t task = static_cast<size_t>(q) * t_fixed + s;
      float dv = vitorch::inf_f();
      if (l < chunk && l < nval2d[task]) {
        const float* pp = part_dots + task * n_slices * chunk + l;
        float dot = 0.f;
#pragma unroll 8
        for (int k = 0; k < n_slices; ++k) dot += pp[static_cast<size_t>(k) * chunk];
        dv = task_distance<L2>(bias2d[task], dot * vitorch::row_scale<T>(scales, cid2d[task]),
                               norms[static_cast<size_t>(blk2d[task]) * chunk + l]);
      }
      dist_s[e / K4F_LANES][e % K4F_LANES] = dv;
    }
    __syncthreads();
    if (tid < K4F_LANES) {
      for (int j = 0; j < nb; ++j) {
        const int i = i0 + j;
        const int s = (g + (i % fpg) * groups) * t_sub + i / fpg;
        const float dv = dist_s[j][tid];
        const bool better = dv < bv;
        const float disp = better ? bv : dv;  // the displaced candidate
        const int disp_i = better ? bi : s;
        if (better) {
          bv = dv;
          bi = s;
        }
        if (disp < sv) {
          sv = disp;
          si = disp_i;
        }
      }
    }
    __syncthreads();
  }
  const int l = lane0 + tid;
  if (tid < K4F_LANES && l < chunk) {
    const int width = groups * chunk;
    const size_t row = static_cast<size_t>(q) * 2 * width + static_cast<size_t>(g) * chunk + l;
    dist_plane[row] = bv;
    dist_plane[row + width] = sv;
    slot_plane[row] = bi;
    slot_plane[row + width] = si;
  }
}

template <bool L2, typename T, bool VEC>
int launch_distances_mode(const void* queries, const void* cent, const void* cid2d,
                          const void* blk2d, const void* nval2d, const void* bias2d,
                          const void* vecs, const void* norms, const void* scales, int nq,
                          int t_fixed, int chunk, int d, int lpr, int spb, size_t smem,
                          void* out, cudaStream_t st) {
  auto kern = stream_distances_kernel<L2, T, VEC>;
  if (smem > 40 * 1024) {  // past 48 KB with the static arrays: opt in
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t blocks = static_cast<size_t>(nq) * ((t_fixed + spb - 1) / spb);
  kern<<<dim3(static_cast<unsigned>(blocks)), K2_THREADS, smem, st>>>(
      static_cast<const float*>(queries), static_cast<const float*>(cent),
      static_cast<const int*>(cid2d), static_cast<const int*>(blk2d),
      static_cast<const int*>(nval2d), static_cast<const float*>(bias2d),
      static_cast<const T*>(vecs), static_cast<const float*>(norms),
      static_cast<const float*>(scales), t_fixed, chunk, d, lpr, spb,
      static_cast<float*>(out));
  return 0;
}

// The plan (lpr, spb) comes from the wrapper
// (ops/block_stream.py::stream_distances_plan); it is checked here: rows
// of at most 128 16-byte chunks, K2_NCH chunks per lane. Rows that are not
// 16-byte multiples take the element-wise mode.
template <bool L2, typename T>
int launch_distances(const void* queries, const void* cent, const void* cid2d,
                     const void* blk2d, const void* nval2d, const void* bias2d,
                     const void* vecs, const void* norms, const void* scales, int nq,
                     int t_fixed, int chunk, int d, int lpr, int spb, void* out,
                     cudaStream_t st) {
  constexpr int EPC = 16 / sizeof(T);
  const int cpr = (d + EPC - 1) / EPC;
  const size_t smem = sizeof(float) * static_cast<size_t>(spb) * (cpr * EPC + chunk);
  const bool lpr_ok = lpr >= 1 && lpr <= 32 && (lpr & (lpr - 1)) == 0;
  if (!lpr_ok || lpr * K2_NCH < cpr || spb < 1 || spb > K2_MAX_SLOTS ||
      smem > static_cast<size_t>(K2_MAX_SMEM))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (static_cast<size_t>(d) * sizeof(T)) % 16 == 0;
  return vec ? launch_distances_mode<L2, T, true>(queries, cent, cid2d, blk2d, nval2d, bias2d,
                                                  vecs, norms, scales, nq, t_fixed, chunk, d,
                                                  lpr, spb, smem, out, st)
             : launch_distances_mode<L2, T, false>(queries, cent, cid2d, blk2d, nval2d, bias2d,
                                                   vecs, norms, scales, nq, t_fixed, chunk, d,
                                                   lpr, spb, smem, out, st);
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

// The plan (nch, lpr, sub_rows, row_align, stage_bytes) comes from the
// wrapper (ops/block_stream.py::stream_fused_plan); it is checked here.
// nch 1 / 2 / 4 (4: bf16 only): that many 16-byte chunks per lane in
// registers. Wider rows take the split launch.
template <bool L2, typename T>
int launch_fused(const void* queries, const void* cent, const void* cid2d,
                 const void* blk2d, const void* nval2d, const void* bias2d,
                 const void* vecs, const void* norms, const void* scales, int nq,
                 int t_fixed, int t_sub, int chunk, int groups, int d, int nch, int lpr,
                 int sub_rows, int row_align, int stage_bytes, void* dist_plane,
                 void* slot_plane, cudaStream_t st) {
  constexpr int EPC = 16 / sizeof(T);
  const int cpr = (d + EPC - 1) / EPC;
  const size_t row_bytes = static_cast<size_t>(d) * sizeof(T);
  const bool vec = row_bytes % 16 == 0;
  const bool lpr_ok = lpr >= 1 && lpr <= 32 && (lpr & (lpr - 1)) == 0;
  const bool nch_ok = (nch == 1 || nch == 2 || (nch == 4 && sizeof(T) == 2)) && lpr * nch >= cpr;
  if (chunk % 16 != 0 || !lpr_ok || !nch_ok || sub_rows < 1 || sub_rows > chunk ||
      row_align < 1 || sub_rows % row_align != 0 || (row_align * row_bytes) % 16 != 0 ||
      static_cast<size_t>(stage_bytes) < sub_rows * row_bytes || stage_bytes % 128 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // Ring, the four chunk-wide pair arrays, the barriers.
  const size_t smem = static_cast<size_t>(K4_STAGES) * stage_bytes + 16 * static_cast<size_t>(chunk) +
                      2 * K4_STAGES * sizeof(uint64_t);
  if (smem > static_cast<size_t>(K4_SMEM_LIMIT)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(nq, groups);
#define VITORCH_K4_MODE(NCH, VEC)                                                                \
  launch_fused_mode<L2, T, NCH, VEC>(grid, smem, st, queries, cent, cid2d, blk2d, nval2d, bias2d, \
                                     vecs, norms, scales, t_fixed, t_sub, chunk, groups, d, lpr, \
                                     sub_rows, row_align, stage_bytes, dist_plane, slot_plane)
  if (nch == 1) return vec ? VITORCH_K4_MODE(1, true) : VITORCH_K4_MODE(1, false);
  if (nch == 2) return vec ? VITORCH_K4_MODE(2, true) : VITORCH_K4_MODE(2, false);
  if constexpr (sizeof(T) == 2) return vec ? VITORCH_K4_MODE(4, true) : VITORCH_K4_MODE(4, false);
  return static_cast<int>(cudaErrorInvalidValue);
#undef VITORCH_K4_MODE
}

// The split plan (slice, parts, sub_rows, stage_bytes) comes from the
// wrapper (ops/block_stream.py::stream_distances_split_plan,
// stream_fused_split_plan); it is checked here. part_dots holds nq *
// t_fixed * n_slices * chunk floats; only the valid rows' entries are
// written and read. Launches stream_partial_kernel over a task grid of
// integer type I; the caller launches the second pass.
template <bool L2, typename T, typename I>
int launch_partial(const void* queries, const void* cent, const void* cid2d, const void* blk2d,
                   const void* nval2d, const void* vecs, int nq, int t_fixed, int chunk, int d,
                   int slice, int parts, int sub_rows, int stage_bytes, void* part_dots,
                   cudaStream_t st) {
  constexpr int EPC = 16 / sizeof(T);
  const bool vec = (static_cast<size_t>(d) * sizeof(T)) % 16 == 0;
  if (slice < EPC || slice % EPC != 0 || parts < 1 || sub_rows < 1 || sub_rows > chunk ||
      stage_bytes % 128 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_slices = (d + slice - 1) / slice;
  // A segment's stride in a stage leaves room for an unaligned envelope.
  const int seg_stride = slice * static_cast<int>(sizeof(T)) + (vec ? 0 : 32);
  const size_t smem = static_cast<size_t>(PART_STAGES) * stage_bytes +
                      2 * PART_STAGES * sizeof(uint64_t) + 2 * sizeof(float) * slice;
  if (static_cast<size_t>(stage_bytes) < static_cast<size_t>(sub_rows) * seg_stride ||
      smem > static_cast<size_t>(K4_SMEM_LIMIT) || n_slices > 65535 ||
      static_cast<size_t>(nq) * parts > 0x7fffffffu)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = vec ? &stream_partial_kernel<L2, T, true, I>
                  : &stream_partial_kernel<L2, T, false, I>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<dim3(static_cast<unsigned>(nq) * parts, n_slices), PART_THREADS, smem, st>>>(
      static_cast<const float*>(queries), static_cast<const float*>(cent),
      static_cast<const I*>(cid2d), static_cast<const I*>(blk2d), static_cast<const I*>(nval2d),
      static_cast<const T*>(vecs), t_fixed, chunk, d, parts, slice, n_slices, sub_rows,
      seg_stride, stage_bytes, static_cast<float*>(part_dots));
  return static_cast<int>(cudaGetLastError());
}

// K2's split launch: the partial dots, then the finish kernel over every
// lane of out (an int64 task grid), launched as the partial kernel's
// programmatic dependent so that its launch and first loads overlap the
// partial kernel's tail.
template <bool L2, typename T>
int launch_distances_split(const void* queries, const void* cent, const void* cid2d,
                           const void* blk2d, const void* nval2d, const void* bias2d,
                           const void* vecs, const void* norms, const void* scales, int nq,
                           int t_fixed, int chunk, int d, int slice, int parts, int sub_rows,
                           int stage_bytes, void* part_dots, void* out, cudaStream_t st) {
  const int rc = launch_partial<L2, T, int64_t>(queries, cent, cid2d, blk2d, nval2d, vecs, nq,
                                                t_fixed, chunk, d, slice, parts, sub_rows,
                                                stage_bytes, part_dots, st);
  if (rc != 0) return rc;
  const size_t n_out = static_cast<size_t>(nq) * t_fixed * chunk;
  const size_t blocks = (n_out + K2F_THREADS - 1) / K2F_THREADS;
  if (blocks > 0x7fffffffu) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(K2F_THREADS);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, stream_distances_finish_kernel<L2, T>, static_cast<const int64_t*>(cid2d),
      static_cast<const int64_t*>(blk2d), static_cast<const int64_t*>(nval2d),
      static_cast<const float*>(bias2d), static_cast<const float*>(norms),
      static_cast<const float*>(scales), static_cast<const float*>(part_dots), chunk,
      (d + slice - 1) / slice, n_out, static_cast<float*>(out)));
}

// K4's split launch: the partial dots, then the fold kernel.
template <bool L2, typename T>
int launch_fused_split(const void* queries, const void* cent, const void* cid2d,
                       const void* blk2d, const void* nval2d, const void* bias2d,
                       const void* vecs, const void* norms, const void* scales, int nq,
                       int t_fixed, int t_sub, int chunk, int groups, int d, int slice, int parts,
                       int sub_rows, int stage_bytes, void* part_dots, void* dist_plane,
                       void* slot_plane, cudaStream_t st) {
  if (chunk % 16 != 0 || t_sub < 1 || t_fixed % t_sub != 0 || groups < 1 ||
      (t_fixed / t_sub) % groups != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = launch_partial<L2, T, int>(queries, cent, cid2d, blk2d, nval2d, vecs, nq,
                                            t_fixed, chunk, d, slice, parts, sub_rows,
                                            stage_bytes, part_dots, st);
  if (rc != 0) return rc;
  stream_fused_fold_kernel<L2, T><<<dim3(nq, groups, (chunk + K4F_LANES - 1) / K4F_LANES),
                                    K4F_THREADS, 0, st>>>(
      static_cast<const int*>(cid2d), static_cast<const int*>(blk2d),
      static_cast<const int*>(nval2d), static_cast<const float*>(bias2d),
      static_cast<const float*>(norms), static_cast<const float*>(scales),
      static_cast<const float*>(part_dots), t_fixed, t_sub, chunk, groups,
      (d + slice - 1) / slice, static_cast<float*>(dist_plane), static_cast<int*>(slot_plane));
  return 0;
}

}  // namespace

// nval2d may be null (every lane computed); lpr / spb: the wrapper's plan
// (lanes per row, slots per block).
VITORCH_API int vitorch_stream_distances(
    const void* queries, const void* cent, const void* cid2d, const void* blk2d,
    const void* nval2d, const void* bias2d, const void* vecs, const void* norms,
    const void* scales, int nq, int t_fixed, int chunk, int d, int is_l2, int row_type, int lpr,
    int spb, void* out, void* stream) {
  if (static_cast<size_t>(nq) * t_fixed == 0) return static_cast<int>(cudaGetLastError());
  auto st = static_cast<cudaStream_t>(stream);
  int rc = 0;
#define VITORCH_K2(L2, T)                                                                      \
  rc = launch_distances<L2, T>(queries, cent, cid2d, blk2d, nval2d, bias2d, vecs, norms, scales, \
                               nq, t_fixed, chunk, d, lpr, spb, out, st)
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
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// K2's split launch (rows past 128 16-byte chunks: the partial dots, then
// the finish kernel): cid2d / blk2d / nval2d are int64 (nval2d may be
// null); slice / parts / sub_rows / stage_bytes are the wrapper's plan;
// part_dots is its scratch.
VITORCH_API int vitorch_stream_distances_split(
    const void* queries, const void* cent, const void* cid2d, const void* blk2d,
    const void* nval2d, const void* bias2d, const void* vecs, const void* norms,
    const void* scales, int nq, int t_fixed, int chunk, int d, int is_l2, int row_type,
    int slice, int parts, int sub_rows, int stage_bytes, void* part_dots, void* out,
    void* stream) {
  if (static_cast<size_t>(nq) * t_fixed == 0) return static_cast<int>(cudaGetLastError());
  auto st = static_cast<cudaStream_t>(stream);
  int rc = 0;
#define VITORCH_K2S(L2, T)                                                                      \
  rc = launch_distances_split<L2, T>(queries, cent, cid2d, blk2d, nval2d, bias2d, vecs, norms,   \
                                     scales, nq, t_fixed, chunk, d, slice, parts, sub_rows,      \
                                     stage_bytes, part_dots, out, st)
  switch (row_type) {
    case vitorch::ROW_BF16:
      if (is_l2) VITORCH_K2S(true, __nv_bfloat16); else VITORCH_K2S(false, __nv_bfloat16);
      break;
    case vitorch::ROW_INT8:
      if (is_l2) VITORCH_K2S(true, int8_t); else VITORCH_K2S(false, int8_t);
      break;
    case vitorch::ROW_F32:
      if (is_l2) VITORCH_K2S(true, float); else VITORCH_K2S(false, float);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VITORCH_K2S
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

VITORCH_API int vitorch_stream_fused_plane(
    const void* queries, const void* cent, const void* cid2d, const void* blk2d,
    const void* nval2d, const void* bias2d, const void* vecs, const void* norms,
    const void* scales, int nq, int t_fixed, int t_sub, int chunk, int groups, int d,
    int is_l2, int row_type, int nch, int lpr, int sub_rows, int row_align, int stage_bytes,
    void* dist_plane, void* slot_plane, void* stream) {
  if (nq <= 0) return static_cast<int>(cudaGetLastError());
  auto st = static_cast<cudaStream_t>(stream);
  int rc = 0;
#define VITORCH_K4(L2, T)                                                                 \
  rc = launch_fused<L2, T>(queries, cent, cid2d, blk2d, nval2d, bias2d, vecs, norms, scales, \
                           nq, t_fixed, t_sub, chunk, groups, d, nch, lpr, sub_rows,          \
                           row_align, stage_bytes, dist_plane, slot_plane, st)
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

// K4's split launch (the partial dots, then the fold): slice / parts /
// sub_rows / stage_bytes are the wrapper's plan; part_dots is its scratch.
VITORCH_API int vitorch_stream_fused_split(
    const void* queries, const void* cent, const void* cid2d, const void* blk2d,
    const void* nval2d, const void* bias2d, const void* vecs, const void* norms,
    const void* scales, int nq, int t_fixed, int t_sub, int chunk, int groups, int d,
    int is_l2, int row_type, int slice, int parts, int sub_rows, int stage_bytes,
    void* part_dots, void* dist_plane, void* slot_plane, void* stream) {
  if (nq <= 0) return static_cast<int>(cudaGetLastError());
  auto st = static_cast<cudaStream_t>(stream);
  int rc = 0;
#define VITORCH_K4S(L2, T)                                                                      \
  rc = launch_fused_split<L2, T>(queries, cent, cid2d, blk2d, nval2d, bias2d, vecs, norms, scales, \
                                 nq, t_fixed, t_sub, chunk, groups, d, slice, parts, sub_rows,   \
                                 stage_bytes, part_dots, dist_plane, slot_plane, st)
  switch (row_type) {
    case vitorch::ROW_BF16:
      if (is_l2) VITORCH_K4S(true, __nv_bfloat16); else VITORCH_K4S(false, __nv_bfloat16);
      break;
    case vitorch::ROW_INT8:
      if (is_l2) VITORCH_K4S(true, int8_t); else VITORCH_K4S(false, int8_t);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VITORCH_K4S
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
