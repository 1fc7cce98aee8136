// K6 - per-query distances to the rows of every probed posting list,
// written to packed candidate slots.
//
// Replaces vector_indexer_tpu/ops/pallas/ivf_gather.py:_kernel_factory
// (reached through ivf_gather_distances, the pallas_call at :197).
//
// What it computes: query i probes p lists; probe j's rows are the
// contiguous layout rows [start_j, start_j + len_j). Probe j owns the
// max_len_pad slots that start at offs_j (the exclusive prefix sum of
// round_up(len, 128), clamped to width - max_len_pad; the wrapper computes
// it), written in probe order, so a later probe overwrites an earlier
// one's tail. offs is non-decreasing in j, so the slot s of query i ends
// up owned by the last probe with offs_j <= s: the blocks' ranges
// [offs_j, offs_{j+1}) (the last up to width) partition the row, and each
// block writes its range alone, in any order. Slot offs_j + t holds
// row start_j + t and its distance when t < min(len_j, max_len_pad), and
// +inf / -1 otherwise:
//     l2: max(|q|^2 - 2 q.x + |x|^2, 0)   (|x|^2 from the row itself)
//     ip: -q.x
//
// The TPU kernel copied each probed list into VMEM scratch with
// concurrent chunked DMAs and ran one matvec over all of them; a Hopper
// block reads its list's rows in place instead (one warp per row,
// coalesced across the row's d elements), so there is no scratch budget
// and no d % 128 requirement. Up to d 12,288, where one item (below)
// holds a probe's whole segment (d 128: up to 2,048 slots), one block per
// (query, probe); the query's first `qres` elements sit in shared memory
// (all of it: the wrapper's plan, ops/ivf_gather.py::ivf_gather_plan), and
// past them every warp reads the query through L1, where the block's
// other warps find it; the row's dot and |x|^2 run on over both parts.
// Wider rows and longer segments take the item launch (ivf_gather_items_
// kernel, ops/ivf_gather.py::ivf_gather_item_plan), so any d is served.
//
// Bound on the H100: memory. Each row is read once per query that probes
// it (d * 4 bytes for 2 d FLOPs of dot and 2 d of norm), and the packed
// output (8 bytes per slot) is written once. Left for later: several
// queries per block that share a list.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <bool L2>
__global__ void __launch_bounds__(THREADS) ivf_gather_kernel(
    const float* __restrict__ q, const float* __restrict__ vectors,
    const int* __restrict__ starts, const int* __restrict__ lengths,
    const int* __restrict__ offs, int p, int d, int qres, int max_len_pad, int width,
    float* __restrict__ dist, int* __restrict__ rows) {
  extern __shared__ float qs[];
  const int qi = blockIdx.x / p;
  const int j = blockIdx.x % p;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t pj = (size_t)qi * p + j;
  const int off = offs[pj];
  const int end = j + 1 < p ? offs[pj + 1] : width;
  if (end <= off) return;  // an empty range: a later probe owns these slots
  const int start = starts[pj];
  const int len = min(lengths[pj], max_len_pad);
  const int n_valid = max(0, min(len, end - off));
  const float* qg = q + (size_t)qi * d;  // past qres: read through L1
  for (int k = threadIdx.x; k < qres; k += THREADS) qs[k] = qg[k];
  __syncthreads();
  float* drow = dist + (size_t)qi * width + off;
  int* rrow = rows + (size_t)qi * width + off;
  float q_sq = 0.f;
  if (L2) {
    for (int k = lane; k < qres; k += 32) q_sq = fmaf(qs[k], qs[k], q_sq);
    for (int k = qres + lane; k < d; k += 32) {
      const float qv = __ldg(qg + k);
      q_sq = fmaf(qv, qv, q_sq);
    }
    q_sq = vitorch::warp_sum(q_sq);
  }
  for (int t = warp; t < n_valid; t += WARPS) {
    const float* x = vectors + (size_t)(start + t) * d;
    float cross = 0.f, nrm = 0.f;
    for (int k = lane; k < qres; k += 32) {
      const float xv = x[k];
      cross = fmaf(qs[k], xv, cross);
      nrm = fmaf(xv, xv, nrm);
    }
    for (int k = qres + lane; k < d; k += 32) {
      const float xv = x[k];
      cross = fmaf(__ldg(qg + k), xv, cross);
      nrm = fmaf(xv, xv, nrm);
    }
    cross = vitorch::warp_sum(cross);
    nrm = vitorch::warp_sum(nrm);
    if (lane == 0) {
      drow[t] = L2 ? fmaxf(q_sq - 2.f * cross + nrm, 0.f) : -cross;
      rrow[t] = start + t;
    }
  }
  for (int t = n_valid + threadIdx.x; t < end - off; t += THREADS) {
    drow[t] = vitorch::inf_f();
    rrow[t] = -1;
  }
}

// ---- wide rows: bounded work items ------------------------------------------
//
// One block per (query, probe) puts a long list (777 rows of 64 KB at d
// 16,384: 50 MB) on one SM while the others idle. The item launch cuts
// each probe's slot range [off, end) into items of `item_rows` slots:
// block (query * p + j, y) owns slots [off + y R, off + (y + 1) R), the
// last item y = items - 1 also every slot past them up to end (the last
// probe's range runs on to the row's end), and a block whose item starts
// at or past end returns at once. The ranges stay the single-block
// launch's, so each slot keeps its owner, and each item writes its own
// rows and holes. Rows are read with 16-byte loads (rows of a multiple of
// 4 floats), K6_U per lane in flight, one row per warp at a time, against
// the query in shared memory: all of it, or (past the opt-in's 227 KB)
// `panel` elements at a time, each warp then carrying its one row's partial
// dot and norm across the panels.

constexpr int K6_U = 8;  // loads in flight per lane

// A row segment's dot with qs and its squared norm, accumulated into
// (cross, nrm): n elements at x (16-byte aligned when VEC), 32 lanes.
template <bool VEC>
__device__ __forceinline__ void row_terms(const float* __restrict__ x, const float* qs, int n,
                                          int lane, float& cross, float& nrm) {
  if (VEC) {
    const float4* xv = reinterpret_cast<const float4*>(x);
    const float4* qv = reinterpret_cast<const float4*>(qs);
    const int n4 = n / 4;
    for (int c0 = lane; c0 < n4; c0 += 32 * K6_U) {
      float4 w[K6_U];
#pragma unroll
      for (int u = 0; u < K6_U; ++u) {
        const int c = c0 + 32 * u;
        w[u] = c < n4 ? __ldg(xv + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < K6_U; ++u) {
        const int c = c0 + 32 * u;
        if (c < n4) {
          const float4 qf = qv[c];
          cross = fmaf(qf.x, w[u].x, cross);
          cross = fmaf(qf.y, w[u].y, cross);
          cross = fmaf(qf.z, w[u].z, cross);
          cross = fmaf(qf.w, w[u].w, cross);
          nrm = fmaf(w[u].x, w[u].x, nrm);
          nrm = fmaf(w[u].y, w[u].y, nrm);
          nrm = fmaf(w[u].z, w[u].z, nrm);
          nrm = fmaf(w[u].w, w[u].w, nrm);
        }
      }
    }
  } else {
    for (int k0 = lane; k0 < n; k0 += 32 * K6_U) {
      float w[K6_U];
#pragma unroll
      for (int u = 0; u < K6_U; ++u) {
        const int k = k0 + 32 * u;
        w[u] = k < n ? __ldg(x + k) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < K6_U; ++u) {
        const int k = k0 + 32 * u;
        if (k < n) {
          cross = fmaf(qs[k], w[u], cross);
          nrm = fmaf(w[u], w[u], nrm);
        }
      }
    }
  }
}

template <bool L2, bool VEC>
__global__ void __launch_bounds__(THREADS) ivf_gather_items_kernel(
    const float* __restrict__ q, const float* __restrict__ vectors,
    const int* __restrict__ starts, const int* __restrict__ lengths,
    const int* __restrict__ offs, int p, int d, int item_rows, int panel, int max_len_pad,
    int width, float* __restrict__ dist, int* __restrict__ rows) {
  extern __shared__ __align__(16) float qs_items[];  // panel floats
  __shared__ float wsum[WARPS];
  const int qi = blockIdx.x / p;
  const int j = blockIdx.x % p;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t pj = (size_t)qi * p + j;
  const int off = offs[pj];
  const int span = (j + 1 < p ? offs[pj + 1] : width) - off;
  const int lo = blockIdx.y * item_rows;
  if (lo >= span) return;  // past this probe's range (or an empty range)
  const int hi = blockIdx.y + 1 == gridDim.y ? span : min(lo + item_rows, span);
  const int start = starts[pj];
  const int n_valid = max(0, min(min(lengths[pj], max_len_pad), span));
  const int v_hi = min(hi, n_valid);
  float* drow = dist + (size_t)qi * width + off;
  int* rrow = rows + (size_t)qi * width + off;
  for (int t = max(lo, n_valid) + threadIdx.x; t < hi; t += THREADS) {
    drow[t] = vitorch::inf_f();
    rrow[t] = -1;
  }
  if (lo >= v_hi) return;  // holes only
  const float* qg = q + (size_t)qi * d;
  float q_sq = 0.f;
  if (L2) {  // |q|^2 in a fixed order: per thread, per warp, then the warps in order
    for (int k = threadIdx.x; k < d; k += THREADS) {
      const float qv = __ldg(qg + k);
      q_sq = fmaf(qv, qv, q_sq);
    }
    q_sq = vitorch::warp_sum(q_sq);
    if (lane == 0) wsum[warp] = q_sq;
  }
  const bool resident = panel >= d;
  float cross = 0.f, nrm = 0.f;  // panels: this warp's row, lo + warp, across the panels
  for (int k0 = 0; k0 < d; k0 += panel) {
    const int pw = min(panel, d - k0);
    if (k0 > 0) __syncthreads();  // every warp is done with the previous panel
    for (int k = threadIdx.x; k < pw; k += THREADS) qs_items[k] = qg[k0 + k];
    __syncthreads();
    if (resident) {
      if (L2) {
        q_sq = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) q_sq += wsum[w];
      }
      for (int t = lo + warp; t < v_hi; t += WARPS) {
        float c = 0.f, n = 0.f;
        row_terms<VEC>(vectors + (size_t)(start + t) * d, qs_items, d, lane, c, n);
        c = vitorch::warp_sum(c);
        n = vitorch::warp_sum(n);
        if (lane == 0) {
          drow[t] = L2 ? fmaxf(q_sq - 2.f * c + n, 0.f) : -c;
          rrow[t] = start + t;
        }
      }
    } else if (lo + warp < v_hi) {
      row_terms<VEC>(vectors + (size_t)(start + lo + warp) * d + k0, qs_items, pw, lane, cross,
                     nrm);
    }
  }
  if (!resident && lo + warp < v_hi) {
    if (L2) {
      q_sq = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) q_sq += wsum[w];
    }
    cross = vitorch::warp_sum(cross);
    nrm = vitorch::warp_sum(nrm);
    if (lane == 0) {
      const int t = lo + warp;
      drow[t] = L2 ? fmaxf(q_sq - 2.f * cross + nrm, 0.f) : -cross;
      rrow[t] = start + t;
    }
  }
}

}  // namespace

// q (nq, d) f32, vectors (n_pad, d) f32, starts / lengths / offs (nq, p)
// int32; dist (nq, width) f32 and rows (nq, width) int32, every slot
// written. qres: the query elements held in shared memory (the wrapper's
// plan: d, or a multiple of 32 below it, at most 48 KB of floats).
VITORCH_API int vitorch_ivf_gather_distances(const void* q, const void* vectors,
                                             const void* starts, const void* lengths,
                                             const void* offs, int nq, int p, int d, int qres,
                                             int max_len_pad, int width, int is_l2, void* dist,
                                             void* rows, void* stream) {
  if (qres < 0 || qres > d || (qres < d && qres % 32 != 0) ||
      (size_t)qres * sizeof(float) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq > 0 && p > 0) {
    const dim3 grid((unsigned)nq * (unsigned)p);
    const size_t smem = (size_t)qres * sizeof(float);
    auto st = static_cast<cudaStream_t>(stream);
    auto qp = static_cast<const float*>(q);
    auto vp = static_cast<const float*>(vectors);
    auto sp = static_cast<const int*>(starts);
    auto lp = static_cast<const int*>(lengths);
    auto op = static_cast<const int*>(offs);
    auto dp = static_cast<float*>(dist);
    auto rp = static_cast<int*>(rows);
    if (is_l2)
      ivf_gather_kernel<true><<<grid, THREADS, smem, st>>>(qp, vp, sp, lp, op, p, d, qres,
                                                          max_len_pad, width, dp, rp);
    else
      ivf_gather_kernel<false><<<grid, THREADS, smem, st>>>(qp, vp, sp, lp, op, p, d, qres,
                                                           max_len_pad, width, dp, rp);
  }
  return static_cast<int>(cudaGetLastError());
}

// The item launch (wide rows): the wrapper's plan (ops/ivf_gather.py::
// ivf_gather_item_plan) gives item_rows, items (the grid's second
// dimension: items * item_rows covers max_len_pad) and the query elements
// held in shared memory at a time (d, or past the opt-in a multiple of 4,
// with at most one row per warp in an item); checked here.
VITORCH_API int vitorch_ivf_gather_items(const void* q, const void* vectors, const void* starts,
                                         const void* lengths, const void* offs, int nq, int p,
                                         int d, int item_rows, int items, int panel,
                                         int max_len_pad, int width, int is_l2, void* dist,
                                         void* rows, void* stream) {
  const size_t smem = (size_t)panel * sizeof(float);
  if (item_rows < 1 || items < 1 || items > 65535 ||
      (size_t)items * item_rows < (size_t)max_len_pad || panel < 1 || panel > d ||
      (panel < d && (panel % 4 != 0 || item_rows > WARPS)) || smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq > 0 && p > 0) {
    const bool vec = d % 4 == 0 && (reinterpret_cast<uintptr_t>(vectors) & 15u) == 0;
    auto kern = is_l2 ? (vec ? &ivf_gather_items_kernel<true, true>
                             : &ivf_gather_items_kernel<true, false>)
                      : (vec ? &ivf_gather_items_kernel<false, true>
                             : &ivf_gather_items_kernel<false, false>);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kern<<<dim3((unsigned)nq * (unsigned)p, items), THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(vectors),
        static_cast<const int*>(starts), static_cast<const int*>(lengths),
        static_cast<const int*>(offs), p, d, item_rows, panel, max_len_pad, width,
        static_cast<float*>(dist), static_cast<int*>(rows));
  }
  return static_cast<int>(cudaGetLastError());
}
