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
// and no d % 128 requirement. One block per (query, probe); the query's
// first `qres` elements sit in shared memory (all of it up to d 12,288,
// 48 KB: the wrapper's plan, ops/ivf_gather.py::ivf_gather_plan), and
// past them every warp reads the query through L1, where the block's
// other warps find it; the row's dot and |x|^2 run on over both parts, so
// any d is served.
//
// Bound on the H100: memory. Each row is read once per query that probes
// it (d * 4 bytes for 2 d FLOPs of dot and 2 d of norm), and the packed
// output (8 bytes per slot) is written once. Left for later: several
// queries per block that share a list, and TMA or cp.async bulk copies
// of whole lists.
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
