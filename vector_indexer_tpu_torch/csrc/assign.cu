// K1 - fused nearest-centroid assignment.
//
// Replaces vector_indexer_tpu/ops/pallas/assign.py:_kernel (reached through
// assign_argmin_pallas -> _assign_call). For every point x it returns
// argmin_c (|c|^2 - 2 x.c) and that minimum score; the Python wrapper adds
// |x|^2 back and clamps at 0. The (n, k) score matrix never reaches device
// memory.
//
// Design: one block per 64-point tile; the block walks all centroids in
// 64-wide tiles (the TPU grid's sequential centroid axis becomes this loop)
// and stages x and centroid slices of 32 dims through shared memory. Each
// of the 256 threads owns a 4 x 4 (point, centroid) micro-tile and keeps a
// running (min, argmin) per point with strict '<' over ascending centroid
// ids; the 16 threads that share a point row then reduce with ties broken
// toward the lower id. So the lowest index wins a tie, as jnp.argmin and the
// TPU kernel's tile fold do. Products are f32 FMA (no TF32), at least as
// exact as the TPU kernel's HIGHEST-precision passes.
//
// Bound on the H100 at the build's shape (n = 1M, k = 4000, d = 128):
// 5.1e11 FMA = 1.02 TFLOP of f32 work against 512 MB of x read once, so it
// is compute-bound on the CUDA cores (67 TFLOP/s f32 peak -> >= 15 ms).
// Left for later: the tensor cores (wgmma with a bf16x3 or 3xTF32 split to
// keep f32-grade argmins), TMA staging, and a larger register tile.
#include "common.cuh"

namespace {

constexpr int BM = 64;   // points per block
constexpr int BN = 64;   // centroids per tile
constexpr int BK = 32;   // dims per shared-memory stage
constexpr int TM = 4;    // points per thread
constexpr int TN = 4;    // centroids per thread
constexpr int COLS = BN / TN;                // 16 threads across centroids
constexpr int THREADS = (BM / TM) * COLS;    // 256

__global__ void __launch_bounds__(THREADS) assign_argmin_kernel(
    const float* __restrict__ x, const float* __restrict__ c,
    const float* __restrict__ c_sq, int n, int k, int d,
    float* __restrict__ best_score, int* __restrict__ best_idx) {
  __shared__ float xs[BK][BM + 4];
  __shared__ float cs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % COLS;  // centroid micro-column
  const int ty = tid / COLS;  // point micro-row
  const int row0 = blockIdx.x * BM;

  float best[TM];
  int besti[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best[i] = vitorch::inf_f();
    besti[i] = 0x7fffffff;
  }

  for (int c0 = 0; c0 < k; c0 += BN) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += BK) {
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int r = e / BK, kk = e % BK;
        const int gr = row0 + r, gk = k0 + kk;
        xs[kk][r] = (gr < n && gk < d) ? x[(size_t)gr * d + gk] : 0.f;
      }
      for (int e = tid; e < BN * BK; e += THREADS) {
        const int r = e / BK, kk = e % BK;
        const int gc = c0 + r, gk = k0 + kk;
        cs[kk][r] = (gc < k && gk < d) ? c[(size_t)gc * d + gk] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = cs[kk][tx + j * COLS];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    // Fold this tile: this thread's centroid ids rise with j, so strict '<'
    // keeps the lowest id among its equal scores.
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int cj = c0 + tx + j * COLS;
      if (cj < k) {
        const float cn = c_sq[cj];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float s = cn - 2.f * acc[i][j];
          if (s < best[i]) {
            best[i] = s;
            besti[i] = cj;
          }
        }
      }
    }
  }

  // Reduce across the 16 threads of a point row (adjacent lanes of one
  // warp): smaller score wins, the lower centroid id breaks a tie.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float s = best[i];
    int bi = besti[i];
#pragma unroll
    for (int off = COLS / 2; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, s, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (os < s || (os == s && oi < bi)) {
        s = os;
        bi = oi;
      }
    }
    const int gr = row0 + ty * TM + i;
    if (tx == 0 && gr < n) {
      best_score[gr] = s;
      best_idx[gr] = bi;
    }
  }
}

}  // namespace

VITORCH_API int vitorch_assign_argmin(const void* x, const void* c,
                                      const void* c_sq, int n, int k, int d,
                                      void* best_score, void* best_idx,
                                      void* stream) {
  if (n > 0) {
    const dim3 grid((n + BM - 1) / BM);
    assign_argmin_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(c),
        static_cast<const float*>(c_sq), n, k, d,
        static_cast<float*>(best_score), static_cast<int*>(best_idx));
  }
  return static_cast<int>(cudaGetLastError());
}
