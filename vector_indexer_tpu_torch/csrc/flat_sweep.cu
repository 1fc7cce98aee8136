// K3 - fused exhaustive sweep with on-chip top-2-per-lane selection.
//
// Replaces vector_indexer_tpu/ops/pallas/flat_sweep.py:_acc_kernel_factory
// and _window_min_step (reached through flat_sweep_topk_plane), f32 mode.
//
// What it computes (the reference's grid step j covers rows
// [j * NB, (j + 1) * NB), NB = 128 * w): for each query and output lane
// c < 128, the window minimum over rows {j*NB + jj*128 + c : jj < w} of
//     l2: |x|^2 - 2 q.x          ip: penalty - q.x
// (|q|^2 is added by the caller after selection), where rows past the
// table, and rows whose 8-row mask block is 0 in the masked (IVF dense)
// mode, are +inf before the min. Ties keep the lower jj. The window minimum
// then enters group j % C's running (best, second) pair for that lane with
// strict '<', the displaced best falling through to second. Outputs are the
// four (nq, C * 128) planes v1, i1, v2, i2; unfilled entries are +inf / -1.
//
// Hopper has no sequential grid, so the reference's j axis becomes a loop.
// Groups are independent (group g only ever sees steps j = g, g + C, ...),
// so each block owns one (64-query tile, 64-lane range, group) triple and
// walks its steps in ascending j: the same fold order as the TPU grid, with
// the top-2 state in registers. Within a step the block runs w small
// 64 x 64 x d f32 products staged through shared memory (4 x 4 register
// tile per thread). In masked mode a tile whose 64 queries x 64 rows are
// all unprobed skips its product: the reference sets those distances to
// +inf anyway.
//
// Bound on the H100: compute. Unmasked it is 2 nq n d f32 FLOPs against
// one table read per 64-query tile (n * d * 4 / 64 bytes per query: ~32
// FLOP/byte), so the f32 CUDA-core peak (67 TFLOP/s) is the roofline; the
// masked mode skips the tiles nobody probes. Left for later: the tensor
// cores (wgmma with a bf16x3 split, the reference's '3pass'), TMA staging
// of table tiles, keeping the query tile resident, and the int8 modes.
#include "common.cuh"

namespace {

constexpr int S = 128;       // lanes per grid step
constexpr int QT = 64;       // queries per block
constexpr int LT = 64;       // lanes per block
constexpr int BK = 32;       // dims per shared-memory stage
constexpr int TQ = 4;        // queries per thread
constexpr int TL = 4;        // lanes per thread
constexpr int COLS = LT / TL;            // 16
constexpr int THREADS = (QT / TQ) * COLS;  // 256
constexpr int MASK_ALIGN = 8;  // rows per mask element

template <bool L2, bool MASKED>
__global__ void __launch_bounds__(THREADS) flat_sweep_topk_plane_kernel(
    const float* __restrict__ q, const float* __restrict__ x,
    const float* __restrict__ norms, const uint8_t* __restrict__ mask, int nq,
    int n_rows, int d, int w, int c_groups, int mcols, float* __restrict__ v1,
    int* __restrict__ i1, float* __restrict__ v2, int* __restrict__ i2) {
  __shared__ float qs[BK][QT + 4];
  __shared__ float xs[BK][LT + 4];
  const int tid = threadIdx.x;
  const int tl = tid % COLS;
  const int tq = tid / COLS;
  const int q0 = blockIdx.x * QT;
  const int lane0 = blockIdx.y * LT;
  const int g = blockIdx.z;
  const int NB = S * w;
  const int nj = (n_rows + NB - 1) / NB;

  float bv1[TQ][TL], bv2[TQ][TL];
  int bi1[TQ][TL], bi2[TQ][TL];
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int l = 0; l < TL; ++l) {
      bv1[i][l] = vitorch::inf_f();
      bv2[i][l] = vitorch::inf_f();
      bi1[i][l] = -1;
      bi2[i][l] = -1;
    }

  for (int j = g; j < nj; j += c_groups) {
    float wv[TQ][TL];
    int wr[TQ][TL];
    for (int jj = 0; jj < w; ++jj) {
      // Rows of this tile: tile lane t in [0, 64) is output lane lane0 + t.
      const int rbase = j * NB + jj * S + lane0;
      bool live = true;
      if (MASKED) {
        // 64 queries x 8 mask blocks; each thread checks two entries.
        int any = 0;
        for (int e = tid; e < QT * (LT / MASK_ALIGN); e += THREADS) {
          const int qi = q0 + e / (LT / MASK_ALIGN);
          const int row = rbase + (e % (LT / MASK_ALIGN)) * MASK_ALIGN;
          if (qi < nq && row < n_rows && mask[(size_t)qi * mcols + row / MASK_ALIGN])
            any = 1;
        }
        live = __syncthreads_or(any) != 0;
      }
      float acc[TQ][TL];
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int l = 0; l < TL; ++l) acc[i][l] = 0.f;
      if (live) {
        for (int k0 = 0; k0 < d; k0 += BK) {
          for (int e = tid; e < QT * BK; e += THREADS) {
            const int r = e / BK, kk = e % BK;
            const int gq = q0 + r, gk = k0 + kk;
            qs[kk][r] = (gq < nq && gk < d) ? q[(size_t)gq * d + gk] : 0.f;
          }
          for (int e = tid; e < LT * BK; e += THREADS) {
            const int r = e / BK, kk = e % BK;
            const int gr = rbase + r, gk = k0 + kk;
            xs[kk][r] = (gr < n_rows && gk < d) ? x[(size_t)gr * d + gk] : 0.f;
          }
          __syncthreads();
#pragma unroll 8
          for (int kk = 0; kk < BK; ++kk) {
            float a[TQ], b[TL];
#pragma unroll
            for (int i = 0; i < TQ; ++i) a[i] = qs[kk][tq * TQ + i];
#pragma unroll
            for (int l = 0; l < TL; ++l) b[l] = xs[kk][tl + l * COLS];
#pragma unroll
            for (int i = 0; i < TQ; ++i)
#pragma unroll
              for (int l = 0; l < TL; ++l) acc[i][l] = fmaf(a[i], b[l], acc[i][l]);
          }
          __syncthreads();
        }
      }
      // Distances and the strided window min (lower jj wins a tie).
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const int qi = q0 + tq * TQ + i;
#pragma unroll
        for (int l = 0; l < TL; ++l) {
          const int row = rbase + tl + l * COLS;
          float dist = vitorch::inf_f();
          if (live && row < n_rows) {
            const float nrm = norms[row];
            dist = L2 ? nrm - 2.f * acc[i][l]
                      : (nrm >= VITORCH_SENTINEL ? nrm : 0.f) - acc[i][l];
            if (MASKED && (qi >= nq || !mask[(size_t)qi * mcols + row / MASK_ALIGN]))
              dist = vitorch::inf_f();
          }
          if (jj == 0 || dist < wv[i][l]) {
            wv[i][l] = dist;
            wr[i][l] = row;
          }
        }
      }
    }
    // Fold the step's window minima into this group's top-2 planes.
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int l = 0; l < TL; ++l) {
        const float v = wv[i][l];
        const int r = wr[i][l];
        const bool b1 = v < bv1[i][l];
        const float lv = b1 ? bv1[i][l] : v;
        const int li = b1 ? bi1[i][l] : r;
        if (b1) {
          bv1[i][l] = v;
          bi1[i][l] = r;
        }
        if (lv < bv2[i][l]) {
          bv2[i][l] = lv;
          bi2[i][l] = li;
        }
      }
  }

  const int cs = c_groups * S;
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int qi = q0 + tq * TQ + i;
    if (qi >= nq) continue;
#pragma unroll
    for (int l = 0; l < TL; ++l) {
      const size_t o = (size_t)qi * cs + g * S + lane0 + tl + l * COLS;
      v1[o] = bv1[i][l];
      i1[o] = bi1[i][l];
      v2[o] = bv2[i][l];
      i2[o] = bi2[i][l];
    }
  }
}

template <bool L2, bool MASKED>
void launch_sweep(const float* q, const float* x, const float* norms,
                  const uint8_t* mask, int nq, int n_rows, int d, int w,
                  int c_groups, int mcols, float* v1, int* i1, float* v2, int* i2,
                  cudaStream_t st) {
  const dim3 grid((nq + QT - 1) / QT, S / LT, c_groups);
  flat_sweep_topk_plane_kernel<L2, MASKED><<<grid, THREADS, 0, st>>>(
      q, x, norms, mask, nq, n_rows, d, w, c_groups, mcols, v1, i1, v2, i2);
}

}  // namespace

VITORCH_API int vitorch_flat_sweep_topk_plane(
    const void* q, const void* x, const void* norms, const void* mask, int nq,
    int n_rows, int d, int w, int c_groups, int mcols, int is_l2, void* v1,
    void* i1, void* v2, void* i2, void* stream) {
  if (nq > 0) {
    auto qp = static_cast<const float*>(q);
    auto xp = static_cast<const float*>(x);
    auto np_ = static_cast<const float*>(norms);
    auto mp = static_cast<const uint8_t*>(mask);
    auto v1p = static_cast<float*>(v1);
    auto i1p = static_cast<int*>(i1);
    auto v2p = static_cast<float*>(v2);
    auto i2p = static_cast<int*>(i2);
    auto st = static_cast<cudaStream_t>(stream);
    if (is_l2) {
      if (mp) launch_sweep<true, true>(qp, xp, np_, mp, nq, n_rows, d, w, c_groups, mcols, v1p, i1p, v2p, i2p, st);
      else launch_sweep<true, false>(qp, xp, np_, mp, nq, n_rows, d, w, c_groups, mcols, v1p, i1p, v2p, i2p, st);
    } else {
      if (mp) launch_sweep<false, true>(qp, xp, np_, mp, nq, n_rows, d, w, c_groups, mcols, v1p, i1p, v2p, i2p, st);
      else launch_sweep<false, false>(qp, xp, np_, mp, nq, n_rows, d, w, c_groups, mcols, v1p, i1p, v2p, i2p, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
