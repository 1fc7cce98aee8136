// K3 - fused exhaustive sweep with on-chip top-2-per-lane selection, and K7,
// its window argmin alone.
//
// Replaces vector_indexer_tpu/ops/pallas/flat_sweep.py:_acc_kernel_factory
// and _window_min_step (reached through flat_sweep_topk_plane, the
// pallas_call at :473) in the precisions 'highest' (f32), 'int8' and
// 'int8x1', and _kernel_factory (flat_sweep_minreduce, the pallas_call at
// :573) as the FOLD = false mode of the same kernel.
//
// What it computes (the reference's grid step j covers rows
// [j * NB, (j + 1) * NB), NB = 128 * w): for each query and output lane
// c < 128, the window minimum over rows {j*NB + jj*128 + c : jj < w} of
//     l2: |x|^2 - 2 q.x          ip: penalty - q.x
// (|q|^2 is added by the caller after selection), where rows past the
// table, and rows whose 8-row mask block is 0 in the masked (IVF dense)
// mode, are +inf before the min. Ties keep the lower jj. With FOLD the
// window minimum then enters group j % C's running (best, second) pair for
// that lane with strict '<', the displaced best falling through to second;
// the outputs are the four (nq, C * 128) planes v1, i1, v2, i2 (unfilled
// entries +inf / -1). Without FOLD (K7) step j's minima go to columns
// j * 128 + c of one (nq, nj * 128) plane.
//
// The cross term q.x: f32 FMAs for 'highest'; for the int8 modes, packed
// int8x4 dot products (__dp4a) of the wrapper's quantized queries (q8, qr8,
// per-query sq) against the table's codes (x8, r8, per-row sx), summed in
// int32 as SHIFT * q8.x8 + (q8.r8 + qr8.x8) ('int8') or q8.x8 ('int8x1') -
// integer sums, so equal to the plain version's in any order - and
// dequantized in the reference's order ((float)t * row_mul) * sq with
// row_mul = sx / SHIFT or sx. The two products are __fmul_rn, which nvcc
// never contracts into the FMA of the distance that follows.
//
// Hopper has no sequential grid, so the reference's j axis becomes a loop.
// Groups are independent (group g only ever sees steps j = g, g + C, ...),
// so each block owns one (64-query tile, 64-lane range, group) triple and
// walks its steps in ascending j: the same fold order as the TPU grid, with
// the top-2 state in registers (K7 spreads the steps over gridDim.z blocks
// the same way and folds nothing). Within a step the block runs w small
// 64 x 64 x d products staged through shared memory (4 x 4 register tile
// per thread). In masked mode a tile whose 64 queries x 64 rows are all
// unprobed skips its product: the reference sets those distances to +inf
// anyway.
//
// Bound on the H100: compute. Unmasked f32 it is 2 nq n d FLOPs against one
// table read per 64-query tile (~32 FLOP/byte), so the f32 CUDA-core peak
// (67 TFLOP/s) is the roofline; the int8 modes run one dp4a (8 int ops)
// per 4 dims and term against a table of 1-2 bytes per element. Left for
// later: the tensor cores (wgmma: a bf16x3 split for f32, s8 x s8 -> s32
// for the int8 modes), TMA staging of table tiles, and keeping the query
// tile resident.
#include "common.cuh"

namespace {

constexpr int S = 128;       // lanes per grid step
constexpr int QT = 64;       // queries per block
constexpr int LT = 64;       // lanes per block
constexpr int BK = 32;       // f32 dims per shared-memory stage
constexpr int BW = 16;       // int8x4 words (64 dims) per shared-memory stage
constexpr int TQ = 4;        // queries per thread
constexpr int TL = 4;        // lanes per thread
constexpr int COLS = LT / TL;            // 16
constexpr int THREADS = (QT / TQ) * COLS;  // 256
constexpr int MASK_ALIGN = 8;  // rows per mask element
constexpr int SHIFT = 64;      // int8 residual scale = main scale / SHIFT

enum Prec { P_F32 = 0, P_INT8 = 1, P_INT8X1 = 2 };

struct Operands {
  const float* q;       // (nq, d) f32 queries ('highest')
  const int* q8;        // (nq, d / 4) packed int8 query codes (int8 modes)
  const int* qr8;       // (nq, d / 4) packed query residual codes ('int8')
  const float* sq;      // (nq,) query scales (int8 modes)
  const float* x;       // (n_rows, d) f32 table ('highest')
  const int* x8;        // (n_rows, d / 4) packed int8 table codes
  const int* r8;        // (n_rows, d / 4) packed residual codes ('int8')
  const float* scales;  // (n_rows,) row scales (int8 modes)
  const float* norms;   // (n_rows,) f32 |x|^2; SENTINEL on gap/tail rows
  const uint8_t* mask;  // (nq, mcols) 8-row block mask, or null
};

// q.x for the thread's 4 x 4 (query, row) tile, f32.
__device__ __forceinline__ void tile_cross_f32(const Operands& o, int q0, int rbase, int nq,
                                               int n_rows, int d, int tid, int tq, int tl,
                                               float (&cross)[TQ][TL]) {
  __shared__ float qs[BK][QT + 4];
  __shared__ float xs[BK][LT + 4];
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int l = 0; l < TL; ++l) cross[i][l] = 0.f;
  for (int k0 = 0; k0 < d; k0 += BK) {
    for (int e = tid; e < QT * BK; e += THREADS) {
      const int r = e / BK, kk = e % BK;
      const int gq = q0 + r, gk = k0 + kk;
      qs[kk][r] = (gq < nq && gk < d) ? o.q[(size_t)gq * d + gk] : 0.f;
    }
    for (int e = tid; e < LT * BK; e += THREADS) {
      const int r = e / BK, kk = e % BK;
      const int gr = rbase + r, gk = k0 + kk;
      xs[kk][r] = (gr < n_rows && gk < d) ? o.x[(size_t)gr * d + gk] : 0.f;
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
        for (int l = 0; l < TL; ++l) cross[i][l] = fmaf(a[i], b[l], cross[i][l]);
    }
    __syncthreads();
  }
}

// Dequantized int8 cross term for the thread's 4 x 4 tile ('int8' or
// 'int8x1'); dw = d / 4 packed words per row.
template <int P>
__device__ __forceinline__ void tile_cross_int8(const Operands& o, int q0, int rbase, int nq,
                                                int n_rows, int dw, int tid, int tq, int tl,
                                                float (&cross)[TQ][TL]) {
  __shared__ int q8s[BW][QT + 4];
  __shared__ int qr8s[BW][QT + 4];
  __shared__ int x8s[BW][LT + 4];
  __shared__ int r8s[BW][LT + 4];
  int am[TQ][TL], ar[TQ][TL];  // q8.x8 and q8.r8 + qr8.x8
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int l = 0; l < TL; ++l) {
      am[i][l] = 0;
      ar[i][l] = 0;
    }
  for (int k0 = 0; k0 < dw; k0 += BW) {
    for (int e = tid; e < QT * BW; e += THREADS) {
      const int r = e / BW, kk = e % BW;
      const int gq = q0 + r, gk = k0 + kk;
      const bool in = gq < nq && gk < dw;
      q8s[kk][r] = in ? o.q8[(size_t)gq * dw + gk] : 0;
      if (P == P_INT8) qr8s[kk][r] = in ? o.qr8[(size_t)gq * dw + gk] : 0;
    }
    for (int e = tid; e < LT * BW; e += THREADS) {
      const int r = e / BW, kk = e % BW;
      const int gr = rbase + r, gk = k0 + kk;
      const bool in = gr < n_rows && gk < dw;
      x8s[kk][r] = in ? o.x8[(size_t)gr * dw + gk] : 0;
      if (P == P_INT8) r8s[kk][r] = in ? o.r8[(size_t)gr * dw + gk] : 0;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BW; ++kk) {
      int a[TQ], b[TL];
#pragma unroll
      for (int i = 0; i < TQ; ++i) a[i] = q8s[kk][tq * TQ + i];
#pragma unroll
      for (int l = 0; l < TL; ++l) b[l] = x8s[kk][tl + l * COLS];
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int l = 0; l < TL; ++l) am[i][l] = __dp4a(a[i], b[l], am[i][l]);
      if constexpr (P == P_INT8) {
        int qa[TQ], rb[TL];
#pragma unroll
        for (int i = 0; i < TQ; ++i) qa[i] = qr8s[kk][tq * TQ + i];
#pragma unroll
        for (int l = 0; l < TL; ++l) rb[l] = r8s[kk][tl + l * COLS];
#pragma unroll
        for (int i = 0; i < TQ; ++i)
#pragma unroll
          for (int l = 0; l < TL; ++l) {
            ar[i][l] = __dp4a(a[i], rb[l], ar[i][l]);
            ar[i][l] = __dp4a(qa[i], b[l], ar[i][l]);
          }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int qi = q0 + tq * TQ + i;
    const float s_q = qi < nq ? o.sq[qi] : 0.f;
#pragma unroll
    for (int l = 0; l < TL; ++l) {
      const int row = rbase + tl + l * COLS;
      float row_mul = row < n_rows ? o.scales[row] : 0.f;
      if (P == P_INT8) row_mul *= (1.f / SHIFT);  // exact: a power of two
      const int t = (P == P_INT8) ? am[i][l] * SHIFT + ar[i][l] : am[i][l];
      cross[i][l] = __fmul_rn(__fmul_rn(__int2float_rn(t), row_mul), s_q);
    }
  }
}

template <bool L2, bool MASKED, int P, bool FOLD>
__global__ void __launch_bounds__(THREADS) flat_sweep_kernel(
    Operands o, int nq, int n_rows, int d, int w, int mcols, float* __restrict__ v1,
    int* __restrict__ i1, float* __restrict__ v2, int* __restrict__ i2) {
  const int tid = threadIdx.x;
  const int tl = tid % COLS;
  const int tq = tid / COLS;
  const int q0 = blockIdx.x * QT;
  const int lane0 = blockIdx.y * LT;
  const int g = blockIdx.z;
  const int n_groups = gridDim.z;  // C when folding; the step stride for K7
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

  for (int j = g; j < nj; j += n_groups) {
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
          if (qi < nq && row < n_rows && o.mask[(size_t)qi * mcols + row / MASK_ALIGN])
            any = 1;
        }
        live = __syncthreads_or(any) != 0;
      }
      float cross[TQ][TL];
      if (live) {
        if constexpr (P == P_F32)
          tile_cross_f32(o, q0, rbase, nq, n_rows, d, tid, tq, tl, cross);
        else
          tile_cross_int8<P>(o, q0, rbase, nq, n_rows, d / 4, tid, tq, tl, cross);
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
            const float nrm = o.norms[row];
            dist = L2 ? nrm - 2.f * cross[i][l]
                      : (nrm >= VITORCH_SENTINEL ? nrm : 0.f) - cross[i][l];
            if (MASKED && (qi >= nq || !o.mask[(size_t)qi * mcols + row / MASK_ALIGN]))
              dist = vitorch::inf_f();
          }
          if (jj == 0 || dist < wv[i][l]) {
            wv[i][l] = dist;
            wr[i][l] = row;
          }
        }
      }
    }
    if constexpr (!FOLD) {  // K7: write the step's window minima
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const int qi = q0 + tq * TQ + i;
        if (qi >= nq) continue;
#pragma unroll
        for (int l = 0; l < TL; ++l) {
          const size_t oi = (size_t)qi * nj * S + (size_t)j * S + lane0 + tl + l * COLS;
          v1[oi] = wv[i][l];
          i1[oi] = wr[i][l];
        }
      }
      continue;
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
  if constexpr (FOLD) {
    const int cs = n_groups * S;
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int qi = q0 + tq * TQ + i;
      if (qi >= nq) continue;
#pragma unroll
      for (int l = 0; l < TL; ++l) {
        const size_t oi = (size_t)qi * cs + g * S + lane0 + tl + l * COLS;
        v1[oi] = bv1[i][l];
        i1[oi] = bi1[i][l];
        v2[oi] = bv2[i][l];
        i2[oi] = bi2[i][l];
      }
    }
  }
}

template <int P, bool FOLD>
void launch_sweep(const Operands& o, bool l2, bool masked, int nq, int n_rows, int d, int w,
                  int groups, int mcols, float* v1, int* i1, float* v2, int* i2,
                  cudaStream_t st) {
  const dim3 grid((nq + QT - 1) / QT, S / LT, groups);
  if (l2) {
    if (masked)
      flat_sweep_kernel<true, true, P, FOLD><<<grid, THREADS, 0, st>>>(
          o, nq, n_rows, d, w, mcols, v1, i1, v2, i2);
    else
      flat_sweep_kernel<true, false, P, FOLD><<<grid, THREADS, 0, st>>>(
          o, nq, n_rows, d, w, mcols, v1, i1, v2, i2);
  } else {
    if (masked)
      flat_sweep_kernel<false, true, P, FOLD><<<grid, THREADS, 0, st>>>(
          o, nq, n_rows, d, w, mcols, v1, i1, v2, i2);
    else
      flat_sweep_kernel<false, false, P, FOLD><<<grid, THREADS, 0, st>>>(
          o, nq, n_rows, d, w, mcols, v1, i1, v2, i2);
  }
}

}  // namespace

// precision: 0 'highest' (q, x f32), 1 'int8', 2 'int8x1' (q, x: int8
// codes; d % 4 == 0 and 4-byte aligned rows, checked by the wrapper).
VITORCH_API int vitorch_flat_sweep_topk_plane(
    const void* q, const void* qr8, const void* sq, const void* x, const void* r8,
    const void* scales, const void* norms, const void* mask, int nq, int n_rows, int d, int w,
    int c_groups, int mcols, int is_l2, int precision, void* v1, void* i1, void* v2, void* i2,
    void* stream) {
  if (nq > 0) {
    Operands o{static_cast<const float*>(q), static_cast<const int*>(q),
               static_cast<const int*>(qr8), static_cast<const float*>(sq),
               static_cast<const float*>(x), static_cast<const int*>(x),
               static_cast<const int*>(r8), static_cast<const float*>(scales),
               static_cast<const float*>(norms), static_cast<const uint8_t*>(mask)};
    auto v1p = static_cast<float*>(v1);
    auto i1p = static_cast<int*>(i1);
    auto v2p = static_cast<float*>(v2);
    auto i2p = static_cast<int*>(i2);
    auto st = static_cast<cudaStream_t>(stream);
    const bool masked = mask != nullptr;
    if (precision == P_INT8)
      launch_sweep<P_INT8, true>(o, is_l2, masked, nq, n_rows, d, w, c_groups, mcols, v1p, i1p,
                                 v2p, i2p, st);
    else if (precision == P_INT8X1)
      launch_sweep<P_INT8X1, true>(o, is_l2, masked, nq, n_rows, d, w, c_groups, mcols, v1p,
                                   i1p, v2p, i2p, st);
    else
      launch_sweep<P_F32, true>(o, is_l2, masked, nq, n_rows, d, w, c_groups, mcols, v1p, i1p,
                                v2p, i2p, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// K7: vals / rows are (nq, nj * 128).
VITORCH_API int vitorch_flat_sweep_minreduce(const void* q, const void* x, const void* norms,
                                             const void* mask, int nq, int n_rows, int d, int w,
                                             int mcols, int is_l2, void* vals, void* rows,
                                             void* stream) {
  const int nj = (n_rows + S * w - 1) / (S * w);
  if (nq > 0 && nj > 0) {
    Operands o{static_cast<const float*>(q), nullptr, nullptr, nullptr,
               static_cast<const float*>(x), nullptr, nullptr, nullptr,
               static_cast<const float*>(norms), static_cast<const uint8_t*>(mask)};
    launch_sweep<P_F32, false>(o, is_l2, mask != nullptr, nq, n_rows, d, w,
                               nj < 65535 ? nj : 65535, mcols, static_cast<float*>(vals),
                               static_cast<int*>(rows), nullptr, nullptr,
                               static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}
