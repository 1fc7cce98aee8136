// K1 - fused nearest-centroid assignment on the TF32 tensor cores.
//
// Replaces vector_indexer_tpu/ops/pallas/assign.py:_kernel (reached through
// assign_argmin_pallas -> _assign_call, the pallas_call at :80). For every
// point x it returns argmin_c (|c|^2 - 2 x.c) and that minimum score; the
// Python wrapper adds |x|^2 back and clamps at 0. The (n, k) score matrix
// never reaches device memory. The lowest centroid id wins a tie, as
// jnp.argmin and the TPU kernel's tile fold do.
//
// Precision: the reference ranks at Precision.HIGHEST (a bf16 cross term
// flipped 8.9% of its argmins), so the cross term is 3xTF32, as in K3's f32
// mode (flat_sweep.cu): each operand is split as a = big + small, big =
// tf32(a), small = tf32(a - big), both rounded to nearest by cvt.rna, and
// x.c = big.big + big.small + small.big with f32 accumulation on the tensor
// cores. An accumulator chains at most PROMOTE = 4 K chunks (128 dims); the
// partial sums are added in round-to-nearest f32. Per pair the cross term
// then errs by at most (3 * 2^-22 + 48 * 2^-23 + (d / 128) * 2^-24) *
// sum_i |x_i||c_i| (the bound flat_sweep.cu states), so the score
// |c|^2 - 2 x.c errs by at most ~1.3e-5 |x||c| <= 0.65e-5 (|x|^2 + |c|^2):
// inside 1e-5 (|x|^2 + |c|^2), the tolerance the plain version is held to,
// and a label can differ from the exact f32 argmin only where two
// centroids' exact scores are that close (a near-tie).
//
// Design (Hopper). One block owns a tile of 128 points; each of its two
// consumer warpgroups owns 64 of them, the wgmma M. The points are the A
// operand and the centroids the B operand, both K-major as stored. The
// centroids are split once per call, by a small kernel, into two (k, d)
// arrays of scratch (big, small: 4 MB at k 4,000, d 128), which stay in L2
// for every block; a producer thread streams them by TMA in 64-centroid x
// 32-dim panels (big and small, 16 KB a stage) through an mbarrier ring, so
// the consumers only wait and issue (m64n64k8 tf32, three products per k8
// step). The point tile is loaded once by TMA and split once, in place
// (big) and into a second buffer (small), where it fits beside a ring of at
// least X_MIN_STAGES stages (d <= 160); at a larger d each stage also
// carries the tile's raw panel of its K chunk, which each warpgroup splits
// on arrival into a small-part buffer (the table split of K3's f32 mode).
// Epilogue per 64-centroid tile: s = c_sq[j] - 2 acc for each accumulator
// element (c_sq read once per tile; centroids past k score +inf), folded
// into a running (min, argmin) per point in registers with strict '<' over
// ascending ids; at the end the four threads that share a fragment row
// reduce it (smaller score wins, the lower id breaks a tie). Rows past n
// are not stored.
//
// Bound on the H100: operations, three TF32 products at 495 TFLOP/s:
// 3 * 2 n k d = 0.41 ms at 65,536 x 4,000 x 128 and 6.2 ms at the build's
// final assignment (1M x 4,000 x 128); the bytes (x read once, 512 MB at
// 1M) take 0.15 ms. The wrapper pads d to a multiple of 4 with zeros (TMA
// needs 16-byte row strides).
#include "hopper.cuh"

namespace {

using vitorch::fence_regs;
using vitorch::gmma_desc;
using vitorch::make_panel_map;
using vitorch::split_tf32;
using vitorch::tma_load_2d;
using vitorch::wgmma_commit;
using vitorch::wgmma_fence;
using vitorch::wgmma_tf32;
using vitorch::wgmma_wait;

constexpr int SPAN = vitorch::GMMA_SPAN;
constexpr int NACC = vitorch::GMMA_NACC;
constexpr int WG_THREADS = 128;
constexpr int CONSUMER_WGS = 2;
constexpr int WG_M = 64;                       // points per consumer warpgroup (the wgmma M)
constexpr int BM = CONSUMER_WGS * WG_M;        // points per block
constexpr int BN = 64;                         // centroids per tile (the wgmma N)
static_assert(NACC == WG_M * BN / WG_THREADS, "one m64n64 product per warpgroup");
// + a producer warpgroup, of which one thread issues the copies; its
// registers go to the consumers (setmaxnreg), as in K3.
constexpr int THREADS = (CONSUMER_WGS + 1) * WG_THREADS;
constexpr int PRODUCER_WARP = CONSUMER_WGS * WG_THREADS / 32;
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 224;
constexpr int X_PANEL = BM * SPAN;             // 16 KB: one K panel of the point tile
constexpr int WG_X = WG_M * SPAN;              // 8 KB: a warpgroup's half of it
constexpr int C_PANEL = BN * SPAN;             // 8 KB: one K panel of a centroid tile
constexpr int XS_BUFS = 2;                     // streamed: small-part buffers per warpgroup
constexpr int MAX_STAGES = 8;
constexpr int MIN_STAGES = 2;                  // one chunk held while the next is consumed
constexpr int X_MIN_STAGES = 4;                // a resident point tile must leave this many
constexpr int SMEM_LIMIT = 232448;             // a block's dynamic shared memory on sm_90
constexpr int PROMOTE = 4;                     // K chunks chained in one accumulator

struct Args {
  const float* c_sq;  // (k,) |c|^2
  float* best;        // (n,) min score
  int* idx;           // (n,) its centroid
  int n, k, d;
  // Shared-memory plan (plan_smem): K panels of the point tile, ring
  // stages, bytes per stage.
  int x_panels, stages, stage_bytes;
};

template <bool X_STREAM>
__global__ void __launch_bounds__(THREADS, 1)
    assign_argmin_kernel(const __grid_constant__ CUtensorMap map_x,
                         const __grid_constant__ CUtensorMap map_cb,
                         const __grid_constant__ CUtensorMap map_cs, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int qp = a.x_panels;
  // Resident: the point tile's panels (big parts in place, then the small
  // parts), then the ring. Streamed: the ring (a stage: centroid big panel,
  // small panel, the point tile's raw panel), then the small-part buffers.
  uint8_t* x_big = smem;
  uint8_t* x_small = smem + qp * X_PANEL;
  uint8_t* ring = X_STREAM ? smem : smem + 2 * qp * X_PANEL;
  uint8_t* xs = ring + a.stages * a.stage_bytes;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(xs + (X_STREAM ? XS_BUFS * CONSUMER_WGS * WG_X : 0));
  uint64_t* empty = full + a.stages;
  uint64_t* x_full = empty + a.stages;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int ntiles = (a.k + BN - 1) / BN;
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      vitorch::mbar_init(&full[s], 1);
      vitorch::mbar_init(&empty[s], CONSUMER_WGS);
    }
    vitorch::mbar_init(x_full, 1);
    vitorch::mbar_init_fence();
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  if (warp >= PRODUCER_WARP) {
    // ---- producer: one thread loads the point tile, then streams every
    // centroid tile's K panels --------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == PRODUCER_WARP && lane == 0) {
      if (!X_STREAM) {
        vitorch::mbar_expect_tx(x_full, qp * X_PANEL);
        for (int p = 0; p < qp; ++p) tma_load_2d(x_big + p * X_PANEL, &map_x, p * 32, row0, x_full);
      }
      int n = 0;
      for (int j = 0; j < ntiles; ++j) {
        for (int p = 0; p < qp; ++p, ++n) {
          const int st = n % a.stages;
          uint8_t* stage = ring + st * a.stage_bytes;
          if (n >= a.stages) vitorch::mbar_wait(&empty[st], ((n / a.stages) - 1) & 1);
          vitorch::mbar_expect_tx(&full[st], a.stage_bytes);
          tma_load_2d(stage, &map_cb, p * 32, j * BN, &full[st]);
          tma_load_2d(stage + C_PANEL, &map_cs, p * 32, j * BN, &full[st]);
          if (X_STREAM) tma_load_2d(stage + 2 * C_PANEL, &map_x, p * 32, row0, &full[st]);
        }
      }
    }
    return;
  }

  // ---- consumers: two warpgroups, 64 points each ------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int h = warp / 4;
  const int t = tid % WG_THREADS;
  // Accumulator element i of this thread is (point wr + 8 * ((i >> 1) & 1),
  // centroid cb0 + 8 * (i >> 2) + (i & 1)) of the warpgroup's 64 x 64 tile.
  const int wr = (t / 32) * 16 + (lane >> 2);
  const int cb0 = (lane & 3) * 2;

  if (!X_STREAM) {  // split this warpgroup's rows of the resident tile once
    vitorch::mbar_wait(x_full, 0);
    for (int e = t; e < qp * (WG_X / 16); e += WG_THREADS) {
      const int off = (e / (WG_X / 16)) * X_PANEL + h * WG_X + (e % (WG_X / 16)) * 16;
      float4 big, small;
      split_tf32(*reinterpret_cast<const float4*>(x_big + off), big, small);
      *reinterpret_cast<float4*>(x_big + off) = big;
      *reinterpret_cast<float4*>(x_small + off) = small;
    }
    vitorch::fence_proxy_async();  // the split's stores -> wgmma reads
    vitorch::named_bar_sync(1 + h, WG_THREADS);
  }

  float acc[NACC], sum[NACC];
  float best[2] = {vitorch::inf_f(), vitorch::inf_f()};
  int bidx[2] = {0x7fffffff, 0x7fffffff};
  int n = 0;
  for (int j = 0; j < ntiles; ++j) {
    if (qp > PROMOTE) {
#pragma unroll
      for (int i = 0; i < NACC; ++i) sum[i] = 0.f;
    }
    // One K chunk (32 dims) per iteration, committed as one wgmma group;
    // one group stays in flight while the next chunk is issued, and a
    // chunk's stage is released once its group has completed.
    for (int c = 0; c < qp; ++c, ++n) {
      const int st = n % a.stages;
      vitorch::mbar_wait(&full[st], (n / a.stages) & 1);
      uint8_t* stage = ring + st * a.stage_bytes;
      uint32_t xa, xsm;
      if constexpr (X_STREAM) {
        // Split this warpgroup's half of the point panel in place (big) and
        // into a small-part buffer; that buffer's previous chunk (XS_BUFS
        // back) is complete, as at most one group is in flight.
        uint8_t* xp = stage + 2 * C_PANEL + h * WG_X;
        uint8_t* xsb = xs + ((c % XS_BUFS) * CONSUMER_WGS + h) * WG_X;
        for (int e = t; e < WG_X / 16; e += WG_THREADS) {
          float4 big, small;
          split_tf32(reinterpret_cast<const float4*>(xp)[e], big, small);
          reinterpret_cast<float4*>(xp)[e] = big;
          reinterpret_cast<float4*>(xsb)[e] = small;
        }
        vitorch::fence_proxy_async();
        vitorch::named_bar_sync(1 + h, WG_THREADS);
        xa = vitorch::smem_u32(xp);
        xsm = vitorch::smem_u32(xsb);
      } else {
        xa = vitorch::smem_u32(x_big + c * X_PANEL + h * WG_X);
        xsm = vitorch::smem_u32(x_small + c * X_PANEL + h * WG_X);
      }
      const uint32_t cbig = vitorch::smem_u32(stage);
      const uint32_t csml = vitorch::smem_u32(stage + C_PANEL);
      fence_regs(acc);
      wgmma_fence();
      const bool fresh = c % PROMOTE == 0;  // this chunk starts a partial sum
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_tf32(acc, gmma_desc(xa + kk * 32), gmma_desc(csml + kk * 32), !fresh || kk > 0);
        wgmma_tf32(acc, gmma_desc(xsm + kk * 32), gmma_desc(cbig + kk * 32), 1);
        wgmma_tf32(acc, gmma_desc(xa + kk * 32), gmma_desc(cbig + kk * 32), 1);
      }
      wgmma_commit();
      if ((c + 1) % PROMOTE == 0 && c + 1 < qp) {  // promote the partial sum
        wgmma_wait<0>();
        fence_regs(acc);
#pragma unroll
        for (int i = 0; i < NACC; ++i) sum[i] += acc[i];
      } else {
        wgmma_wait<1>();
        fence_regs(acc);
      }
      if (c > 0 && t == 0) vitorch::mbar_arrive(&empty[(n - 1) % a.stages]);  // previous chunk
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (t == 0) vitorch::mbar_arrive(&empty[(n - 1) % a.stages]);  // the tile's last chunk
    if (qp > PROMOTE) {
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] += sum[i];
    }
    // Scores and the running (min, argmin): this thread's centroids of the
    // tile are col0 + 8 m + b (m < 8, b < 2), ascending with i for a row.
    const int col0 = j * BN + cb0;
    float cn[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int col = col0 + 8 * (e >> 1) + (e & 1);
      cn[e] = col < a.k ? __ldg(a.c_sq + col) : vitorch::inf_f();
    }
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int e = 2 * (i >> 2) + (i & 1);
      const float s = fmaf(-2.f, acc[i], cn[e]);  // |c|^2 - 2 x.c (2 acc is exact)
      const int r = (i >> 1) & 1;
      if (s < best[r]) {
        best[r] = s;
        bidx[r] = col0 + 8 * (i >> 2) + (i & 1);
      }
    }
  }

  // The four threads of a fragment row (lanes 4m .. 4m + 3) hold disjoint
  // columns: smaller score wins, the lower id breaks a tie.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float s = best[r];
    int bi = bidx[r];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, s, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (os < s || (os == s && oi < bi)) {
        s = os;
        bi = oi;
      }
    }
    const int row = row0 + h * WG_M + wr + 8 * r;
    if ((lane & 3) == 0 && row < a.n) {
      a.best[row] = s;
      a.idx[row] = bi;
    }
  }
}

template <bool X_STREAM>
cudaError_t launch_one(dim3 grid, size_t smem, cudaStream_t st, const CUtensorMap (&maps)[3],
                       const Args& a) {
  auto kern = assign_argmin_kernel<X_STREAM>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<grid, THREADS, smem, st>>>(maps[0], maps[1], maps[2], a);
  return cudaGetLastError();
}

// Shared-memory plan: the point tile resident if that leaves X_MIN_STAGES
// ring stages, else streamed through the ring. Fills a's plan fields,
// *bytes and *stream; false when neither fits.
bool plan_smem(Args* a, size_t* bytes, bool* stream) {
  a->x_panels = (a->d * 4 + SPAN - 1) / SPAN;
  for (int s_mode = 0; s_mode < 2; ++s_mode) {
    const size_t fixed = 1024 /* alignment slack */ + 16 /* x_full */ +
                         (s_mode ? static_cast<size_t>(XS_BUFS) * CONSUMER_WGS * WG_X
                                 : 2 * static_cast<size_t>(a->x_panels) * X_PANEL);
    const int stage = 2 * C_PANEL + (s_mode ? X_PANEL : 0);
    int s = 0;
    while (s < MAX_STAGES &&
           fixed + static_cast<size_t>(s + 1) * (stage + 16) <= static_cast<size_t>(SMEM_LIMIT))
      ++s;
    if (s >= (s_mode ? MIN_STAGES : X_MIN_STAGES)) {
      a->stages = s;
      a->stage_bytes = stage;
      *stream = s_mode != 0;
      *bytes = fixed + static_cast<size_t>(s) * (stage + 16);
      return true;
    }
  }
  return false;
}

}  // namespace

// x (n, d) f32, c (k, d) f32 with d % 4 == 0 and 16-byte-aligned bases
// (checked by the wrapper, which pads d); csplit: 2 * k * d floats of
// scratch (the centroids' big parts, then their small parts).
VITORCH_API int vitorch_assign_argmin(const void* x, const void* c, const void* c_sq, int n,
                                      int k, int d, void* csplit, void* best_score,
                                      void* best_idx, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (k <= 0 || d <= 0 || d % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const size_t kd = static_cast<size_t>(k) * d;
  float* cbig = static_cast<float*>(csplit);
  float* csml = cbig + kd;
  cudaError_t err = vitorch::split_tf32_rows(c, kd, cbig, csml, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a{static_cast<const float*>(c_sq), static_cast<float*>(best_score),
         static_cast<int*>(best_idx), n, k, d, 0, 0, 0};
  size_t smem = 0;
  bool x_stream = false;
  if (!plan_smem(&a, &smem, &x_stream)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[3];
  if (!make_panel_map(&maps[0], x, true, d, n, BM) || !make_panel_map(&maps[1], cbig, true, d, k, BN) ||
      !make_panel_map(&maps[2], csml, true, d, k, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + BM - 1) / BM);
  err = x_stream ? launch_one<true>(grid, smem, st, maps, a) : launch_one<false>(grid, smem, st, maps, a);
  return static_cast<int>(err);
}
