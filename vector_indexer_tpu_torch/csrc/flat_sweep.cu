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
// that lane with strict '<', the displaced best falling through to second.
// Without FOLD (K7) step j's minima go to columns j * 128 + c of one
// (nq, nj * 128) plane.
//
// Design (Hopper). One block owns a 64-query tile, one group g and one
// split of g's steps; it walks its steps in ascending j, and inside a step
// the w tiles of 128 table rows (tile jj holds lane c at row
// j*NB + jj*128 + c). Per tile the cross term q.x of the 64 x 128 (query,
// lane) pairs comes from the tensor cores (wgmma): two consumer warpgroups
// each compute a 64-query x 64-lane m64n64 product, reading the query tile
// (A) and the table tile (B) from shared memory, both K-major as stored, in
// the 128-byte swizzled layout. A producer thread streams the table tiles in
// 16 KB panels (128 rows x 128 bytes of K) by TMA into a ring of up to 8
// stages (mbarrier full/empty pairs), so the next tiles load while the
// current one is multiplied. The query tile stays resident in shared
// memory for the whole sweep where it leaves room for the ring (f32
// d <= 320, 'int8' d <= 1280, 'int8x1' any d it takes); at a larger d each
// stage also carries the query tile's panels for its K chunk, loaded by
// TMA beside the table panel (they come from L2: the query tile is small).
// Precisions:
//   int8 / int8x1 - s8 x s8 -> s32 wgmma (m64n64k32) on the wrapper's
//     quantized queries (q8, qr8, per-query sq) and the table's codes (x8,
//     r8, per-row sx): am = q8.x8 and, for 'int8', ar = q8.r8 + qr8.x8 (both
//     products accumulate into ar, so q8.r8 + qr8.x8 costs one pass over the
//     two panels). Integer sums are exact in any order, so t = SHIFT*am + ar
//     ('int8') or am ('int8x1') equals the plain version's, and it is
//     dequantized in the reference's order ((float)t * row_mul) * sq with
//     row_mul = sx / SHIFT or sx by two __fmul_rn: bit-equal values.
//   highest (f32) - 3xTF32 (m64n64k8 tf32). Each operand is split on the
//     fly as a = big + small, big = tf32(a), small = tf32(a - big) (both
//     rounded to nearest by cvt.rna): the queries once per launch, by a
//     small kernel, into two (nq, d) arrays of scratch; each table panel in
//     place after it arrives (small goes to an 8 KB buffer per
//     warpgroup), so the table is stored once, in f32. The cross
//     term is big.big + big.small + small.big with f32 accumulation. Error
//     bound per dimension i: |a - big - small| <= 2^-22 |a| for each operand
//     and |small.small| <= 2^-22 |q_i||x_i|, so the split adds at most
//     ~3 * 2^-22 ~= 2^-20.4 * sum_i |q_i||x_i| (about 2^-21 in practice) to
//     the accumulation error. The tensor cores' f32 accumulation does not
//     round to nearest: its error grows with every k-step chained into one
//     accumulator, up to 2^-23 of the running sum per step (measured on the
//     H100 as an error growing with d). So one accumulator chains at most
//     PROMOTE = 4 K chunks (128 dims, 48 k8 products), and these partial
//     sums are added in round-to-nearest f32: together <= (48 * 2^-23 +
//     (d / 128) * 2^-24) * sum_i |q_i||x_i| in the worst case, and far less
//     in practice, as the error's signs vary. The distance takes 2 q.x, so
//     its error stays inside 1e-5 * (|x|^2 + 2|q||x|), the tolerance the
//     plain version is held to (sum_i |q_i||x_i| <= |q||x|).
// Selection epilogue: the window min over jj and the fold are elementwise
// per (query, lane), so each thread works on its own accumulator elements
// (2 queries x 16 lanes of its warpgroup's fragment), with the window state
// (value, jj) in registers. The (best, second) pairs, 64 x 128 x 16 B per
// block, do not fit beside the accumulators, so they live in the block's
// slice of the split planes in device memory (L2-resident), read and
// written once per step that has a live tile. A second small kernel merges
// the splits' planes in ascending split order: the fold keeps the two
// smallest values of its sequence under the order (value, position), and
// every split's positions precede the next split's, so the merge equals
// the sequential fold (values and rows).
// Masked mode skips a tile, and does not load it, when no query of the
// block's tile probes any of its 16 8-row blocks: the wrapper ORs the mask
// over each 64-query tile into one byte per (query tile, 8-row block). The
// dense program orders its queries by nearest probe, so a tile's queries
// share probes and most tiles are skipped.
// Grid: (query tiles, C, splits), with splits chosen by the wrapper so the
// grid is >= 2 waves of one block per SM.
//
// Bound on the H100: operations when unmasked (2 nq n d, on the TF32
// tensor cores three times over for f32: 495 TFLOP/s; s8 at 1,979 TOP/s,
// three products for 'int8'); in masked mode the probed rows' bytes or
// operations, whichever is larger, counted for the probed pairs only.
#include "hopper.cuh"

namespace {

using vitorch::fence_regs;
using vitorch::gmma_desc;
using vitorch::make_panel_map;
using vitorch::split_tf32;
using vitorch::swizzled;
using vitorch::tma_load_2d;
using vitorch::wgmma_commit;
using vitorch::wgmma_fence;
using vitorch::wgmma_s8;
using vitorch::wgmma_tf32;
using vitorch::wgmma_wait;

constexpr int S = 128;                 // lanes per grid step = rows per tile
constexpr int QT = 64;                 // queries per block (the wgmma M)
constexpr int CONSUMER_WGS = 2;        // consumer warpgroups per block
constexpr int WG_THREADS = 128;
constexpr int N_WG = S / CONSUMER_WGS;  // 64 lanes per consumer warpgroup (the wgmma N)
// + a producer warpgroup, of which one thread issues the copies. Its
// registers go to the consumers (setmaxnreg): 128 x 56 + 256 x 224 of the
// SM's 65,536.
constexpr int THREADS = (CONSUMER_WGS + 1) * WG_THREADS;
constexpr int PRODUCER_WARP = CONSUMER_WGS * WG_THREADS / 32;
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 224;
constexpr int SPAN = vitorch::GMMA_SPAN;    // bytes of K per panel (the 128B swizzle span)
constexpr int TILE_PANEL = S * SPAN;       // 16 KB: one K panel of a 128-row table tile
constexpr int Q_PANEL = QT * SPAN;         // 8 KB: one K panel of the query tile
constexpr int WG_PANEL = N_WG * SPAN;      // 8 KB: a warpgroup's half of a table panel
constexpr int NACC = vitorch::GMMA_NACC;   // 32 accumulator elements per thread
static_assert(NACC == QT * N_WG / WG_THREADS, "one m64n64 product per consumer warpgroup");
constexpr int MASK_ALIGN = 8;              // rows per mask element
constexpr int SHIFT = 64;                  // int8 residual scale = main scale / SHIFT
constexpr int MAX_STAGES = 8;
constexpr int XS_BUFS = 2;  // f32: small-part buffers per warpgroup (one group in flight)
constexpr int SMEM_LIMIT = 232448;  // a block's dynamic shared memory on sm_90
constexpr int MERGE_THREADS = 256;
// f32: K chunks (of 32 dims) chained in one tensor-core accumulator before
// the partial sum is added to the tile's sum in round-to-nearest f32.
constexpr int PROMOTE = 4;

enum Prec { P_F32 = 0, P_INT8 = 1, P_INT8X1 = 2 };

struct Args {
  const uint8_t* qa;       // (nq, d) query big parts (f32) or codes q8 (int8 modes)
  const uint8_t* qb;       // (nq, d) query small parts (f32) or residual codes qr8 ('int8')
  const float* sq;         // (nq,) query scales (int8 modes)
  const float* scales;     // (n_rows,) row scales (int8 modes)
  const float* norms;      // (n_rows,) f32 |x|^2; SENTINEL on gap/tail rows
  const uint8_t* mask;     // (nq, mcols) 8-row block mask, or null
  const uint8_t* tile_any; // (query tiles, tcols) mask OR-ed over each tile
  float* v1;               // FOLD: (splits, nq, C*128) planes; K7: (nq, nj*128) values
  int* i1;                 // same shape: rows
  float* v2;
  int* i2;
  int nq, n_rows, d, w, n_groups, n_splits, mcols, tcols;
  // Shared-memory plan (plan_smem): K panels of the query tile and of a
  // table tile, ring stages, bytes per stage, whether the query tile
  // streams through the ring instead of staying resident.
  int q_panels, panels, stages, stage_bytes, q_stream;
};

// Whether the block's query tile has work in the 128-row tile at row0.
template <bool MASKED>
__device__ __forceinline__ bool tile_live(const Args& a, int qt, int row0) {
  if (row0 >= a.n_rows) return false;
  if (!MASKED) return true;
  const uint4 v =
      *reinterpret_cast<const uint4*>(a.tile_any + static_cast<size_t>(qt) * a.tcols + row0 / 8);
  return (v.x | v.y | v.z | v.w) != 0u;
}

template <bool L2, bool MASKED, int P, bool FOLD>
__global__ void __launch_bounds__(THREADS, 1)
    flat_sweep_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_r,
                      const __grid_constant__ CUtensorMap map_qa,
                      const __grid_constant__ CUtensorMap map_qb, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  constexpr bool TWO_Q = P != P_INT8X1;  // f32: big + small; 'int8': q8 + qr8
  // Resident query tile: its qa panels, then its qb panels. Streamed: a
  // stage holds a table panel and, after it, the query panel(s) of the
  // same K chunk (f32: big and small; 'int8': q8 beside x8, qr8 beside r8).
  uint8_t* q_a = smem;                              // query big part, or q8
  uint8_t* q_b = smem + a.q_panels * Q_PANEL;       // query small part, or qr8
  uint8_t* ring = smem + (a.q_stream ? 0 : (TWO_Q ? 2 : 1) * a.q_panels * Q_PANEL);
  uint8_t* xs = ring + a.stages * a.stage_bytes;    // f32: per-warpgroup small parts
  constexpr int PPC = P == P_INT8 ? 2 : 1;          // table panels per K chunk
  uint64_t* full =
      reinterpret_cast<uint64_t*>(xs + (P == P_F32 ? XS_BUFS * CONSUMER_WGS * WG_PANEL : 0));
  uint64_t* empty = full + a.stages;

  const int tid = threadIdx.x;
  const int qt = blockIdx.x, g = blockIdx.y, split = blockIdx.z;
  const int q0 = qt * QT;
  const int NB = S * a.w;
  const int nj = (a.n_rows + NB - 1) / NB;
  const int C = a.n_groups;
  const int ng = g < nj ? (nj - g + C - 1) / C : 0;  // steps of group g
  const int m0 = static_cast<int>(static_cast<long long>(ng) * split / a.n_splits);
  const int m1 = static_cast<int>(static_cast<long long>(ng) * (split + 1) / a.n_splits);

  // A resident query tile is staged once, in the swizzled layout; columns
  // past d and rows past nq are zeros.
  const int kc_row = a.q_panels * 8;               // 16-byte chunks per staged row
  const int kc_in = a.d * (P == P_F32 ? 4 : 1) / 16;  // ... of them inside the row
  for (int e = a.q_stream ? QT * kc_row : tid; e < QT * kc_row; e += THREADS) {
    const int r = e / kc_row, kc = e % kc_row;
    const bool in = q0 + r < a.nq && kc < kc_in;
    const size_t src = static_cast<size_t>(q0 + r) * kc_in + kc;
    const int off = swizzled(r, kc, Q_PANEL);
    *reinterpret_cast<int4*>(q_a + off) =
        in ? reinterpret_cast<const int4*>(a.qa)[src] : make_int4(0, 0, 0, 0);
    if constexpr (TWO_Q)
      *reinterpret_cast<int4*>(q_b + off) =
          in ? reinterpret_cast<const int4*>(a.qb)[src] : make_int4(0, 0, 0, 0);
  }
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      vitorch::mbar_init(&full[s], 1);
      vitorch::mbar_init(&empty[s], CONSUMER_WGS);
    }
    vitorch::mbar_init_fence();
  }
  vitorch::fence_proxy_async();  // the query tile's stores -> wgmma reads
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  if (warp >= PRODUCER_WARP) {
    // ---- producer: one thread streams the live tiles' panels ----------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == PRODUCER_WARP && lane == 0) {
      int n = 0;
      for (int m = m0; m < m1; ++m) {
        const int j = g + m * C;
        for (int jj = 0; jj < a.w; ++jj) {
          const int row0 = j * NB + jj * S;
          if (!tile_live<MASKED>(a, qt, row0)) continue;
          for (int p = 0; p < a.panels; ++p, ++n) {
            const int st = n % a.stages;
            uint8_t* stage = ring + st * a.stage_bytes;
            if (n >= a.stages) vitorch::mbar_wait(&empty[st], ((n / a.stages) - 1) & 1);
            vitorch::mbar_expect_tx(&full[st], a.q_stream ? a.stage_bytes : TILE_PANEL);
            // 'int8' interleaves the x8 and r8 panels of each K chunk.
            const bool resid = P == P_INT8 && (p & 1);
            const int kcol = P == P_F32 ? p * 32 : (P == P_INT8 ? (p >> 1) : p) * 128;
            tma_load_2d(stage, resid ? &map_r : &map_x, kcol, row0, &full[st]);
            if (a.q_stream) {  // the query tile's panel(s) of this K chunk
              tma_load_2d(stage + TILE_PANEL, resid ? &map_qb : &map_qa, kcol, q0, &full[st]);
              if (P == P_F32) tma_load_2d(stage + TILE_PANEL + Q_PANEL, &map_qb, kcol, q0, &full[st]);
            }
          }
        }
      }
    }
    return;
  }

  // ---- consumers: two warpgroups, 64 lanes each -------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int h = warp / 4;
  const int t = tid % WG_THREADS;
  // Accumulator element i of this thread is (query row wq + 8 * ((i >> 1) & 1),
  // lane lbase + 8 * (i >> 2) + (i & 1)) of the block's tile.
  const int wq = (t / 32) * 16 + (lane >> 2);
  const int lbase = h * N_WG + (lane & 3) * 2;
  uint8_t* xs_wg = xs + h * WG_PANEL;
  const size_t cs = static_cast<size_t>(C) * S;
  float sqv[2] = {0.f, 0.f};  // int8 modes: the scales of this thread's two query rows
  if (P != P_F32) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (q0 + wq + 8 * r < a.nq) sqv[r] = __ldg(a.sq + q0 + wq + 8 * r);
  }

  if constexpr (FOLD) {  // this thread's entries of its split's planes start empty
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int qi = q0 + wq + ((i >> 1) & 1) * 8;
      if (qi >= a.nq) continue;
      const size_t oi = (static_cast<size_t>(split) * a.nq + qi) * cs +
                        static_cast<size_t>(g) * S + lbase + (i >> 2) * 8 + (i & 1);
      a.v1[oi] = vitorch::inf_f();
      a.i1[oi] = -1;
      a.v2[oi] = vitorch::inf_f();
      a.i2[oi] = -1;
    }
  }

  float accf[NACC];
  float sumf[NACC];  // f32: the tile's promoted partial sums
  int am[NACC], ar[NACC];
  float wv[NACC];        // window minimum per element
  uint32_t wj[NACC / 4];  // its jj (< w <= 255), one byte per element
  int n = 0;
  for (int m = m0; m < m1; ++m) {
    const int j = g + m * C;
#pragma unroll
    for (int i = 0; i < NACC; ++i) wv[i] = vitorch::inf_f();
#pragma unroll
    for (int i = 0; i < NACC / 4; ++i) wj[i] = 0u;
    bool any = false;
    for (int jj = 0; jj < a.w; ++jj) {
      const int row0 = j * NB + jj * S;
      if (!tile_live<MASKED>(a, qt, row0)) continue;
      any = true;
      if constexpr (P == P_F32) {
#pragma unroll
        for (int i = 0; i < NACC; ++i) sumf[i] = 0.f;
      }
      // One K chunk per iteration ('int8': its x8 and r8 panels), its
      // products committed as one wgmma group. One group stays in flight
      // while the next chunk is prepared and issued; a chunk's stages are
      // released once its group has completed.
      for (int c = 0; c < a.q_panels; ++c, n += PPC) {
        const int st = n % a.stages;
        vitorch::mbar_wait(&full[st], (n / a.stages) & 1);
        if (PPC == 2) vitorch::mbar_wait(&full[(n + 1) % a.stages], ((n + 1) / a.stages) & 1);
        uint8_t* stage = ring + st * a.stage_bytes;
        uint8_t* tile = stage + h * WG_PANEL;  // this warpgroup's 64 rows
        const uint32_t ta = vitorch::smem_u32(tile);
        // The query panels of this chunk: q big part / q8, and (f32) the
        // small part.
        const uint8_t* qpa = a.q_stream ? stage + TILE_PANEL : q_a + c * Q_PANEL;
        if constexpr (P == P_F32) {
          // Split this warpgroup's half of the panel in place (big) and
          // into a small-part buffer; the swizzled positions are the same.
          // The buffer's previous chunk (n - XS_BUFS panels back) is
          // complete: at most one group is in flight.
          uint8_t* xsb = xs_wg + (c % XS_BUFS) * (CONSUMER_WGS * WG_PANEL);
          for (int e = t; e < WG_PANEL / 16; e += WG_THREADS) {
            float4 big, small;
            split_tf32(reinterpret_cast<const float4*>(tile)[e], big, small);
            reinterpret_cast<float4*>(tile)[e] = big;
            reinterpret_cast<float4*>(xsb)[e] = small;
          }
          vitorch::fence_proxy_async();
          vitorch::named_bar_sync(1 + h, WG_THREADS);
          fence_regs(accf);
          wgmma_fence();
          const uint32_t qa = vitorch::smem_u32(qpa);
          const uint32_t qs = vitorch::smem_u32(a.q_stream ? qpa + Q_PANEL : q_b + c * Q_PANEL);
          const uint32_t xa = vitorch::smem_u32(xsb);
          const bool fresh = c % PROMOTE == 0;  // this chunk starts a partial sum
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_tf32(accf, gmma_desc(qa + kk * 32), gmma_desc(xa + kk * 32), !fresh || kk > 0);
            wgmma_tf32(accf, gmma_desc(qs + kk * 32), gmma_desc(ta + kk * 32), 1);
            wgmma_tf32(accf, gmma_desc(qa + kk * 32), gmma_desc(ta + kk * 32), 1);
          }
          wgmma_commit();
          if ((c + 1) % PROMOTE == 0 && c + 1 < a.q_panels) {  // promote the partial sum
            wgmma_wait<0>();
            fence_regs(accf);
#pragma unroll
            for (int i = 0; i < NACC; ++i) sumf[i] += accf[i];
          } else {
            wgmma_wait<1>();
            fence_regs(accf);
          }
        } else {
          fence_regs(am);
          if (P == P_INT8) fence_regs(ar);
          wgmma_fence();
          const uint32_t q8a = vitorch::smem_u32(qpa);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)  // am (+)= q8 . x8
            wgmma_s8(am, gmma_desc(q8a + kk * 32), gmma_desc(ta + kk * 32), c > 0 || kk > 0);
          if constexpr (P == P_INT8) {  // ar (+)= qr8 . x8 + q8 . r8
            const uint8_t* rstage = ring + ((n + 1) % a.stages) * a.stage_bytes;  // r8 (+ qr8)
            const uint32_t qr =
                vitorch::smem_u32(a.q_stream ? rstage + TILE_PANEL : q_b + c * Q_PANEL);
            const uint32_t ra = vitorch::smem_u32(rstage + h * WG_PANEL);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              wgmma_s8(ar, gmma_desc(qr + kk * 32), gmma_desc(ta + kk * 32), c > 0 || kk > 0);
              wgmma_s8(ar, gmma_desc(q8a + kk * 32), gmma_desc(ra + kk * 32), 1);
            }
          }
          wgmma_commit();
          wgmma_wait<1>();
          fence_regs(am);
          if (P == P_INT8) fence_regs(ar);
        }
        if (c > 0 && t == 0)  // the previous chunk's group is complete
          for (int k = 0; k < PPC; ++k) vitorch::mbar_arrive(&empty[(n - PPC + k) % a.stages]);
      }
      wgmma_wait<0>();
      if constexpr (P == P_F32) {
        fence_regs(accf);
        if (a.q_panels > PROMOTE) {
#pragma unroll
          for (int i = 0; i < NACC; ++i) accf[i] += sumf[i];
        }
      } else {
        fence_regs(am);
        if constexpr (P == P_INT8) {  // t = SHIFT * q8.x8 + (q8.r8 + qr8.x8), exact in int32
          fence_regs(ar);
#pragma unroll
          for (int i = 0; i < NACC; ++i) am[i] = am[i] * SHIFT + ar[i];
        }
      }
      if (t == 0)  // the tile's last chunk
        for (int k = 0; k < PPC; ++k) vitorch::mbar_arrive(&empty[(n - PPC + k) % a.stages]);
      // Distances and the strided window min (lower jj wins a tie). Element
      // i is lane lbase + 8 * (i >> 2) + (i & 1) of query row wq + 8 * ((i >> 1)
      // & 1); its mask block is blk0 + (i >> 2). The tile's norms, int8 row
      // scales and mask bytes are loaded up front, in 8-byte words where the
      // tile lies inside the table, so that their latencies overlap.
      const bool inside = row0 + S <= a.n_rows;
      uint2 mk[2] = {make_uint2(0u, 0u), make_uint2(0u, 0u)};  // 8 mask bytes per query row
      if (MASKED) {
        const int blk0 = (row0 + h * N_WG) / MASK_ALIGN;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qi = q0 + wq + 8 * r;
          if (qi < a.nq)
            mk[r] = *reinterpret_cast<const uint2*>(a.mask + static_cast<size_t>(qi) * a.mcols + blk0);
        }
      }
      // PART elements at a time (PART / 4 lane pairs), as registers allow.
      constexpr int PART = 16;
#pragma unroll
      for (int part = 0; part < NACC / PART; ++part) {
        float nrm[PART / 2], rmul[PART / 2];  // lanes lbase + 8 * (PART / 4 * part + k / 2) + (k & 1)
#pragma unroll
        for (int k = 0; k < PART / 2; k += 2) {
          const int row = row0 + lbase + 8 * (PART / 4 * part + k / 2);
          if (inside) {
            const float2 v = __ldg(reinterpret_cast<const float2*>(a.norms + row));
            nrm[k] = v.x;
            nrm[k + 1] = v.y;
            if (P != P_F32) {
              const float2 sc = __ldg(reinterpret_cast<const float2*>(a.scales + row));
              rmul[k] = sc.x;
              rmul[k + 1] = sc.y;
            }
          } else {
#pragma unroll
            for (int b = 0; b < 2; ++b) {
              nrm[k + b] = row + b < a.n_rows ? __ldg(a.norms + row + b) : 0.f;
              if (P != P_F32) rmul[k + b] = row + b < a.n_rows ? __ldg(a.scales + row + b) : 0.f;
            }
          }
        }
#pragma unroll
        for (int i = PART * part; i < PART * part + PART; ++i) {
          const int k = 2 * ((i >> 2) - PART / 4 * part) + (i & 1);
          float cross;
          if constexpr (P == P_F32) {
            cross = accf[i];
          } else {
            float row_mul = rmul[k];
            if (P == P_INT8) row_mul *= (1.f / SHIFT);  // exact: a power of two
            cross = __fmul_rn(__fmul_rn(__int2float_rn(am[i]), row_mul), sqv[(i >> 1) & 1]);
          }
          float dist =
              L2 ? nrm[k] - 2.f * cross : (nrm[k] >= VITORCH_SENTINEL ? nrm[k] : 0.f) - cross;
          if (!inside && row0 + lbase + (i >> 2) * 8 + (i & 1) >= a.n_rows) dist = vitorch::inf_f();
          if (MASKED) {
            const uint2 m = mk[(i >> 1) & 1];
            const int bb = i >> 2;  // mask byte of this element (the rows' qi >= nq read 0)
            if ((((bb < 4 ? m.x : m.y) >> (8 * (bb & 3))) & 0xffu) == 0u) dist = vitorch::inf_f();
          }
          if (dist < wv[i]) {
            wv[i] = dist;
            wj[i >> 2] = (wj[i >> 2] & ~(0xffu << (8 * (i & 3)))) |
                         (static_cast<uint32_t>(jj) << (8 * (i & 3)));
          }
        }
      }
    }
    if constexpr (!FOLD) {  // K7: write the step's window minima (every step)
      const size_t width = static_cast<size_t>(nj) * S;
#pragma unroll
      for (int i = 0; i < NACC; ++i) {
        const int qi = q0 + wq + ((i >> 1) & 1) * 8;
        if (qi >= a.nq) continue;
        const int ln = lbase + (i >> 2) * 8 + (i & 1);
        const size_t oi = static_cast<size_t>(qi) * width + static_cast<size_t>(j) * S + ln;
        a.v1[oi] = wv[i];
        a.i1[oi] = j * NB + static_cast<int>((wj[i >> 2] >> (8 * (i & 3))) & 0xffu) * S + ln;
      }
    } else if (any) {  // fold the step's window minima into the split's planes
      // Eight elements at a time: their planes' entries are loaded before
      // any is stored, so the loads overlap.
#pragma unroll
      for (int i0 = 0; i0 < NACC; i0 += 8) {
        float b1[8], b2[8];
        int r1[8];
        bool live[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int i = i0 + k;
          const int qi = q0 + wq + ((i >> 1) & 1) * 8;
          live[k] = qi < a.nq && wv[i] < vitorch::inf_f();  // +inf never enters
          const size_t oi = (static_cast<size_t>(split) * a.nq + qi) * cs +
                            static_cast<size_t>(g) * S + lbase + (i >> 2) * 8 + (i & 1);
          b1[k] = live[k] ? a.v1[oi] : 0.f;
          b2[k] = live[k] ? a.v2[oi] : 0.f;
          r1[k] = live[k] ? a.i1[oi] : 0;
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (!live[k]) continue;
          const int i = i0 + k;
          const int qi = q0 + wq + ((i >> 1) & 1) * 8;
          const int ln = lbase + (i >> 2) * 8 + (i & 1);
          const size_t oi = (static_cast<size_t>(split) * a.nq + qi) * cs +
                            static_cast<size_t>(g) * S + ln;
          const float v = wv[i];
          const int r =
              j * NB + static_cast<int>((wj[i >> 2] >> (8 * (i & 3))) & 0xffu) * S + ln;
          if (v < b1[k]) {
            a.v1[oi] = v;
            a.i1[oi] = r;
            if (b1[k] < b2[k]) {  // the displaced best falls through to second
              a.v2[oi] = b1[k];
              a.i2[oi] = r1[k];
            }
          } else if (v < b2[k]) {
            a.v2[oi] = v;
            a.i2[oi] = r;
          }
        }
      }
    }
  }
}

// Merge the splits' (best, second) planes in ascending split order into the
// output planes vals / rows (nq, 2 * cs): best at column c, second at cs + c.
__global__ void __launch_bounds__(MERGE_THREADS)
    merge_top2_kernel(const float* __restrict__ pv1, const int* __restrict__ pi1,
                      const float* __restrict__ pv2, const int* __restrict__ pi2, int splits,
                      int nq, int cs, float* __restrict__ vals, int* __restrict__ rows) {
  const size_t plane = static_cast<size_t>(nq) * cs;
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; e < plane;
       e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float b1 = pv1[e], b2 = pv2[e];
    int r1 = pi1[e], r2 = pi2[e];
    for (int s = 1; s < splits; ++s) {
      const size_t o = s * plane + e;
      const float cand_v[2] = {pv1[o], pv2[o]};
      const int cand_r[2] = {pi1[o], pi2[o]};
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float v = cand_v[c];
        const int r = cand_r[c];
        float lv = v;
        int li = r;
        if (v < b1) {
          lv = b1;
          li = r1;
          b1 = v;
          r1 = r;
        }
        if (lv < b2) {
          b2 = lv;
          r2 = li;
        }
      }
    }
    const size_t q = e / cs, c = e % cs;
    const size_t o = q * 2 * cs + c;
    vals[o] = b1;
    rows[o] = r1;
    vals[o + cs] = b2;
    rows[o + cs] = r2;
  }
}

// ---- host side --------------------------------------------------------------

template <bool L2, bool MASKED, int P, bool FOLD>
cudaError_t launch_one(dim3 grid, size_t smem, cudaStream_t st, const CUtensorMap (&maps)[4],
                       const Args& a) {
  auto kern = flat_sweep_kernel<L2, MASKED, P, FOLD>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<grid, THREADS, smem, st>>>(maps[0], maps[1], maps[2], maps[3], a);
  return cudaGetLastError();
}

// Shared-memory plan: the query tile resident if that leaves room for the
// ring's least stages, else streamed through the ring. Fills a's plan
// fields and *bytes; false when neither fits.
template <int P>
bool plan_smem(Args* a, size_t* bytes) {
  const int esize = P == P_F32 ? 4 : 1;
  a->q_panels = (a->d * esize + SPAN - 1) / SPAN;
  a->panels = P == P_INT8 ? 2 * a->q_panels : a->q_panels;
  // One chunk's panels stay held while the next chunk's are consumed.
  const int min_stages = 2 * (P == P_INT8 ? 2 : 1);
  for (int stream = 0; stream < 2; ++stream) {
    const size_t fixed =
        1024 /* alignment slack */ + (P == P_F32 ? XS_BUFS * CONSUMER_WGS * WG_PANEL : 0) +
        (stream ? 0 : static_cast<size_t>(P == P_INT8X1 ? 1 : 2) * a->q_panels * Q_PANEL);
    // A streamed stage adds its K chunk's query panel(s): f32 big and
    // small; 'int8' q8 (beside x8) or qr8 (beside r8); 'int8x1' q8.
    const int stage = TILE_PANEL + (stream ? (P == P_F32 ? 2 : 1) * Q_PANEL : 0);
    int s = 0;
    while (s < MAX_STAGES &&
           fixed + static_cast<size_t>(s + 1) * (stage + 16) <= static_cast<size_t>(SMEM_LIMIT))
      ++s;
    if (s >= min_stages) {
      a->stages = s;
      a->stage_bytes = stage;
      a->q_stream = stream;
      *bytes = fixed + static_cast<size_t>(s) * (stage + 16);
      return true;
    }
  }
  return false;
}

template <int P, bool FOLD>
int launch_sweep(Args a, const void* x, const void* r8, bool l2, bool masked, int splits,
                 cudaStream_t st) {
  size_t smem = 0;
  if (!plan_smem<P>(&a, &smem)) return static_cast<int>(cudaErrorInvalidValue);
  // Table x (x8), table r8, query qa (big part or q8), query qb (small
  // part or qr8); an unused map repeats one that is set.
  CUtensorMap maps[4];
  constexpr bool F = P == P_F32;
  bool ok = make_panel_map(&maps[0], x, F, a.d, a.n_rows, S) &&
            (P != P_INT8 || make_panel_map(&maps[1], r8, false, a.d, a.n_rows, S)) &&
            make_panel_map(&maps[2], a.qa, F, a.d, a.nq, QT) &&
            (P == P_INT8X1 || make_panel_map(&maps[3], a.qb, F, a.d, a.nq, QT));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (P != P_INT8) maps[1] = maps[0];
  if (P == P_INT8X1) maps[3] = maps[2];
  a.n_splits = splits;
  const dim3 grid((a.nq + QT - 1) / QT, a.n_groups, splits);
  cudaError_t err;
  if (l2)
    err = masked ? launch_one<true, true, P, FOLD>(grid, smem, st, maps, a)
                 : launch_one<true, false, P, FOLD>(grid, smem, st, maps, a);
  else
    err = masked ? launch_one<false, true, P, FOLD>(grid, smem, st, maps, a)
                 : launch_one<false, false, P, FOLD>(grid, smem, st, maps, a);
  return static_cast<int>(err);
}

// Split the f32 queries into `qsplit` (big parts, then small parts, each
// nq * d floats) and point a.qa / a.qb at them.
int split_queries(Args* a, const void* q, void* qsplit, cudaStream_t st) {
  const size_t n = static_cast<size_t>(a->nq) * a->d;
  float* big = static_cast<float*>(qsplit);
  a->qa = reinterpret_cast<const uint8_t*>(big);
  a->qb = reinterpret_cast<const uint8_t*>(big + n);
  return static_cast<int>(vitorch::split_tf32_rows(q, n, big, big + n, st));
}

}  // namespace

// precision: 0 'highest' (q, x f32; d % 4 == 0; qsplit: 2 * nq * d floats of
// scratch), 1 'int8', 2 'int8x1' (q, x: int8 codes; d % 16 == 0), checked by
// the wrapper. `part` is scratch for the splits' planes: 4 arrays (v1, i1,
// v2, i2) of splits * nq * C * 128 4-byte elements; vals / rows are the
// (nq, 2 * C * 128) outputs.
VITORCH_API int vitorch_flat_sweep_topk_plane(
    const void* q, const void* qr8, const void* sq, const void* x, const void* r8,
    const void* scales, const void* norms, const void* mask, const void* tile_any, int nq,
    int n_rows, int d, int w, int c_groups, int splits, int mcols, int tcols, int is_l2,
    int precision, void* qsplit, void* part, void* vals, void* rows, void* stream) {
  if (nq <= 0) return static_cast<int>(cudaGetLastError());
  const size_t plane = static_cast<size_t>(splits) * nq * c_groups * S;
  float* pv1 = static_cast<float*>(part);
  int* pi1 = reinterpret_cast<int*>(pv1 + plane);
  float* pv2 = reinterpret_cast<float*>(pi1 + plane);
  int* pi2 = reinterpret_cast<int*>(pv2 + plane);
  Args a{static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(qr8),
         static_cast<const float*>(sq), static_cast<const float*>(scales),
         static_cast<const float*>(norms), static_cast<const uint8_t*>(mask),
         static_cast<const uint8_t*>(tile_any), pv1, pi1, pv2, pi2, nq, n_rows, d, w,
         c_groups, splits, mcols, tcols, 0, 0, 0, 0, 0};
  auto st = static_cast<cudaStream_t>(stream);
  const bool masked = mask != nullptr;
  int rc;
  if (precision == P_INT8) {
    rc = launch_sweep<P_INT8, true>(a, x, r8, is_l2, masked, splits, st);
  } else if (precision == P_INT8X1) {
    rc = launch_sweep<P_INT8X1, true>(a, x, r8, is_l2, masked, splits, st);
  } else {
    rc = split_queries(&a, q, qsplit, st);
    if (rc == 0) rc = launch_sweep<P_F32, true>(a, x, r8, is_l2, masked, splits, st);
  }
  if (rc != 0) return rc;
  const size_t per_split = static_cast<size_t>(nq) * c_groups * S;
  const int blocks = static_cast<int>((per_split + MERGE_THREADS - 1) / MERGE_THREADS);
  merge_top2_kernel<<<blocks < 65535 ? blocks : 65535, MERGE_THREADS, 0, st>>>(
      pv1, pi1, pv2, pi2, splits, nq, c_groups * S, static_cast<float*>(vals),
      static_cast<int*>(rows));
  return static_cast<int>(cudaGetLastError());
}

// K7: vals / rows are (nq, nj * 128); qsplit as above.
VITORCH_API int vitorch_flat_sweep_minreduce(const void* q, const void* x, const void* norms,
                                             const void* mask, const void* tile_any, int nq,
                                             int n_rows, int d, int w, int mcols, int tcols,
                                             int is_l2, void* qsplit, void* vals, void* rows,
                                             void* stream) {
  const int nj = (n_rows + S * w - 1) / (S * w);
  if (nq <= 0 || nj <= 0) return static_cast<int>(cudaGetLastError());
  Args a{nullptr, nullptr, nullptr, nullptr, static_cast<const float*>(norms),
         static_cast<const uint8_t*>(mask), static_cast<const uint8_t*>(tile_any),
         static_cast<float*>(vals), static_cast<int*>(rows), nullptr, nullptr, nq, n_rows, d, w,
         nj < 65535 ? nj : 65535, 1, mcols, tcols, 0, 0, 0, 0, 0};
  auto st = static_cast<cudaStream_t>(stream);
  const int rc = split_queries(&a, q, qsplit, st);
  if (rc != 0) return rc;
  return launch_sweep<P_F32, false>(a, x, nullptr, is_l2, mask != nullptr, 1, st);
}
