// K5 - the block-major shared stream: one stream block scored against the
// up to Q_SHARE = 8 queries that probe it.
//
// Replaces vector_indexer_tpu/ops/pallas/block_stream.py:
// _shared_kernel_factory (reached through block_stream_search_shared ->
// _block_stream_shared_call).
//
// A task is one (block, <= 8 query rows) group built in PyTorch by
// inverting the (query, slot) pairs (ops/block_stream.py::
// build_shared_tasks). Task t scores the `chunk` residual rows r^ of block
// blk[t] against its 8 pre-subtracted query rows qc[t, j] (q - c for l2, q
// for ip) and writes the task-major plane rows plane[t, j, :]:
//     l2:  |r^|^2 - 2 qc.r^              ip:  penalty - q.r^
// (penalty = the stored norm on sentinel pad rows, else 0). The per-pair
// lane-constant bias (|q - c|^2 or -q.c) is added in PyTorch after the
// gather back to query order, as in the reference. Pad rows of a cluster's
// last block are zero with a 1e30 norm, so their lanes stay >= 1e29 and
// never become results; no lane mask is needed. A task with blk[t] < 0 is
// unused (the tasks past the task count sit at the end of the list) and
// writes nothing: no pair reads its rows.
//
// Bound on the H100: bytes. The plane (t_cap * 8 * chunk * 4 B: 119.5 MB at
// t_cap 14,592, chunk 256) must be written and each distinct probed block
// read once; the product (8 queries x chunk rows x d per task, 7.6 GFLOP at
// that shape) would take 0.114 ms on the CUDA cores' f32 peak, more than
// the bf16 table's whole bytes bound, so it runs on the tensor cores:
//
// * The product is mma.sync.m16n8k8 in TF32 with the 8 queries as N = 8 and
//   16 block rows as M. bf16 and int8 rows are exact in TF32; the query
//   rows are split once per load into tf32 big + small parts (hopper.cuh's
//   tf32_rna), so the cross term is two products, row.big + row.small. f32
//   rows (stream_shared_exact) are split too and take three products
//   (3xTF32, as K1 and K3). The partial sums are added into an f32 total
//   every 8 16-byte chunks of a row (64 bf16 / 128 int8 / 32 f32 dims), so
//   the tensor cores' accumulation error does not grow with d. mma.sync
//   (not wgmma) because A is widened from the staged rows in registers:
//   no f32 copy of the rows in shared memory, and N = 8 is one fragment.
// * Each CTA walks a contiguous range of TPC tasks. The range's runs of
//   consecutive tasks with one block ("segments") are scored panel by
//   panel: one cp.async.bulk brings a panel of a block's rows (a contiguous
//   run, at most ~32 KB but at least 16 rows) into a ring of up to three
//   stages completed by mbarriers, the copy of the next panel is issued
//   before the current one is scored, and every task of the segment is
//   scored from the staged panel: a block is read once per segment, not
//   once per task. Queries come from device memory in 16-byte loads (L1
//   and L2 serve the 8 warps' repeated reads).
// * Rows too wide for two 16-row stages in shared memory (f32 d > ~1800,
//   bf16 d > ~3600, int8 d > ~7200) take 8-row panels, then one stage, then
//   4-row panels. A warp's 32-row item then repeats the panel's last row in
//   the rows past it and never writes them: 4-8x the tensor-core work per
//   row, and no copy overlap with one stage, on widths the 16-row ring
//   cannot hold. Rows too wide for four of them in one stage (f32 d past
//   ~14,400, bf16 ~28,900, int8 ~57,800), and those whose 8- and 4-row
//   panels are no 16-byte multiple, take K-panels (KPAN): a stage holds a
//   1 KB segment of each of 32 rows (one bulk copy per row, its 16-byte
//   envelope), the loads walk a row panel's K-panels in order, and each
//   item's accumulators carry over them in shared memory (promoted, as
//   everywhere, every 8 chunks) until the last K-panel's epilogue applies
//   the scale and the norm once. The plan (panel rows, stages, K-panel)
//   comes from the wrapper (ops/block_stream.py::stream_shared_plan) and
//   is checked here; it serves any d.
// * Each thread loads its rows' 16-byte chunks (rows g and g+8 of a tile;
//   chunks t and t + 4 of 8), in an order swapped by row parity so that a
//   quarter warp's 8 loads fall in 8 different bank groups.
// * The plane is written from the accumulator fragments: each store
//   instruction covers 8 consecutive rows of 4 query rows (full 32-byte
//   sectors along `chunk`).
// Rows whose bytes are not a multiple of 16 (bf16 d % 8 != 0, int8
// d % 16 != 0, f32 d % 4 != 0) take an element-wise path with the same
// arithmetic; dims past d read as zeros in registers (d is padded to the
// 16-byte chunk and the 8-chunk group).
#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int QS = 8;           // query rows per task (Q_SHARE in ops/block_stream.py)
constexpr int TPC = 16;         // tasks per CTA
constexpr int ITEM_ROWS = 32;   // rows per warp work item: two m16 tiles
constexpr int MAX_STAGES = 3;
// The ring's share of the 227 KB a block may opt in to (the static arrays
// below take the rest).
constexpr size_t MAX_RING_BYTES = 227 * 1024 - 1024;
// KPAN: the carried accumulators, one item (2 x 4 per lane) per task.
constexpr size_t PART_BYTES = sizeof(float) * TPC * 8 * 32;

template <typename T>
struct RowType;
template <>
struct RowType<__nv_bfloat16> {
  static constexpr int E = 8;  // elements per 16-byte chunk
};
template <>
struct RowType<int8_t> {
  static constexpr int E = 16;
};
template <>
struct RowType<float> {
  static constexpr int E = 4;
};

__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Element e of a 16-byte chunk held as 4 words, widened exactly to f32.
template <typename T>
__device__ __forceinline__ float chunk_elem(const uint4& w, int e);
template <>
__device__ __forceinline__ float chunk_elem<__nv_bfloat16>(const uint4& w, int e) {
  const uint32_t x = (&w.x)[e >> 1];
  return __uint_as_float((e & 1) ? (x & 0xffff0000u) : (x << 16));
}
template <>
__device__ __forceinline__ float chunk_elem<int8_t>(const uint4& w, int e) {
  // 0x4B0000xx is 2^23 + xx; with the byte biased by 128 that is exact.
  const uint32_t x = (&w.x)[e >> 2] ^ 0x80808080u;
  return __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540u | (e & 3))) - 8388736.f;
}
template <>
__device__ __forceinline__ float chunk_elem<float>(const uint4& w, int e) {
  return __uint_as_float((&w.x)[e]);
}

// Chunk c (16 bytes) of a staged row of `row_bytes` bytes; zeros past the
// row. VEC: the row is a multiple of 16 bytes (one aligned load).
template <bool VEC>
__device__ __forceinline__ uint4 load_chunk(const unsigned char* row, int c, int row_bytes) {
  if (VEC) {
    if (c * 16 < row_bytes) return *reinterpret_cast<const uint4*>(row + c * 16);
    return make_uint4(0, 0, 0, 0);
  }
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (c * 16 + b < row_bytes) w[b >> 2] |= static_cast<uint32_t>(row[c * 16 + b]) << (8 * (b & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// E consecutive query values from element k0 on (zeros past d), split into
// tf32 big and small parts.
template <int E, bool VEC>
__device__ __forceinline__ void load_query(const float* __restrict__ qrow, int k0, int d,
                                           uint32_t (&big)[E], uint32_t (&small)[E]) {
  float v[E];
  if (VEC && k0 + E <= d) {
#pragma unroll
    for (int i = 0; i < E; i += 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(qrow + k0 + i));
      v[i] = f.x;
      v[i + 1] = f.y;
      v[i + 2] = f.z;
      v[i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) v[i] = k0 + i < d ? __ldg(qrow + k0 + i) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const float b = vitorch::tf32_rna(v[i]);
    big[i] = __float_as_uint(b);
    small[i] = __float_as_uint(vitorch::tf32_rna(v[i] - b));
  }
}

// Bytes of the 16-byte-aligned envelope of `len` bytes at byte offset `a`
// of the table (whose base is 16-byte aligned): what one bulk copy moves.
__device__ __forceinline__ uint32_t envelope(size_t a, int len) {
  return static_cast<uint32_t>(((a + len + 15) & ~static_cast<size_t>(15)) -
                               (a & ~static_cast<size_t>(15)));
}

template <bool L2, typename T, bool VEC, bool KPAN>
__global__ void __launch_bounds__(THREADS, 2) stream_shared_plane_kernel(
    const float* __restrict__ qc, const int* __restrict__ blk_t,
    const float* __restrict__ scl_t, const T* __restrict__ vecs,
    const float* __restrict__ norms, int t_cap, int chunk, int d, int panel_rows, int stages,
    int kpanel, float* __restrict__ plane) {
  constexpr int E = RowType<T>::E;
  constexpr int QV = E < 8 ? E : 8;  // query values split per load (registers)
  constexpr bool F32 = sizeof(T) == 4;
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ uint64_t full[MAX_STAGES];
  __shared__ int task_blk[TPC], seg_first[TPC], seg_n[TPC], seg_blk[TPC];
  __shared__ int n_segs_s;

  const int t0 = blockIdx.x * TPC;
  const int row_bytes = d * static_cast<int>(sizeof(T));
  // A staged row: the whole row, or (KPAN) a K-panel's segment of it.
  const int seg_stride =
      KPAN ? kpanel * static_cast<int>(sizeof(T)) + (VEC ? 0 : 32) : row_bytes;
  const int stage_bytes = panel_rows * seg_stride;
  float* part_s = reinterpret_cast<float*>(ring + static_cast<size_t>(stages) * stage_bytes);
  if (threadIdx.x < TPC) task_blk[threadIdx.x] = t0 + threadIdx.x < t_cap ? blk_t[t0 + threadIdx.x] : -1;
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int u = 0; u < TPC; ++u) {
      const int b = task_blk[u];
      if (b < 0) continue;
      if (n > 0 && seg_blk[n - 1] == b && seg_first[n - 1] + seg_n[n - 1] == t0 + u) {
        ++seg_n[n - 1];
      } else {
        seg_first[n] = t0 + u;
        seg_n[n] = 1;
        seg_blk[n] = b;
        ++n;
      }
    }
    n_segs_s = n;
    for (int s = 0; s < MAX_STAGES; ++s) vitorch::mbar_init(&full[s], 1);
    vitorch::mbar_init_fence();
  }
  __syncthreads();
  const int n_segs = n_segs_s;
  if (n_segs == 0) return;  // only unused tasks: uniform across the block
  const int n_panels = chunk / panel_rows;
  const int n_kpan = KPAN ? (d + kpanel - 1) / kpanel : 1;  // K-panels per row
  const int n_loads = n_segs * n_panels * n_kpan;

  // Load i = K-panel i % n_kpan of row panel (i / n_kpan) % n_panels of
  // segment i / (n_kpan * n_panels)'s block, into stage i % stages.
  auto issue = [&](int i) {
    const int s = i % stages;
    const int j = i / n_kpan;
    const size_t row0 = static_cast<size_t>(seg_blk[j / n_panels]) * chunk +
                        static_cast<size_t>(j % n_panels) * panel_rows;
    const unsigned char* table = reinterpret_cast<const unsigned char*>(vecs);
    unsigned char* dst = ring + static_cast<size_t>(s) * stage_bytes;
    if constexpr (KPAN) {
      const int k0 = (i % n_kpan) * kpanel;
      const int seg = min(kpanel, d - k0) * static_cast<int>(sizeof(T));
      uint32_t bytes = 0;
      for (int r = 0; r < panel_rows; ++r)
        bytes += envelope((row0 + r) * row_bytes + k0 * sizeof(T), seg);
      vitorch::mbar_expect_tx(&full[s], bytes);
      for (int r = 0; r < panel_rows; ++r) {
        const size_t a = (row0 + r) * row_bytes + k0 * sizeof(T);
        vitorch::bulk_copy_g2s(dst + r * seg_stride, table + (a & ~static_cast<size_t>(15)),
                               envelope(a, seg), &full[s]);
      }
    } else {
      vitorch::mbar_expect_tx(&full[s], static_cast<uint32_t>(stage_bytes));
      vitorch::bulk_copy_g2s(dst, table + row0 * row_bytes, static_cast<uint32_t>(stage_bytes),
                             &full[s]);
    }
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < stages - 1 && i < n_loads; ++i) issue(i);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // Chunk order of this thread's two loads per 8-chunk group (see the note).
  const int par = VEC ? ((g ^ ((g * (seg_stride >> 4)) >> 2)) & 1) : 0;
  const int items_per_task = (panel_rows + ITEM_ROWS - 1) / ITEM_ROWS;

  for (int i = 0; i < n_loads; ++i) {
    if (threadIdx.x == 0 && i + stages - 1 < n_loads) issue(i + stages - 1);
    vitorch::mbar_wait(&full[i % stages], static_cast<uint32_t>((i / stages) & 1));
    const unsigned char* stage = ring + static_cast<size_t>(i % stages) * stage_bytes;
    const int kp = i % n_kpan, j = i / n_kpan;
    const int seg = j / n_panels, panel = j % n_panels;
    const int k0 = KPAN ? kp * kpanel : 0;  // the K-panel's first element
    const int seg_bytes = KPAN ? min(kpanel, d - k0) * static_cast<int>(sizeof(T)) : row_bytes;
    const int n_groups = (seg_bytes + 127) / 128;  // 8-chunk groups per staged row
    [[maybe_unused]] const bool first = kp == 0, last = kp == n_kpan - 1;
    const int blk = seg_blk[seg];
    const int n_items = seg_n[seg] * items_per_task;
    for (int item = warp; item < n_items; item += WARPS) {
      const int task = seg_first[seg] + item / items_per_task;
      const int r_item = (item % items_per_task) * ITEM_ROWS;  // first stage row
      // Stage rows of this thread: [mt][0] = tile row g, [mt][1] = g + 8
      // (clamped into the panel; rows past it are never written).
      const unsigned char* rowp[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = min(r_item + mt * 16 + h * 8 + g, panel_rows - 1);
          rowp[mt][h] = stage + static_cast<size_t>(r) * seg_stride;
          if (KPAN && !VEC)  // the segment's offset in its 16-byte envelope
            rowp[mt][h] += ((static_cast<size_t>(blk) * chunk + panel * panel_rows + r) * row_bytes +
                            k0 * sizeof(T)) & 15;
        }
      const float* qrow = qc + (static_cast<size_t>(task) * QS + g) * d;
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int grp = 0; grp < n_groups; ++grp) {
        // Raw 16-byte chunks grp*8 + t (cur 0) and grp*8 + t + 4 (cur 1).
        uint4 raw[2][2][2];  // [mt][row h][chunk]
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint4 w0 = load_chunk<VEC>(rowp[mt][h], grp * 8 + t + 4 * par, seg_bytes);
            const uint4 w1 = load_chunk<VEC>(rowp[mt][h], grp * 8 + t + 4 * (1 - par), seg_bytes);
            raw[mt][h][0] = par ? w1 : w0;
            raw[mt][h][1] = par ? w0 : w1;
          }
        float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int cur = 0; cur < 2; ++cur)
#pragma unroll
          for (int piece = 0; piece < E / QV; ++piece) {
            uint32_t qb[QV], qs[QV];
            load_query<QV, VEC>(qrow, k0 + (grp * 8 + t + 4 * cur) * E + piece * QV, d, qb, qs);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int s = 0; s < QV / 2; ++s) {
                // k-step: logical column t <- element e, t + 4 <- e + 1.
                const int e = piece * QV + 2 * s;
                const float a0 = chunk_elem<T>(raw[mt][0][cur], e);
                const float a1 = chunk_elem<T>(raw[mt][1][cur], e);
                const float a2 = chunk_elem<T>(raw[mt][0][cur], e + 1);
                const float a3 = chunk_elem<T>(raw[mt][1][cur], e + 1);
                if (F32) {
                  const float b0 = vitorch::tf32_rna(a0), b1 = vitorch::tf32_rna(a1);
                  const float b2 = vitorch::tf32_rna(a2), b3 = vitorch::tf32_rna(a3);
                  mma_tf32(part[mt], __float_as_uint(vitorch::tf32_rna(a0 - b0)),
                           __float_as_uint(vitorch::tf32_rna(a1 - b1)),
                           __float_as_uint(vitorch::tf32_rna(a2 - b2)),
                           __float_as_uint(vitorch::tf32_rna(a3 - b3)), qb[2 * s], qb[2 * s + 1]);
                  mma_tf32(part[mt], __float_as_uint(b0), __float_as_uint(b1), __float_as_uint(b2),
                           __float_as_uint(b3), qs[2 * s], qs[2 * s + 1]);
                  mma_tf32(part[mt], __float_as_uint(b0), __float_as_uint(b1), __float_as_uint(b2),
                           __float_as_uint(b3), qb[2 * s], qb[2 * s + 1]);
                } else {  // the row is exact in tf32
                  mma_tf32(part[mt], __float_as_uint(a0), __float_as_uint(a1), __float_as_uint(a2),
                           __float_as_uint(a3), qs[2 * s], qs[2 * s + 1]);
                  mma_tf32(part[mt], __float_as_uint(a0), __float_as_uint(a1), __float_as_uint(a2),
                           __float_as_uint(a3), qb[2 * s], qb[2 * s + 1]);
                }
              }
          }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][e] += part[mt][e];
      }
      if constexpr (KPAN) {
        // Item `item` (< TPC: one per task, panel_rows <= ITEM_ROWS) is this
        // thread's on every K-panel of the row panel: carry its sums.
        float* carry = part_s + static_cast<size_t>(item) * 8 * 32 + lane;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (!first) acc[mt][e] += carry[(mt * 4 + e) * 32];
            if (!last) carry[(mt * 4 + e) * 32] = acc[mt][e];
          }
        if (!last) continue;
      }
      // Epilogue: element e of tile mt is stage row r_item + mt*16 + g +
      // 8*(e >> 1), query row 2t + (e & 1).
      const float scl = sizeof(T) == 1 ? scl_t[task] : 1.f;
      float* out = plane + static_cast<size_t>(task) * QS * chunk;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r_item + mt * 16 + h * 8 + g;
          if (r >= panel_rows) continue;
          const int l = panel * panel_rows + r;
          const float nrm = norms[static_cast<size_t>(blk) * chunk + l];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float dot = acc[mt][2 * h + j] * scl;
            out[static_cast<size_t>(2 * t + j) * chunk + l] =
                L2 ? nrm - 2.f * dot : (nrm >= VITORCH_SENTINEL ? nrm : 0.f) - dot;
          }
        }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
}

// Checks the wrapper's plan and launches it. Whole rows (kpanel == d): a
// stage is `panel_rows` contiguous rows, a 16-byte multiple. K-panels
// (kpanel < d, a multiple of 128 bytes): `panel_rows` <= ITEM_ROWS row
// segments a stage, and the carried accumulators after the ring.
template <bool L2, typename T>
int launch_shared(const void* qc, const void* blk_t, const void* scl_t, const void* vecs,
                  const void* norms, int t_cap, int chunk, int d, int panel_rows, int stages,
                  int kpanel, void* plane, cudaStream_t st) {
  const size_t row_bytes = static_cast<size_t>(d) * sizeof(T);
  const bool vec = row_bytes % 16 == 0;
  const bool kpan = kpanel < d;
  if (chunk % 16 != 0 || panel_rows < 1 || chunk % panel_rows != 0 || stages < 1 ||
      stages > MAX_STAGES || kpanel < 1 || kpanel > d)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t stage_bytes =
      kpan ? static_cast<size_t>(panel_rows) * (kpanel * sizeof(T) + (vec ? 0 : 32))
           : static_cast<size_t>(panel_rows) * row_bytes;
  if (kpan ? (kpanel * sizeof(T)) % 128 != 0 || panel_rows > ITEM_ROWS
           : stage_bytes % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = stages * stage_bytes + (kpan ? PART_BYTES : 0);
  if (smem > MAX_RING_BYTES) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = kpan ? (vec ? stream_shared_plane_kernel<L2, T, true, true>
                          : stream_shared_plane_kernel<L2, T, false, true>)
                   : (vec ? stream_shared_plane_kernel<L2, T, true, false>
                          : stream_shared_plane_kernel<L2, T, false, false>);
  if (smem > 40 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<dim3((t_cap + TPC - 1) / TPC), THREADS, smem, st>>>(
      static_cast<const float*>(qc), static_cast<const int*>(blk_t),
      static_cast<const float*>(scl_t), static_cast<const T*>(vecs),
      static_cast<const float*>(norms), t_cap, chunk, d, panel_rows, stages, kpanel,
      static_cast<float*>(plane));
  return 0;
}

}  // namespace

VITORCH_API int vitorch_stream_shared_plane(const void* qc, const void* blk_t,
                                            const void* scl_t, const void* vecs,
                                            const void* norms, int t_cap, int q_share,
                                            int chunk, int d, int is_l2, int row_type,
                                            int panel_rows, int stages, int kpanel,
                                            void* plane, void* stream) {
  if (q_share != QS) return static_cast<int>(cudaErrorInvalidValue);
  if (t_cap <= 0) return static_cast<int>(cudaGetLastError());
  auto st = static_cast<cudaStream_t>(stream);
  int rc = 0;
#define VITORCH_K5(L2, T) \
  rc = launch_shared<L2, T>(qc, blk_t, scl_t, vecs, norms, t_cap, chunk, d, panel_rows, stages, \
                            kpanel, plane, st)
  switch (row_type) {
    case vitorch::ROW_BF16:
      if (is_l2) VITORCH_K5(true, __nv_bfloat16); else VITORCH_K5(false, __nv_bfloat16);
      break;
    case vitorch::ROW_INT8:
      if (is_l2) VITORCH_K5(true, int8_t); else VITORCH_K5(false, int8_t);
      break;
    case vitorch::ROW_F32:
      if (is_l2) VITORCH_K5(true, float); else VITORCH_K5(false, float);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VITORCH_K5
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
