// Fused window gather -> squared distance -> streaming top-K for the
// level-segmented query path, written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/knn_tile.py:293, knn_tile_anchored (Pallas
// body _knn_anchored_kernel with _stream_candidates, _merge_topk,
// _emit_best). It computes what that kernel computes, for every level in
// ONE launch: each query tile reads its level, looks up its sphere-test
// flag in a small table, reads its window extent (the level's ladder cube,
// or the exact box of a full-radius tile's members' windows), derives
// candidate ids from its anchor by index arithmetic on the flattened dense
// grid, and keeps, per query, the k smallest valid candidates by (d2,
// window position): what a stream in window order with the strictly-less
// insertion rule keeps.
//
// What bounds it on this card: the distance work over the valid candidates
// (tile x valid slots, about ten FP32 operations a pair) outweighs the
// bytes it must move (the points, the dense grid, the queries and the
// outputs, each once), so the bound is operations. What sets the pace now
// is the compare of each (query, valid candidate) pair, about 13 warp
// instructions a pair (a shared-memory broadcast, the distance, a test),
// and, where most cells are empty, the walk of the window's cells.
//
// What the design does about it:
// - Walk only occupied slots. The wrapper marks each grid cell that holds
//   any id (one byte a cell). A CTA looks up its window's cells,
//   kRounds per thread per round, lists the occupied ones in window order
//   (warp ballot, then a scan of the per-warp counts), reads their slots
//   coalesced and compacts the valid ids, with their gathered positions,
//   into shared memory. Only those reach the per-query loop, four
//   candidates at a time. Any dense grid works: no precondition on how
//   the slots of a cell are filled.
// - Split large windows across CTAs. The wrapper cuts every tile's window
//   into work items of whole cells, at most SEG slots each (knn_tile.py,
//   work_items: an argsort by window size and a cumsum, on the device, no
//   host sync). A persistent grid, sized from the SM count and the
//   occupancy, reads the item count from device memory and takes the
//   items largest-first, in guided chunks of consecutive items from an
//   atomic counter; it streams the items of one tile in a chunk as one
//   run. A run that covers its whole tile writes the tile's rows directly.
// - Merge partial top-Ks without order. A run that covers part of a tile
//   keeps the window position beside each entry; under the tile's lock it
//   merges its list, by the key (d2, position), into the tile's rows of
//   the outputs themselves (d2, and the position in place of the id), and
//   the run that completes the tile writes the final rows (+inf / -1 where
//   empty, the position turned back into its id). The result is bitwise
//   the one-stream result, ties included, in whatever order runs finish.
//   A tile is merged once per chunk that covers part of it, not once per
//   item, so the merges of a whole-grid window do not queue on its lock.
// Scratch: the wrapper's order [n_tiles] and cum [n_tiles + 1] (int32),
// the occupancy byte of every grid cell, a lock and a merge count per tile
// and one item counter (int32, zeroed): 16 * n_tiles + 8 bytes plus one a
// grid cell, whatever k, the number of items or the window sizes (the
// outputs themselves hold the partial rows). One call of the wrapper
// issues this one kernel after a few small PyTorch operations that build
// the item list and the occupancy and zero the locks.
//
// Walked-pair counter: each CTA counts, per run of a unit, the window cells
// it looks up, the occupied ones among them, the valid candidate ids it
// stages and the (query row, staged candidate) pairs it compares (the
// unit's rows times the staged ids), and once per unit (the run of its
// first item) the unit's query rows. It sums them in shared memory by the
// tile's table level (levels past kWalkLevels together) and whether the
// tile's extent differs from that level's entry (a boxed tile), and at
// exit adds each sum with one 64-bit atomicAdd a count into a process-wide
// table of kWalkSlots rows keyed by the level's signature (wx, wy, wz,
// skip) and the boxed flag: key, cells, occupied, staged, pairs, rows
// (``walk``, which the wrapper never fetches; obs reads it). So boxes of
// any extent count in two rows a level at most. Thread 0 counts, in shared
// memory, from values the round reads anyway, so the compare loop holds no
// register more; no call, search or atomic runs inside the loop over tiles.
// Nothing else reads the counts, so results are unchanged. A tile of
// several row blocks walks its window once a block, and is counted so.
//
// Exactness and ties: the arithmetic, the list, the compaction round, the
// scan of the stage and the merge are those of knn_stream.cuh (sums x, y,
// z through __fmul_rn/__fadd_rn), shared with knn_tile.cu, so the two
// kernels agree bitwise on the same candidates. k <= 8 keeps its list in
// registers; a longer one lives in local memory.
//
// Any k and any tile: a k above 128 runs as passes of the 128 kernel, one
// launch each (knn_stream.cuh: pass p keeps the keys after the last key of
// pass p - 1, carried per query in scratch, and writes output columns
// [128p, 128p + 128)). A tile that is not a whole number of warps, or has
// more than 1024 rows, runs masked: the wrapper cuts it into row blocks of
// at most 1024 that share its anchor, extent and level, and the work items
// are per (tile, row block). Threads past a block's rows stage candidates
// with the others but keep no list and write nothing. A query's result
// depends only on its row and its tile's window, so neither changes a
// result; the unmasked k <= 128 kernels are the code above, unchanged.
#include "knn_stream.cuh"

namespace {

using knn_stream::Best;
using knn_stream::dot3;
using knn_stream::kAll;
using knn_stream::kBig;
using knn_stream::kRounds;          // cells or slots per thread per round

// n / d by multiply and shift, exact for 0 <= n < 2^31 and 1 <= d < 2^31
// (Granlund and Montgomery): the window's divisors are fixed per item.
struct FastDiv {
  unsigned mul, shift;
  bool one;

  FastDiv() = default;                  // trivial: it lives in __shared__
  __device__ explicit FastDiv(int d) : mul(0), shift(0), one(d == 1) {
    if (!one) {
      const int l = 32 - __clz(d - 1);              // ceil(log2 d)
      mul = static_cast<unsigned>(((1ull << (31 + l)) + d - 1) / d);
      shift = l - 1;
    }
  }
  __device__ __forceinline__ int operator()(int n) const {
    return one ? n : static_cast<int>(__umulhi(n, mul) >> shift);
  }
};

// A tile's window, cells in x, y, z raster order and slots innermost: the
// candidate id at window position cc, clipped to the flattened grid as the
// reference clips, and whether window cell c holds any id (looked up at the
// edge cell its slots clip to when it lies outside the grid). The wx * wy
// runs of wz cells (wz * cap slots) are contiguous in the grid.
struct Window {
  const int* __restrict__ dense;
  const unsigned char* __restrict__ occupied;
  long long n_flat, n_cells;
  int ax, ay, az, dy, dz, cap, wy, wz;
  FastDiv by_run, by_wy, by_wz, by_cap;

  __device__ __forceinline__ int id(int cc) const {
    const int r = by_run(cc);                 // (ix, iy) run, then offset
    const int off = cc - r * wz * cap;
    const int ix = by_wy(r);
    const int iy = r - ix * wy;
    long long flat =
        (((long long)(ax + ix) * dy + (ay + iy)) * dz + az) * cap + off;
    flat = flat < 0 ? 0 : (flat >= n_flat ? n_flat - 1 : flat);
    return dense[flat];
  }

  __device__ __forceinline__ bool occupied_at(int c) const {
    const int r = by_wz(c);
    const int iz = c - r * wz;
    const int ix = by_wy(r);
    const int iy = r - ix * wy;
    long long cell = ((long long)(ax + ix) * dy + (ay + iy)) * dz + az + iz;
    cell = cell < 0 ? 0 : (cell >= n_cells ? n_cells - 1 : cell);
    return occupied[cell] != 0;
  }
};

struct Args {
  const float* __restrict__ q;         // [n_tiles * tile, 3]
  const float* __restrict__ points;    // [n_pts, 3]
  const int* __restrict__ dense;       // [n_flat]
  const int* __restrict__ anchors;     // [n_tiles, 3]
  const int* __restrict__ levels;      // [n_tiles]
  const int* __restrict__ table;       // [n_entries, 4] (wx, wy, wz, skip)
  const int* __restrict__ extents;     // [n_tiles, 3] (wx, wy, wz) per tile
  const int* __restrict__ order;       // [n_tiles] units, largest first
  const int* __restrict__ cum;         // [n_tiles + 1] first item of each
  const unsigned char* __restrict__ occupied;  // [n_flat / cap] cell holds
                                               // an id (0 / 1)
  int* locks;                          // [n_tiles], zeroed
  int* merged;                         // [n_tiles], zeroed
  int* next;                           // [1] items taken, zeroed
  float* out_d2;                       // [rows, ld]
  int* out_idx;                        // [rows, ld]
  long long n_flat;
  int n_entries, n_tiles, n_pts, dy, dz, cap, k;  // n_tiles: units of work
                                       // (tile, row block); k: list length
  int seg_cells;                       // window cells per work item
  float r2;
  // masked launch: unit u is rows [r0, r0 + rb_rows) of tile u / n_rb,
  // r0 = (u % n_rb) * rb_rows, clipped to the tile's tile_rows
  int tile_rows, rb_rows, n_rb;
  // pass launch: output columns [col0, col0 + k) of rows of ld entries,
  // after the key (lo_d, lo_p)[row] of the pass before, which it replaces
  int ld, col0;
  float* lo_d;
  int* lo_p;
  unsigned long long* walk;            // [kWalkSlots, kWalkRow] counter
};

// The walk counter's table (see the top of the file): kWalkSlots rows of
// kWalkRow words, the last two taking every signature that finds no free
// row and the levels past kWalkLevels (key kWalkOverflow, and its boxed
// bit); a CTA sums kWalkLevels levels apart and the rest in one more
// entry, each with and without boxes.
constexpr int kWalkSlots = 256;
constexpr int kWalkRow = 6;   // key, cells, occupied, staged, pairs, rows
constexpr int kWalkCounts = kWalkRow - 1;
constexpr int kWalkLevels = 32;
constexpr unsigned long long kWalkOverflow = 1ull << 63;

// A CTA's static shared memory: the bookkeeping of a round, a merge and a
// chunk, and the window of the tile being run. (The dynamic part: the
// compacted candidates, (kRounds + 1) * blockDim.x positions with |p|^2
// and as many window positions, then kRounds * blockDim.x listed cells.)
struct Stage {
  knn_stream::Ranks rk;       // a round's counts
  int merged;
  int chunk[3];               // tile index j (-1: no work left), items
  Window w;                   // the window of the tile being run
  // thread 0's walk counts: the run's cells, occupied cells and staged
  // ids; the CTA's sums by table level (the levels past kWalkLevels last)
  // and boxed flag
  int run[3];
  unsigned long long walk[kWalkLevels + 1][2][kWalkCounts];
};

// The counter table's row for a level's signature ``sig`` (wx, wy, wz,
// skip; null for the levels past kWalkLevels) and boxed flag: the row
// whose key it is, else the first free row from its hash on (a 64-bit CAS
// claims it), else an overflow row.
__device__ unsigned long long* walk_row(unsigned long long* walk,
                                        const int* sig, int boxed) {
  constexpr unsigned kMax = 1u << 20;  // 20 bits a window side
  constexpr int kRows = kWalkSlots - 2;
  if (sig != nullptr && (unsigned)sig[0] < kMax && (unsigned)sig[1] < kMax &&
      (unsigned)sig[2] < kMax) {
    const unsigned long long key =
        ((unsigned long long)sig[0] << 42) |
        ((unsigned long long)sig[1] << 22) |
        ((unsigned long long)sig[2] << 2) | ((unsigned long long)boxed << 1) |
        (sig[3] != 0);
    int h = static_cast<int>(((key * 0x9E3779B97F4A7C15ull) >> 32) % kRows);
    for (int i = 0; i < kRows; ++i, h = h + 1 == kRows ? 0 : h + 1) {
      unsigned long long* row = walk + (size_t)h * kWalkRow;
      const unsigned long long was = atomicCAS(row, 0ull, key);
      if (was == 0ull || was == key) return row;
    }
  }
  unsigned long long* row = walk + (size_t)(kRows + boxed) * kWalkRow;
  atomicCAS(row, 0ull, kWalkOverflow | ((unsigned long long)boxed << 1));
  return row;
}

// Thread 0 adds the run of ``unit`` (its counts in st.run) that starts at
// its item ``first_item`` to its CTA's sums for the tile's level and boxed
// flag (a run looks up at least one cell, so the level is on the table).
template <bool kMasked>
__device__ __forceinline__ void count_walk(Stage& st, const Args& a,
                                           int unit, int first_item) {
  int tile = unit, rows = blockDim.x;     // the unit's tile and query rows
  if constexpr (kMasked) {
    tile = unit / a.n_rb;
    const int r0 = (unit - tile * a.n_rb) * a.rb_rows;
    rows = max(0, min(a.rb_rows, a.tile_rows - r0));
  }
  const int lvl = a.levels[tile];
  const int* ext = a.extents + tile * 3;
  const int* sig = a.table + lvl * 4;
  const int boxed = ext[0] != sig[0] || ext[1] != sig[1] || ext[2] != sig[2];
  unsigned long long* sums = st.walk[min(lvl, kWalkLevels)][boxed];
  sums[0] += st.run[0];
  sums[1] += st.run[1];
  sums[2] += st.run[2];
  sums[3] += (unsigned long long)st.run[2] * rows;
  if (first_item == 0) sums[4] += rows;
}

// At a CTA's exit: its sums of each (level, boxed) it ran into the counter
// table, one a thread.
__device__ __forceinline__ void flush_walk(const Stage& st, const Args& a) {
  for (int i = threadIdx.x; i < 2 * (kWalkLevels + 1); i += blockDim.x) {
    const int lvl = i >> 1, boxed = i & 1;
    const unsigned long long* sums = st.walk[lvl][boxed];
    if (sums[0] == 0) continue;
    unsigned long long* row = walk_row(
        a.walk, lvl < kWalkLevels ? a.table + lvl * 4 : nullptr, boxed);
#pragma unroll
    for (int c = 0; c < kWalkCounts; ++c)
      if (sums[c]) atomicAdd(row + 1 + c, sums[c]);
  }
}

// One run of a tile's work items: items first_item .. first_item + covered
// of its nseg, one stream over their window slots through a fresh best-K
// per query. Then it writes the tile's rows, or merges into them under the
// tile's lock if other runs cover the rest. Every thread of the CTA calls
// this together.
template <int KMAX, bool kMasked, bool kPass>
__device__ __forceinline__ void run_tile(const Args& a, Stage& st,
                                         float4* s_pt, int* s_pos,
                                         int* s_cells, int unit,
                                         int first_item, int covered,
                                         int nseg) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nthr = blockDim.x, nw = nthr >> 5;
  int tile = unit;                        // the unit's tile
  long long row = (long long)unit * nthr + t;
  bool active = true;                     // this thread holds a row
  if constexpr (kMasked) {
    tile = unit / a.n_rb;
    const int r0 = (unit - tile * a.n_rb) * a.rb_rows;
    active = t < min(a.rb_rows, a.tile_rows - r0);
    row = (long long)tile * a.tile_rows + r0 + t;
  }
  const float qx = active ? a.q[row * 3 + 0] : 0.f,
              qy = active ? a.q[row * 3 + 1] : 0.f,
              qz = active ? a.q[row * 3 + 2] : 0.f;
  const float qn = dot3(qx, qy, qz, qx, qy, qz);
  float lo_d = 0.f;
  int lo_p = 0;
  if constexpr (kPass) {
    if (active) {
      lo_d = a.lo_d[row];
      lo_p = a.lo_p[row];
    }
  }
  Best<KMAX> best;
  best.reset();

  int win_cells = 0;                      // 0 off the table
  bool skip = false;
  const int lvl = a.levels[tile];
  if (lvl >= 0 && lvl < a.n_entries) {    // uniform across the CTA
    const int wx = a.extents[tile * 3 + 0], wy = a.extents[tile * 3 + 1],
              wz = a.extents[tile * 3 + 2];
    skip = a.table[lvl * 4 + 3] != 0;
    win_cells = wx * wy * wz;  // inside the grid: * cap <= n_flat < 2^31
    if (t == 0) {
      Window& w = st.w;
      w.dense = a.dense;
      w.occupied = a.occupied;
      w.n_flat = a.n_flat;
      w.n_cells = a.n_flat / a.cap;
      w.ax = a.anchors[tile * 3 + 0];
      w.ay = a.anchors[tile * 3 + 1];
      w.az = a.anchors[tile * 3 + 2];
      w.dy = a.dy;
      w.dz = a.dz;
      w.cap = a.cap;
      w.wy = wy;
      w.wz = wz;
      w.by_run = FastDiv(wz * a.cap);
      w.by_wy = FastDiv(wy);
      w.by_wz = FastDiv(wz);
      w.by_cap = FastDiv(a.cap);
    }
  }
  __syncthreads();                        // st.w is set
  const Window& w = st.w;
  const int c_first = static_cast<int>(
      min((long long)first_item * a.seg_cells, (long long)win_cells));
  const int c_last = static_cast<int>(
      min((long long)(first_item + covered) * a.seg_cells,
          (long long)win_cells));

  if (t == 0) {                           // the run's walk counts
    st.run[0] = c_last - c_first;
    st.run[1] = st.run[2] = 0;
  }

  const float cap = skip ? kBig : nextafterf(a.r2, CUDART_INF_F);
  float lim = cap;
  const unsigned below = (1u << lane) - 1;
  int parity = 0;

  // Two levels: list the window cells that hold any id, then stage the
  // occupied slots of those cells, with their positions, in window order.
  int fill = 0;
  for (long long cb = c_first; cb < c_last;
       cb += (long long)kRounds * nthr) {
    bool on[kRounds];
    unsigned mk[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const long long c = cb + (long long)r * nthr + t;
      on[r] = c < c_last && w.occupied_at(static_cast<int>(c));
    }
    const int* cnt = knn_stream::rank_round(st.rk, parity, on, mk);
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      if (on[r])
        s_cells[cnt[r * nw + warp] + __popc(mk[r] & below)] =
            static_cast<int>(cb + (long long)r * nthr + t);
    }
    if (t == 0) st.run[1] += st.rk.total;
    const int n_slots = st.rk.total * w.cap;
    __syncthreads();                      // s_cells is complete
    for (int sb = 0; sb < n_slots; sb += kRounds * nthr) {
      int id[kRounds], pos[kRounds];
      bool valid[kRounds];
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        const int i = sb + r * nthr + t;
        id[r] = -1;
        if (i < n_slots) {
          const int li = w.by_cap(i);
          pos[r] = s_cells[li] * w.cap + (i - li * w.cap);
          id[r] = w.id(pos[r]);
        }
        valid[r] = id[r] >= 0;
      }
      const int* scnt = knn_stream::rank_round(st.rk, parity, valid, mk);
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        if (valid[r]) {
          const int at = fill + scnt[r * nw + warp] + __popc(mk[r] & below);
          const long long p = id[r] < a.n_pts ? id[r] : a.n_pts - 1;
          const float px = a.points[p * 3 + 0], py = a.points[p * 3 + 1],
                      pz = a.points[p * 3 + 2];
          s_pt[at] = make_float4(px, py, pz, dot3(px, py, pz, px, py, pz));
          s_pos[at] = pos[r];
        }
      }
      fill += st.rk.total;
      if (t == 0) st.run[2] += st.rk.total;
      if (fill > nthr) {                  // room for one more round only
        knn_stream::pad_stage(s_pt, fill);
        __syncthreads();
        if (active)
          knn_stream::scan_stage<KMAX, kPass>(
              s_pt, s_pos, (fill + 3) & ~3, qx, qy, qz, qn, best, a.k, cap,
              lim, lo_d, lo_p);
        fill = 0;
      }
    }
  }
  if (fill > 0) {
    knn_stream::pad_stage(s_pt, fill);
    __syncthreads();
    if (active)
      knn_stream::scan_stage<KMAX, kPass>(s_pt, s_pos, (fill + 3) & ~3, qx,
                                          qy, qz, qn, best, a.k, cap, lim,
                                          lo_d, lo_p);
  }

  // write the tile's rows, or merge into them under its lock
  knn_stream::finish_unit<KMAX, kPass>(
      a, best, unit, row, active, covered, nseg,
      [&w](int pos) { return w.id(pos); }, st.merged);

  if (t == 0 && st.run[0] > 0) count_walk<kMasked>(st, a, unit, first_item);
}

// Persistent: each CTA takes chunks of consecutive work items (guided: a
// chunk is 1 / (kGuide * gridDim.x) of what is left, at least one item)
// and runs each tile they touch once, so a tile is merged once per chunk
// that covers part of it, not once per item.
constexpr int kGuide = 4;

template <int KMAX, bool kMasked, bool kPass>
__global__ void __launch_bounds__(1024) knn_tile_anchored_kernel(Args a) {
  extern __shared__ float4 s_pt[];
  __shared__ Stage st;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* s_pos = reinterpret_cast<int*>(s_pt + (kRounds + 1) * blockDim.x);
  int* s_cells = s_pos + (kRounds + 1) * blockDim.x;
  const int n_items = a.cum[a.n_tiles];
  for (int i = threadIdx.x; i < 2 * (kWalkLevels + 1); i += blockDim.x)
    for (int c = 0; c < kWalkCounts; ++c) st.walk[i >> 1][i & 1][c] = 0;

  for (;;) {
    if (warp == 0) {                      // take a chunk, find its first tile
      int start = 0, size = 0;
      if (lane == 0) {
        const int taken = *reinterpret_cast<volatile int*>(a.next);
        size = max(1, (n_items - taken) / (kGuide * (int)gridDim.x));
        start = atomicAdd(a.next, size);
      }
      start = __shfl_sync(kAll, start, 0);
      size = __shfl_sync(kAll, size, 0);
      if (start >= n_items) {
        if (lane == 0) st.chunk[0] = -1;
      } else {
        // the j with cum[j] <= start < cum[j + 1], 32 probes a step
        int lo = 0, hi = a.n_tiles;
        while (hi - lo > 1) {
          const int step = (hi - lo + 31) / 32;
          const int p = lo + lane * step;
          const unsigned le =
              __ballot_sync(kAll, p < hi && a.cum[p] <= start);
          lo += (31 - __clz(le)) * step;
          hi = min(lo + step, hi);
        }
        if (lane == 0) {
          st.chunk[0] = lo;
          st.chunk[1] = start;
          st.chunk[2] = min(start + size, n_items);
        }
      }
    }
    __syncthreads();
    int j = st.chunk[0];
    if (j < 0) break;
    int item = st.chunk[1];
    const int end = st.chunk[2];
    __syncthreads();                      // st.chunk is read
    while (item < end) {                  // uniform across the CTA
      const int c0 = a.cum[j], c1 = a.cum[j + 1];
      const int upto = min(end, c1);
      run_tile<KMAX, kMasked, kPass>(a, st, s_pt, s_pos, s_cells,
                                     a.order[j], item - c0, upto - item,
                                     c1 - c0);
      item = upto;
      ++j;
    }
  }
  flush_walk(st, a);                      // st.walk is complete
}

template <int KMAX, bool kMasked, bool kPass>
int launch(const Args& a, int tile, cudaStream_t stream) {
  const size_t smem = (size_t)(kRounds + 1) * tile *
                          (sizeof(float4) + sizeof(int)) +
                      (size_t)kRounds * tile * sizeof(int);
  auto kernel = knn_tile_anchored_kernel<KMAX, kMasked, kPass>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int resident = 0;
  if (err == cudaSuccess)
    err = knn_stream::resident_ctas(kernel, tile, smem, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<resident, tile, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kMasked>
int launch_k(const Args& a, int block, cudaStream_t s) {
  if (a.lo_d != nullptr) return launch<128, kMasked, true>(a, block, s);
  if (a.k <= 8) return launch<8, kMasked, false>(a, block, s);
  if (a.k <= 32) return launch<32, kMasked, false>(a, block, s);
  return launch<128, kMasked, false>(a, block, s);
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on ``stream`` and
// returns the first CUDA error of the set-up or the launch: 0 on success.
// ``extents`` is [n_tiles, 3] int32, each tile's window extent in cells
// (inside the grid from its anchor); ``occupied`` is [n_flat / cap] bytes,
// whether each cell holds an id;
// ``sync`` is [2 * n_units + 1] int32 zeros: the locks, the merge counts
// and the item counter; ``order`` and ``cum`` are per unit. A unit is a
// row block of ``rb_rows`` rows of a tile of ``tile`` rows (``n_rb`` a
// tile), run by CTAs of ``block`` threads (a multiple of 32); ``block ==
// tile`` and ``n_rb == 1`` is the unmasked kernel. ``k`` (at most 128) is
// this launch's list length and ``ld`` the output row length; with
// ``lo_d``/``lo_p`` non-null the launch is the pass that writes columns
// [col0, col0 + k). ``walk`` is the [kWalkSlots, kWalkRow] uint64 walk
// counter table (zeroed once; the launch adds to it).
extern "C" int knn_tile_anchored_walk_slots() { return kWalkSlots; }

extern "C" int knn_tile_anchored_launch(
    const float* q, const float* points, const int* dense,
    const int* anchors, const int* levels, const int* table,
    const int* extents, int n_entries,
    const int* order, const int* cum, const unsigned char* occupied,
    int* sync, int n_units, int tile, int rb_rows, int n_rb, int block,
    int n_pts, int n_flat, int dy, int dz, int cap, int k, int ld, int col0,
    int seg_cells, float r2, float* lo_d, int* lo_p, float* out_d2,
    int* out_idx, unsigned long long* walk, void* stream) {
  if (n_units <= 0) return 0;
  if (k < 1 || k > 128 || block % 32 || block < rb_rows || walk == nullptr ||
      (lo_d == nullptr && (ld != k || col0 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q, points, dense, anchors, levels, table, extents, order, cum,
               occupied, sync, sync + n_units, sync + 2 * n_units, out_d2,
               out_idx, n_flat, n_entries, n_units, n_pts, dy, dz, cap, k,
               seg_cells, r2, tile, rb_rows, n_rb, ld, col0, lo_d, lo_p,
               walk};
  if (n_rb == 1 && block == tile) return launch_k<false>(a, block, s);
  return launch_k<true>(a, block, s);
}
