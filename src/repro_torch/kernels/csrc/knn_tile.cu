// Streaming top-K over a caller-supplied candidate-id stream, written for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/knn_tile.py:172, knn_tile (pallas_call :209;
// Pallas body _knn_kernel with _stream_candidates, _merge_topk,
// _emit_best). Each query tile i streams the ids wnd_idx[i, 0..m) (-1 =
// invalid), in order, through an ascending per-query top-K of squared
// distances, dropping candidates beyond r2 unless the launch's skip_test
// flag is set.
//
// What bounds it on this card: the distance work over the valid ids (tile
// x valid ids, about ten FP32 operations a pair) outweighs the bytes it
// must move (4 B an id read once, the points, the queries, the outputs), so
// the bound is operations. An invalid id costs its 4 bytes and nothing
// else.
//
// What the design does about it:
// - Split each stream across a full grid. A unit of work is one (tile, row
//   block). The wrapper cuts each unit's m ids into nseg segments of seg
//   consecutive positions (knn_tile.py, stream_split), enough that the
//   launch's n_units * nseg work items number several per CTA the card
//   holds at once (knn_tile_resident: SM count x occupancy), so that 64
//   tiles fill 132 SMs. The grid is a plain one, one CTA an item,
//   segment-major (CTA b runs segment b / n_units of unit b % n_units), so
//   the CTAs in flight together hold few items of any one unit and seldom
//   queue on its lock. Plain, not persistent: every item of a launch is the
//   same length, so there is no size order to keep, and the hardware hands
//   an SM its next CTA as one retires, the balance an atomic item counter
//   gives, without the counter.
// - Compute only on valid ids. A CTA reads its segment's ids coalesced,
//   kRounds a thread a round, and compacts the valid ones in stream order
//   (warp ballot, then a scan of the per-warp counts) into shared memory,
//   each with its gathered position, |p|^2 and stream position. Only those
//   reach the per-query loop, four at a time, with one copy of the
//   insertion code (knn_stream.cuh, scan_stage).
// - Merge without order. An item's partial top-K keeps the stream position
//   beside each entry; under the unit's lock it is merged by the key (d2,
//   position) into the unit's rows of the outputs, and the item that
//   completes the unit writes the final rows: +inf / -1 where empty,
//   positions turned back into ids (knn_stream.cuh, finish_unit). A unit of
//   one item writes its rows directly.
// - Keep the list in registers. On these streams a query's list takes
//   enough updates that a list in local memory costs more than the scan.
//   Built for CTAs of up to 1024 threads (64 registers a thread), ptxas
//   placed the k <= 8 list in local memory here, though the anchored
//   kernel keeps the same list at 64 registers: the merge path of this
//   kernel makes the difference, and neither a merge loop that is not
//   unrolled, 32-bit positions, nor the body in an item loop changed it.
//   So CTAs hold at most 256 threads, two an SM (__launch_bounds__(256,
//   2): 128 registers), and a tile of more than 256 rows runs as row
//   blocks.
// Scratch: a lock and a merge count per unit (int32, zeroed), 8 bytes a
// unit whatever k and m; the outputs hold the partial rows.
//
// Any k and any tile: a k above 128 runs as passes of the 128 kernel, one
// launch each (knn_stream.cuh); the keys are global stream positions, so
// the passes compose with the split unchanged. A tile that is not a whole
// number of warps, or has more than 256 rows, runs masked in row blocks of
// at most 256 rows that share the tile's stream; threads past a block's
// rows stage candidates with the others but keep no list and write
// nothing.
//
// Exactness and ties: the distance, the list, the compaction, the scan and
// the merge are knn_tile_anchored.cu's (knn_stream.cuh), ids are clipped to
// [0, n_pts - 1] for the gather, so on the ids of an anchored window in
// window order the two kernels agree bitwise.
#include "knn_stream.cuh"

namespace {

using knn_stream::Best;
using knn_stream::dot3;
using knn_stream::kBig;
using knn_stream::kRounds;

// Threads a CTA at most, two CTAs an SM: 128 registers a thread, room to
// keep the k <= 8 list in registers (see the note above).
constexpr int kMaxBlock = 256;

struct Args {
  const float* __restrict__ q;         // [rows, 3]
  const float* __restrict__ points;    // [n_pts, 3]
  const int* __restrict__ wnd_idx;     // [n_tiles, m]
  int* locks;                          // [n_units], zeroed
  int* merged;                         // [n_units], zeroed
  float* out_d2;                       // [rows, ld]
  int* out_idx;                        // [rows, ld]
  int n_units, n_pts, m, k;            // k: this launch's list length
  int seg, nseg;                       // ids per item, items per unit
  bool skip;
  float r2;
  // masked launch: unit u is rows [r0, r0 + rb_rows) of tile u / n_rb,
  // r0 = (u % n_rb) * rb_rows, clipped to the tile's tile_rows
  int tile_rows, rb_rows, n_rb;
  // pass launch: output columns [col0, col0 + k) of rows of ld entries,
  // after the key (lo_d, lo_p)[row] of the pass before, which it replaces
  int ld, col0;
  float* lo_d;
  int* lo_p;
};

// One work item: segment blockIdx.x / n_units of unit blockIdx.x %
// n_units. (Dynamic shared memory: (kRounds + 1) * blockDim.x compacted
// candidates, each a float4 of its position and |p|^2, then as many stream
// positions.)
template <int KMAX, bool kMasked, bool kPass>
__global__ void __launch_bounds__(kMaxBlock, 2) knn_tile_kernel(Args a) {
  extern __shared__ float4 s_pt[];
  __shared__ knn_stream::Ranks rk;
  __shared__ int s_merged;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nthr = blockDim.x, nw = nthr >> 5;
  int* s_pos = reinterpret_cast<int*>(s_pt + (kRounds + 1) * nthr);
  const int unit = blockIdx.x % a.n_units;
  const int s = blockIdx.x / a.n_units;
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

  const int* ids = a.wnd_idx + (long long)tile * a.m;
  const long long first = (long long)s * a.seg;
  const long long last = min(first + a.seg, (long long)a.m);
  const float cap = a.skip ? kBig : nextafterf(a.r2, CUDART_INF_F);
  float lim = cap;
  const unsigned below = (1u << lane) - 1;
  int parity = 0, fill = 0;
  // Rounds of kRounds * nthr ids, then a final flush of the stage: one
  // call site of the scan, so the insertion code is inlined once.
  for (long long base = first;; base += (long long)kRounds * nthr) {
    const bool more = base < last;        // uniform across the CTA
    if (more) {
      int id[kRounds];
      bool valid[kRounds];
      unsigned mk[kRounds];
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        const long long i = base + r * nthr + t;
        id[r] = i < last ? ids[i] : -1;
        valid[r] = id[r] >= 0;
      }
      const int* cnt = knn_stream::rank_round(rk, parity, valid, mk);
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        if (valid[r]) {
          const int at = fill + cnt[r * nw + warp] + __popc(mk[r] & below);
          const long long p = id[r] < a.n_pts ? id[r] : a.n_pts - 1;
          const float px = a.points[p * 3 + 0], py = a.points[p * 3 + 1],
                      pz = a.points[p * 3 + 2];
          s_pt[at] = make_float4(px, py, pz, dot3(px, py, pz, px, py, pz));
          s_pos[at] = static_cast<int>(base + r * nthr + t);
        }
      }
      fill += rk.total;
    }
    // scan when only one more round fits, and at the end
    if (fill > nthr || (!more && fill > 0)) {
      knn_stream::pad_stage(s_pt, fill);
      __syncthreads();
      if (active)
        knn_stream::scan_stage<KMAX, kPass>(
            s_pt, s_pos, (fill + 3) & ~3, qx, qy, qz, qn, best, a.k, cap,
            lim, lo_d, lo_p);
      fill = 0;
    }
    if (!more) break;
  }
  // write the unit's rows, or merge into them under its lock
  knn_stream::finish_unit<KMAX, kPass>(
      a, best, unit, row, active, 1, a.nseg,
      [ids](int pos) { return ids[pos]; }, s_merged);
}

// Launches one instantiation, or with ``resident`` non-null only reports
// how many of its CTAs of ``block`` threads the card holds at once.
template <int KMAX, bool kMasked, bool kPass>
int run(const Args& a, int block, cudaStream_t stream, int* resident) {
  const size_t smem =
      (size_t)(kRounds + 1) * block * (sizeof(float4) + sizeof(int));
  auto kernel = knn_tile_kernel<KMAX, kMasked, kPass>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (resident != nullptr)
    return static_cast<int>(
        knn_stream::resident_ctas(kernel, block, smem, resident));
  kernel<<<a.n_units * a.nseg, block, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kMasked>
int run_k(const Args& a, bool pass, int block, cudaStream_t s,
          int* resident) {
  if (pass) return run<128, kMasked, true>(a, block, s, resident);
  if (a.k <= 8) return run<8, kMasked, false>(a, block, s, resident);
  if (a.k <= 32) return run<32, kMasked, false>(a, block, s, resident);
  return run<128, kMasked, false>(a, block, s, resident);
}

int dispatch(const Args& a, bool pass, int tile, int block, cudaStream_t s,
             int* resident) {
  if (a.k < 1 || a.k > 128 || block % 32 || block < a.rb_rows ||
      block > kMaxBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.n_rb == 1 && block == tile)
    return run_k<false>(a, pass, block, s, resident);
  return run_k<true>(a, pass, block, s, resident);
}

}  // namespace

// How many CTAs of the kernel that knn_tile_launch would run for these
// arguments the card holds at once (SM count x occupancy), into *out.
// Returns the first CUDA error: 0 on success.
extern "C" int knn_tile_resident(int tile, int rb_rows, int n_rb, int block,
                                 int k, int pass, int* out) {
  Args a{};
  a.k = k;
  a.rb_rows = rb_rows;
  a.n_rb = n_rb;
  return dispatch(a, pass != 0, tile, block, nullptr, out);
}

// Plain C entry point (bound with ctypes). Launches on ``stream`` and
// returns the first CUDA error of the set-up or the launch: 0 on success.
// Each tile of ``tile`` rows runs as ``n_rb`` units of ``rb_rows`` rows
// (CTAs of ``block`` threads, a multiple of 32, at most 256); ``block ==
// tile`` and ``n_rb == 1`` is the unmasked kernel. Each unit's ``m`` ids
// are ``nseg`` work items of ``seg`` ids (the last may hold fewer).
// ``sync`` is
// [2 * n_tiles * n_rb] int32 zeros: the locks and the merge counts. ``k``
// (at most 128) is this launch's list length and ``ld`` the output row
// length; with ``lo_d``/``lo_p`` non-null the launch is the pass that
// writes columns [col0, col0 + k).
extern "C" int knn_tile_launch(const float* q, const float* points,
                               const int* wnd_idx, int* sync, int n_tiles,
                               int tile, int rb_rows, int n_rb, int block,
                               int m, int seg, int nseg, int n_pts, int k,
                               int ld, int col0, int skip, float r2,
                               float* lo_d, int* lo_p, float* out_d2,
                               int* out_idx, void* stream) {
  if (n_tiles <= 0) return 0;
  const long long n_units = (long long)n_tiles * n_rb;
  if (seg < 1 || nseg < 1 || (long long)seg * nseg < m ||
      n_units * nseg >= (1ll << 31) ||
      (lo_d == nullptr && (ld != k || col0 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,       points, wnd_idx, sync, sync + n_units, out_d2,
               out_idx, static_cast<int>(n_units), n_pts, m, k, seg, nseg,
               skip != 0, r2, tile, rb_rows, n_rb, ld, col0, lo_d, lo_p};
  return dispatch(a, lo_d != nullptr, tile, block,
                  static_cast<cudaStream_t>(stream), nullptr);
}
