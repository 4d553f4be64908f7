// Fused window gather -> squared distance -> streaming top-K for the
// level-segmented query path, written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/knn_tile.py, knn_tile_anchored (Pallas body
// _knn_anchored_kernel with _stream_candidates, _merge_topk, _emit_best).
// It computes what that kernel computes, for every level in ONE launch:
// each query tile reads its level, looks up its window size and sphere-test
// flag in a small table, derives candidate ids from its anchor by index
// arithmetic on the flattened dense grid, and streams them, in window
// order, through an ascending per-query top-K.
//
// What bounds it on this card: the distance work, tile x m pairs of about
// ten FP32 operations each, is far larger than the bytes it must move (the
// points, the dense grid, the queries and the outputs, each once), so the
// bound is operations. Most of the stream is empty grid slots, though: a
// slot that holds -1 costs a load and a branch but no arithmetic.
//
// What the design does about it: one CTA per query tile, one thread per
// query. Each chunk of candidate ids and positions is staged once in shared
// memory by the whole CTA (coalesced loads of the dense grid) and then read
// by every thread as a broadcast, so a candidate is fetched once per tile,
// not once per query; the empty-slot test is uniform across a warp, so it
// does not diverge. The best-K list lives in registers for k <= 32 (the
// main path uses k = 8); k up to 128 spills to local memory.
//
// Exactness and ties: see knn_stream.cuh, which this kernel shares with
// knn_tile.cu (the id-stream variant), so the two agree bitwise on the same
// candidates.
#include "knn_stream.cuh"

namespace {

// Candidate id at window position cc of a tile anchored at (ax, ay, az):
// (window cell, slot) -> global cell -> flattened dense grid, clipped.
struct AnchoredIds {
  const int* __restrict__ dense;
  int n_flat, ax, ay, az, wy, wz, dy, dz, cap;

  __device__ __forceinline__ int operator()(int cc) const {
    const int slot = cc % cap;
    const int cell = cc / cap;
    const int iz = cell % wz;
    const int iy = (cell / wz) % wy;
    const int ix = cell / (wz * wy);
    long long flat =
        (((long long)(ax + ix) * dy + (ay + iy)) * dz + (az + iz)) * cap +
        slot;
    flat = flat < 0 ? 0 : (flat >= n_flat ? n_flat - 1 : flat);
    return dense[flat];
  }
};

template <int KMAX>
__global__ void __launch_bounds__(1024) knn_tile_anchored_kernel(
    const float* __restrict__ q, const float* __restrict__ points,
    const int* __restrict__ dense, const int* __restrict__ anchors,
    const int* __restrict__ levels, const int* __restrict__ table,
    int n_entries, int n_pts, int n_flat, int dy, int dz, int cap, int k,
    float r2, float* __restrict__ out_d2, int* __restrict__ out_idx) {
  __shared__ knn_stream::Chunk s;
  const int tile_id = blockIdx.x;
  const long long row = (long long)tile_id * blockDim.x + threadIdx.x;
  float best_d[KMAX];
  int best_i[KMAX];
  knn_stream::init(best_d, best_i);

  const int lvl = levels[tile_id];
  if (lvl >= 0 && lvl < n_entries) {      // uniform across the CTA
    const int wx = table[lvl * 4 + 0];
    const int wy = table[lvl * 4 + 1];
    const int wz = table[lvl * 4 + 2];
    const bool skip = table[lvl * 4 + 3] != 0;
    const AnchoredIds ids{dense, n_flat, anchors[tile_id * 3 + 0],
                          anchors[tile_id * 3 + 1], anchors[tile_id * 3 + 2],
                          wy, wz, dy, dz, cap};
    const int m = wx * wy * wz * cap;     // < n_flat < 2^31 (checked)
    knn_stream::stream_topk<KMAX>(s, ids, m, points, n_pts, q[row * 3 + 0],
                                  q[row * 3 + 1], q[row * 3 + 2], skip, r2, k,
                                  best_d, best_i);
  }
  // off-level tiles emit the neutral (inf, -1) rows
  knn_stream::emit<KMAX>(best_d, best_i, k, row, out_d2, out_idx);
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on ``stream`` and
// returns cudaGetLastError() of the launch: 0 on success.
extern "C" int knn_tile_anchored_launch(
    const float* q, const float* points, const int* dense,
    const int* anchors, const int* levels, const int* table, int n_entries,
    int n_tiles, int tile, int n_pts, int n_flat, int dy, int dz, int cap,
    int k, float r2, float* out_d2, int* out_idx, void* stream) {
  if (n_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(n_tiles), block(tile);
  if (k <= 8) {
    knn_tile_anchored_kernel<8><<<grid, block, 0, s>>>(
        q, points, dense, anchors, levels, table, n_entries, n_pts, n_flat,
        dy, dz, cap, k, r2, out_d2, out_idx);
  } else if (k <= 32) {
    knn_tile_anchored_kernel<32><<<grid, block, 0, s>>>(
        q, points, dense, anchors, levels, table, n_entries, n_pts, n_flat,
        dy, dz, cap, k, r2, out_d2, out_idx);
  } else {
    knn_tile_anchored_kernel<128><<<grid, block, 0, s>>>(
        q, points, dense, anchors, levels, table, n_entries, n_pts, n_flat,
        dy, dz, cap, k, r2, out_d2, out_idx);
  }
  return static_cast<int>(cudaGetLastError());
}
