// Streaming top-K over a caller-supplied candidate-id stream, written for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/knn_tile.py, knn_tile (Pallas body _knn_kernel
// with _stream_candidates, _merge_topk, _emit_best). Each query tile i
// streams the ids wnd_idx[i, 0..m) (-1 = invalid), in order, through an
// ascending per-query top-K of squared distances, dropping candidates
// beyond r2 unless the launch's skip_test flag is set.
//
// What bounds it on this card: as for knn_tile_anchored, the distance work
// (tile x valid candidates, about ten FP32 operations a pair) outweighs the
// bytes it must move (4 B an id, read once per tile, plus the points and
// the outputs), so the bound is operations; an invalid id costs a load and
// a branch but no arithmetic.
//
// What the design does about it: one CTA per query tile, one thread per
// query; each chunk of ids is read with coalesced loads and staged once per
// tile, together with the gathered positions, in shared memory
// (knn_stream.cuh), then read by every thread as a broadcast. The best-K
// lives in registers for k <= 32; k up to 128 spills to local memory.
// A larger k runs as passes of the 128 kernel (knn_stream.cuh), the wrapper
// launching one per 128 output columns; a tile that is not a whole number
// of warps, or has more than 1024 rows, runs masked in row blocks of at
// most 1024 (one CTA each, the tile's stream shared).
//
// Exactness and ties: the staging, distance, merge and emit are those of
// knn_tile_anchored.cu (knn_stream.cuh), so on the ids of an anchored window
// in window order the two kernels agree bitwise.
#include "knn_stream.cuh"

namespace {

struct StreamIds {
  const int* __restrict__ ids;     // this tile's row of wnd_idx

  __device__ __forceinline__ int operator()(int cc) const { return ids[cc]; }
};

// Row blocks and passes: CTA b runs rows [rb * rb_rows, ...) of tile
// b / n_rb; a pass writes columns [col0, col0 + k) of rows of ld entries.
struct Rows {
  int tile_rows, rb_rows, n_rb, ld, col0;
  float* lo_d;                     // [rows] last key of the pass before
  int* lo_p;
};

template <int KMAX, bool kMasked, bool kPass>
__global__ void __launch_bounds__(1024) knn_tile_kernel(
    const float* __restrict__ q, const float* __restrict__ points,
    const int* __restrict__ wnd_idx, int m, int n_pts, int k, bool skip,
    float r2, Rows rw, float* __restrict__ out_d2,
    int* __restrict__ out_idx) {
  __shared__ knn_stream::Chunk s;
  int tile = blockIdx.x;
  long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  bool active = true;
  if constexpr (kMasked) {
    tile = blockIdx.x / rw.n_rb;
    const int r0 = (blockIdx.x - tile * rw.n_rb) * rw.rb_rows;
    active = threadIdx.x < min(rw.rb_rows, rw.tile_rows - r0);
    row = (long long)tile * rw.tile_rows + r0 + threadIdx.x;
  }
  float best_d[KMAX];
  int best_i[KMAX];
  knn_stream::init(best_d, best_i);
  const StreamIds ids{wnd_idx + (long long)tile * m};
  const float qx = active ? q[row * 3 + 0] : 0.f;
  const float qy = active ? q[row * 3 + 1] : 0.f;
  const float qz = active ? q[row * 3 + 2] : 0.f;
  if constexpr (kPass) {
    const float lo_d = active ? rw.lo_d[row] : 0.f;
    const int lo_p = active ? rw.lo_p[row] : 0;
    knn_stream::stream_topk<KMAX, kMasked, true>(
        s, ids, m, points, n_pts, qx, qy, qz, skip, r2, k, best_d, best_i,
        active, lo_d, lo_p);
    if (!active) return;
    // positions back to ids; the last key goes to the next pass
#pragma unroll
    for (int e = 0; e < KMAX; ++e) {
      if (e < k) {
        const bool has = best_d[e] < knn_stream::kBig;
        out_d2[row * rw.ld + rw.col0 + e] = has ? best_d[e] : CUDART_INF_F;
        out_idx[row * rw.ld + rw.col0 + e] = has ? ids(best_i[e]) : -1;
      }
      if (e == k - 1) {
        rw.lo_d[row] = best_d[e];
        rw.lo_p[row] = best_i[e];
      }
    }
  } else {
    knn_stream::stream_topk<KMAX, kMasked>(s, ids, m, points, n_pts, qx, qy,
                                           qz, skip, r2, k, best_d, best_i,
                                           active);
    if (active) knn_stream::emit<KMAX>(best_d, best_i, k, row, out_d2,
                                       out_idx);
  }
}

template <int KMAX, bool kMasked, bool kPass>
void launch(dim3 grid, dim3 block, cudaStream_t s, const float* q,
            const float* points, const int* wnd_idx, int m, int n_pts, int k,
            bool skip, float r2, const Rows& rw, float* out_d2,
            int* out_idx) {
  knn_tile_kernel<KMAX, kMasked, kPass><<<grid, block, 0, s>>>(
      q, points, wnd_idx, m, n_pts, k, skip, r2, rw, out_d2, out_idx);
}

template <bool kMasked>
void launch_k(dim3 grid, dim3 block, cudaStream_t s, const float* q,
              const float* points, const int* wnd_idx, int m, int n_pts,
              int k, bool skip, float r2, const Rows& rw, float* out_d2,
              int* out_idx) {
  if (rw.lo_d != nullptr) {
    launch<128, kMasked, true>(grid, block, s, q, points, wnd_idx, m, n_pts,
                               k, skip, r2, rw, out_d2, out_idx);
  } else if (k <= 8) {
    launch<8, kMasked, false>(grid, block, s, q, points, wnd_idx, m, n_pts,
                              k, skip, r2, rw, out_d2, out_idx);
  } else if (k <= 32) {
    launch<32, kMasked, false>(grid, block, s, q, points, wnd_idx, m, n_pts,
                               k, skip, r2, rw, out_d2, out_idx);
  } else {
    launch<128, kMasked, false>(grid, block, s, q, points, wnd_idx, m,
                                n_pts, k, skip, r2, rw, out_d2, out_idx);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on ``stream`` and
// returns cudaGetLastError() of the launch: 0 on success. Each tile of
// ``tile`` rows runs as ``n_rb`` CTAs of ``block`` threads (a multiple of
// 32), ``rb_rows`` rows each; ``block == tile`` and ``n_rb == 1`` is the
// unmasked kernel. ``k`` (at most 128) is this launch's list length and
// ``ld`` the output row length; with ``lo_d``/``lo_p`` non-null the launch
// is pass col0 / 128 of a longer list (knn_stream.cuh).
extern "C" int knn_tile_launch(const float* q, const float* points,
                               const int* wnd_idx, int n_tiles, int tile,
                               int rb_rows, int n_rb, int block, int m,
                               int n_pts, int k, int ld, int col0, int skip,
                               float r2, float* lo_d, int* lo_p,
                               float* out_d2, int* out_idx, void* stream) {
  if (n_tiles <= 0) return 0;
  if (k < 1 || k > 128 || block % 32 || block < rb_rows ||
      (lo_d == nullptr && (ld != k || col0 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Rows rw{tile, rb_rows, n_rb, ld, col0, lo_d, lo_p};
  dim3 grid(n_tiles * n_rb), blk(block);
  if (n_rb == 1 && block == tile) {
    launch_k<false>(grid, blk, s, q, points, wnd_idx, m, n_pts, k,
                    skip != 0, r2, rw, out_d2, out_idx);
  } else {
    launch_k<true>(grid, blk, s, q, points, wnd_idx, m, n_pts, k, skip != 0,
                   r2, rw, out_d2, out_idx);
  }
  return static_cast<int>(cudaGetLastError());
}
