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

template <int KMAX>
__global__ void __launch_bounds__(1024) knn_tile_kernel(
    const float* __restrict__ q, const float* __restrict__ points,
    const int* __restrict__ wnd_idx, int m, int n_pts, int k, bool skip,
    float r2, float* __restrict__ out_d2, int* __restrict__ out_idx) {
  __shared__ knn_stream::Chunk s;
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float best_d[KMAX];
  int best_i[KMAX];
  knn_stream::init(best_d, best_i);
  const StreamIds ids{wnd_idx + (long long)blockIdx.x * m};
  knn_stream::stream_topk<KMAX>(s, ids, m, points, n_pts, q[row * 3 + 0],
                                q[row * 3 + 1], q[row * 3 + 2], skip, r2, k,
                                best_d, best_i);
  knn_stream::emit<KMAX>(best_d, best_i, k, row, out_d2, out_idx);
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on ``stream`` and
// returns cudaGetLastError() of the launch: 0 on success.
extern "C" int knn_tile_launch(const float* q, const float* points,
                               const int* wnd_idx, int n_tiles, int tile,
                               int m, int n_pts, int k, int skip, float r2,
                               float* out_d2, int* out_idx, void* stream) {
  if (n_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(n_tiles), block(tile);
  if (k <= 8) {
    knn_tile_kernel<8><<<grid, block, 0, s>>>(q, points, wnd_idx, m, n_pts,
                                              k, skip != 0, r2, out_d2,
                                              out_idx);
  } else if (k <= 32) {
    knn_tile_kernel<32><<<grid, block, 0, s>>>(q, points, wnd_idx, m, n_pts,
                                               k, skip != 0, r2, out_d2,
                                               out_idx);
  } else {
    knn_tile_kernel<128><<<grid, block, 0, s>>>(q, points, wnd_idx, m,
                                                n_pts, k, skip != 0, r2,
                                                out_d2, out_idx);
  }
  return static_cast<int>(cudaGetLastError());
}
