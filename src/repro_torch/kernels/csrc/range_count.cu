// Per-query count of window candidates within the radius, written for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/range_tile.py, range_count (Pallas body
// _range_count_kernel). For query tile i, each query counts the candidates
// j of wnd_pos[i, j] / wnd_idx[i, j] with wnd_idx >= 0 and
// d2 = max(|q|^2 + |p|^2 - 2 q.p, 0) <= r2.
//
// What bounds it on this card: each candidate is 16 B (12 B position, 4 B
// id) read once per tile and needs about ten FP32 operations per query of
// the tile; against the card's 3.35 TB/s and 67 TFLOP/s a tile of 256
// queries needs ~2560 operations per 16 B, so a full tile of valid
// candidates is bound by operations, while a stream of mostly invalid ids
// (empty grid slots) is bound by bytes. chip_smoke.py computes which from
// the run's data.
//
// What the design does about it: one CTA per query tile, one thread per
// query. Each chunk of candidates is read with coalesced loads and staged
// once per tile in shared memory, then read by every thread as a
// broadcast. The count of a query lives in a register of the one thread
// that owns it: no atomics, so it is exact and deterministic. The TPU
// kernel's lane-partial [TQ, 128] block and the wrapper's reduction are a
// TPU construct and are gone. A tile that is not a whole number of warps,
// or has more than 1024 rows, runs masked in row blocks of at most 1024
// (one CTA each): threads past the block's rows stage candidates with the
// others and write nothing.
//
// Exactness: the sums are taken x, y, z through __fmul_rn/__fadd_rn, as
// the plain PyTorch version in range_tile.py writes them, so the two agree.
#include "knn_stream.cuh"

namespace {

using knn_stream::dot3;
using knn_stream::kChunk;

// CTA b runs rows [r0, r0 + rows) of tile b / n_rb, r0 = (b % n_rb) *
// rb_rows (masked launch only).
template <bool kMasked>
__global__ void __launch_bounds__(1024) range_count_kernel(
    const float* __restrict__ q, const float* __restrict__ wnd_pos,
    const int* __restrict__ wnd_idx, int m, float r2, int tile_rows,
    int rb_rows, int n_rb, int* __restrict__ out) {
  __shared__ bool s_ok[kChunk];
  __shared__ float s_x[kChunk], s_y[kChunk], s_z[kChunk], s_n[kChunk];
  const int t = threadIdx.x;
  long long row = (long long)blockIdx.x * blockDim.x + t;
  long long tile = blockIdx.x;
  bool active = true;
  if constexpr (kMasked) {
    tile = blockIdx.x / n_rb;
    const int r0 = (blockIdx.x - static_cast<int>(tile) * n_rb) * rb_rows;
    active = t < min(rb_rows, tile_rows - r0);
    row = tile * tile_rows + r0 + t;
  }
  const long long tile_base = tile * m;
  const float qx = active ? q[row * 3 + 0] : 0.f;
  const float qy = active ? q[row * 3 + 1] : 0.f;
  const float qz = active ? q[row * 3 + 2] : 0.f;
  const float qn = dot3(qx, qy, qz, qx, qy, qz);
  int count = 0;
  for (int base = 0; base < m; base += kChunk) {
    for (int c = t; c < kChunk; c += blockDim.x) {
      const int cc = base + c;
      bool ok = false;
      float px = 0.f, py = 0.f, pz = 0.f;
      if (cc < m) {
        const long long j = tile_base + cc;
        ok = wnd_idx[j] >= 0;
        px = wnd_pos[j * 3 + 0];
        py = wnd_pos[j * 3 + 1];
        pz = wnd_pos[j * 3 + 2];
      }
      s_ok[c] = ok;
      s_x[c] = px;
      s_y[c] = py;
      s_z[c] = pz;
      s_n[c] = dot3(px, py, pz, px, py, pz);
    }
    __syncthreads();
    const int n_here = (kMasked && !active) ? 0 : min(kChunk, m - base);
    for (int j = 0; j < n_here; ++j) {
      if (!s_ok[j]) continue;
      const float d = knn_stream::sq_dist(
          qn, s_n[j], dot3(qx, qy, qz, s_x[j], s_y[j], s_z[j]));
      count += d <= r2;
    }
    __syncthreads();
  }
  if (active) out[row] = count;
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on ``stream`` and
// returns cudaGetLastError() of the launch: 0 on success. Each tile of
// ``tile`` rows runs as ``n_rb`` CTAs of ``block`` threads (a multiple of
// 32), ``rb_rows`` rows each; ``block == tile`` and ``n_rb == 1`` is the
// unmasked kernel.
extern "C" int range_count_launch(const float* q, const float* wnd_pos,
                                  const int* wnd_idx, int n_tiles, int tile,
                                  int rb_rows, int n_rb, int block, int m,
                                  float r2, int* out, void* stream) {
  if (n_tiles <= 0) return 0;
  if (block % 32 || block < rb_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rb == 1 && block == tile) {
    range_count_kernel<false><<<n_tiles, block, 0, s>>>(
        q, wnd_pos, wnd_idx, m, r2, tile, rb_rows, n_rb, out);
  } else {
    range_count_kernel<true><<<n_tiles * n_rb, block, 0, s>>>(
        q, wnd_pos, wnd_idx, m, r2, tile, rb_rows, n_rb, out);
  }
  return static_cast<int>(cudaGetLastError());
}
