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
// TPU construct and are gone.
//
// Exactness: the sums are taken x, y, z through __fmul_rn/__fadd_rn, as
// the plain PyTorch version in range_tile.py writes them, so the two agree.
#include "knn_stream.cuh"

namespace {

using knn_stream::dot3;
using knn_stream::kChunk;

__global__ void __launch_bounds__(1024) range_count_kernel(
    const float* __restrict__ q, const float* __restrict__ wnd_pos,
    const int* __restrict__ wnd_idx, int m, float r2,
    int* __restrict__ out) {
  __shared__ bool s_ok[kChunk];
  __shared__ float s_x[kChunk], s_y[kChunk], s_z[kChunk], s_n[kChunk];
  const int t = threadIdx.x;
  const long long row = (long long)blockIdx.x * blockDim.x + t;
  const long long tile_base = (long long)blockIdx.x * m;
  const float qx = q[row * 3 + 0];
  const float qy = q[row * 3 + 1];
  const float qz = q[row * 3 + 2];
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
    const int n_here = min(kChunk, m - base);
    for (int j = 0; j < n_here; ++j) {
      if (!s_ok[j]) continue;
      const float d = knn_stream::sq_dist(
          qn, s_n[j], dot3(qx, qy, qz, s_x[j], s_y[j], s_z[j]));
      count += d <= r2;
    }
    __syncthreads();
  }
  out[row] = count;
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on ``stream`` and
// returns cudaGetLastError() of the launch: 0 on success.
extern "C" int range_count_launch(const float* q, const float* wnd_pos,
                                  const int* wnd_idx, int n_tiles, int tile,
                                  int m, float r2, int* out, void* stream) {
  if (n_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  range_count_kernel<<<n_tiles, tile, 0, s>>>(q, wnd_pos, wnd_idx, m, r2,
                                              out);
  return static_cast<int>(cudaGetLastError());
}
