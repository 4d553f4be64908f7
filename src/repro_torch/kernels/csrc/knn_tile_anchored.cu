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
// Exactness: d2 = max(qn + pn - 2*cross, 0) with each sum taken x, y, z
// in that order through __fmul_rn/__fadd_rn, so nvcc cannot contract it
// into FMAs; the plain PyTorch version in knn_tile.py does the same
// elementwise ops and the two agree bitwise. A candidate enters the list
// only when strictly less than the current k-th best, so ties keep the
// earlier window position: the reference merge's rule.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kChunk = 512;       // candidates staged per shared-memory pass
constexpr float kBig = 3.4e38f;   // "empty" distance; emitted as +inf

__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      float bx, float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

template <int KMAX>
__global__ void __launch_bounds__(1024) knn_tile_anchored_kernel(
    const float* __restrict__ q, const float* __restrict__ points,
    const int* __restrict__ dense, const int* __restrict__ anchors,
    const int* __restrict__ levels, const int* __restrict__ table,
    int n_entries, int n_pts, int n_flat, int dy, int dz, int cap, int k,
    float r2, float* __restrict__ out_d2, int* __restrict__ out_idx) {
  __shared__ int s_id[kChunk];
  __shared__ float s_x[kChunk], s_y[kChunk], s_z[kChunk], s_n[kChunk];

  const int tile_id = blockIdx.x;
  const int t = threadIdx.x;
  const long long row = (long long)tile_id * blockDim.x + t;

  float best_d[KMAX];
  int best_i[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    best_d[j] = kBig;
    best_i[j] = -1;
  }
  float worst = kBig;             // best_d[k - 1]

  const int lvl = levels[tile_id];
  if (lvl >= 0 && lvl < n_entries) {      // uniform across the CTA
    const int wx = table[lvl * 4 + 0];
    const int wy = table[lvl * 4 + 1];
    const int wz = table[lvl * 4 + 2];
    const bool skip = table[lvl * 4 + 3] != 0;
    const int ax = anchors[tile_id * 3 + 0];
    const int ay = anchors[tile_id * 3 + 1];
    const int az = anchors[tile_id * 3 + 2];
    const int m = wx * wy * wz * cap;     // < n_flat < 2^31 (checked)
    const float qx = q[row * 3 + 0];
    const float qy = q[row * 3 + 1];
    const float qz = q[row * 3 + 2];
    const float qn = dot3(qx, qy, qz, qx, qy, qz);

    for (int base = 0; base < m; base += kChunk) {
      // stage: candidate id from the anchor, then its position
      for (int c = t; c < kChunk; c += blockDim.x) {
        const int cc = base + c;
        int id = -1;
        if (cc < m) {
          const int slot = cc % cap;
          const int cell = cc / cap;
          const int iz = cell % wz;
          const int iy = (cell / wz) % wy;
          const int ix = cell / (wz * wy);
          long long flat =
              (((long long)(ax + ix) * dy + (ay + iy)) * dz + (az + iz)) *
                  cap + slot;
          flat = flat < 0 ? 0 : (flat >= n_flat ? n_flat - 1 : flat);
          id = dense[flat];
        }
        float px = 0.f, py = 0.f, pz = 0.f, pn = 0.f;
        if (id >= 0) {
          const long long p = id < n_pts ? id : n_pts - 1;
          px = points[p * 3 + 0];
          py = points[p * 3 + 1];
          pz = points[p * 3 + 2];
          pn = dot3(px, py, pz, px, py, pz);
        }
        s_id[c] = id;
        s_x[c] = px;
        s_y[c] = py;
        s_z[c] = pz;
        s_n[c] = pn;
      }
      __syncthreads();
      const int n_here = min(kChunk, m - base);
      for (int j = 0; j < n_here; ++j) {
        const int id = s_id[j];
        if (id < 0) continue;
        const float cross = dot3(qx, qy, qz, s_x[j], s_y[j], s_z[j]);
        float d = __fsub_rn(__fadd_rn(qn, s_n[j]), __fmul_rn(2.f, cross));
        d = d > 0.f ? d : 0.f;
        if (!skip && d > r2) continue;
        if (!(d < worst)) continue;
        // insert after every held entry <= d (strictly-less rule)
#pragma unroll
        for (int s = KMAX - 1; s > 0; --s) {
          if (s < k) {
            if (d < best_d[s - 1]) {
              best_d[s] = best_d[s - 1];
              best_i[s] = best_i[s - 1];
            } else if (d < best_d[s]) {
              best_d[s] = d;
              best_i[s] = id;
            }
          }
        }
        if (d < best_d[0]) {
          best_d[0] = d;
          best_i[0] = id;
        }
#pragma unroll
        for (int s = 0; s < KMAX; ++s) {
          if (s == k - 1) worst = best_d[s];
        }
      }
      __syncthreads();
    }
  }
  // emit; off-level tiles emit the neutral (inf, -1) rows
#pragma unroll
  for (int s = 0; s < KMAX; ++s) {
    if (s < k) {
      out_d2[row * k + s] = best_d[s] >= kBig ? CUDART_INF_F : best_d[s];
      out_idx[row * k + s] = best_i[s];
    }
  }
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
