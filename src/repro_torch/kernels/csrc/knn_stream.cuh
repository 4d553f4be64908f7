// The streaming top-K of knn_tile.cu: the staging of a chunk of candidates
// in shared memory, the squared distance, the merge into a per-query
// ascending best-K and the emit. knn_tile_anchored.cu stages, splits and
// merges its own way but shares the distance (dot3, sq_dist), the sentinel
// and the insertion rule, so on the same ids the two agree bitwise: the
// reference's contract between its knn_tile_anchored and knn_tile
// (src/repro/kernels/knn_tile.py, _stream_candidates, _merge_topk and
// _emit_best).
//
// Exactness: d2 = max(qn + pn - 2*cross, 0) with each sum taken x, y, z in
// that order through __fmul_rn/__fadd_rn, so nvcc cannot contract it into
// FMAs; the plain PyTorch versions in knn_tile.py do the same elementwise
// ops. A candidate enters the list only when strictly less than the current
// k-th best, so ties keep the earlier window position: the reference merge's
// rule, and the order of a stable sort over the whole window.
//
// Beyond the list length the kernels are built for (128) a launch is one
// pass of several: the list holds stream positions, pass p keeps only the
// candidates whose key (d2, position) lies after the last key of pass p - 1
// (lo_d, lo_p, carried per query in scratch), and writes output columns
// [col0, col0 + k). The key order is total, so the passes compose into the
// one-stream result. A tile that is not a whole number of warps, or that is
// split into row blocks, runs masked: threads past the block's rows stage
// candidates with the others but keep no list and write nothing.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace knn_stream {

constexpr int kChunk = 512;       // candidates staged per shared-memory pass
constexpr float kBig = 3.4e38f;   // "empty" distance; emitted as +inf

__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      float bx, float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

// max(qn + pn - 2 * cross, 0), in this order of operations.
__device__ __forceinline__ float sq_dist(float qn, float pn, float cross) {
  const float d = __fsub_rn(__fadd_rn(qn, pn), __fmul_rn(2.f, cross));
  return d > 0.f ? d : 0.f;
}

// One chunk of candidates, staged once per CTA and read by every thread.
struct Chunk {
  int id[kChunk];
  float x[kChunk], y[kChunk], z[kChunk], n[kChunk];
};

template <int KMAX>
__device__ __forceinline__ void init(float (&best_d)[KMAX],
                                     int (&best_i)[KMAX]) {
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    best_d[j] = kBig;
    best_i[j] = -1;
  }
}

// Whether the key (d, p) comes after (lo_d, lo_p): a later pass's filter.
__device__ __forceinline__ bool after(float d, int p, float lo_d, int lo_p) {
  return d > lo_d || (d == lo_d && p > lo_p);
}

// Streams the m candidates of one tile through every thread's fresh best-K
// (as init leaves it). ``ids(cc)`` is the candidate id at window position cc
// (-1 = empty); a valid id gathers its position with the id clipped to
// [0, n_pts - 1], as the reference does. Every thread of the CTA must call
// this together. kMasked: only ``active`` threads keep a list. kPass: the
// list keeps window positions (not ids) of the candidates after (lo_d,
// lo_p).
template <int KMAX, bool kMasked = false, bool kPass = false, class Ids>
__device__ __forceinline__ void stream_topk(
    Chunk& s, const Ids& ids, int m, const float* __restrict__ points,
    int n_pts, float qx, float qy, float qz, bool skip, float r2, int k,
    float (&best_d)[KMAX], int (&best_i)[KMAX], bool active = true,
    float lo_d = 0.f, int lo_p = 0) {
  const int t = threadIdx.x;
  const float qn = dot3(qx, qy, qz, qx, qy, qz);
  float worst = kBig;               // best_d[k - 1]
  for (int base = 0; base < m; base += kChunk) {
    for (int c = t; c < kChunk; c += blockDim.x) {
      const int cc = base + c;
      const int id = cc < m ? ids(cc) : -1;
      float px = 0.f, py = 0.f, pz = 0.f, pn = 0.f;
      if (id >= 0) {
        const long long p = id < n_pts ? id : n_pts - 1;
        px = points[p * 3 + 0];
        py = points[p * 3 + 1];
        pz = points[p * 3 + 2];
        pn = dot3(px, py, pz, px, py, pz);
      }
      s.id[c] = id;
      s.x[c] = px;
      s.y[c] = py;
      s.z[c] = pz;
      s.n[c] = pn;
    }
    __syncthreads();
    const int n_here = (kMasked && !active) ? 0 : min(kChunk, m - base);
    for (int j = 0; j < n_here; ++j) {
      int id = s.id[j];
      if (id < 0) continue;
      const float d =
          sq_dist(qn, s.n[j], dot3(qx, qy, qz, s.x[j], s.y[j], s.z[j]));
      if (!skip && d > r2) continue;
      if constexpr (kPass) {
        id = base + j;                    // the list keeps positions
        if (!after(d, id, lo_d, lo_p)) continue;
      }
      if (!(d < worst)) continue;
      // insert after every held entry <= d (strictly-less rule)
#pragma unroll
      for (int e = KMAX - 1; e > 0; --e) {
        if (e < k) {
          if (d < best_d[e - 1]) {
            best_d[e] = best_d[e - 1];
            best_i[e] = best_i[e - 1];
          } else if (d < best_d[e]) {
            best_d[e] = d;
            best_i[e] = id;
          }
        }
      }
      if (d < best_d[0]) {
        best_d[0] = d;
        best_i[0] = id;
      }
#pragma unroll
      for (int e = 0; e < KMAX; ++e) {
        if (e == k - 1) worst = best_d[e];
      }
    }
    __syncthreads();
  }
}

// Writes one query's row: ascending d2 (+inf where empty) and ids (-1).
template <int KMAX>
__device__ __forceinline__ void emit(const float (&best_d)[KMAX],
                                     const int (&best_i)[KMAX], int k,
                                     long long row, float* __restrict__ out_d2,
                                     int* __restrict__ out_idx) {
#pragma unroll
  for (int e = 0; e < KMAX; ++e) {
    if (e < k) {
      out_d2[row * k + e] = best_d[e] >= kBig ? CUDART_INF_F : best_d[e];
      out_idx[row * k + e] = best_i[e];
    }
  }
}

}  // namespace knn_stream
