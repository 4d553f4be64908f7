// What the knn kernels share: the distance, the per-query best-K, the
// compaction of a round of candidates into shared memory, the scan of the
// compacted candidates, and the order-free merge of partial top-Ks. Used by
// knn_tile_anchored.cu (ids derived from a window anchor), knn_tile.cu (a
// caller-supplied id stream) and, for the distance and the compaction,
// range_count.cu. On the same candidates in the same order the knn kernels
// agree bitwise: the reference's contract between its knn_tile_anchored
// and knn_tile (src/repro/kernels/knn_tile.py, _stream_candidates,
// _merge_topk and _emit_best).
//
// Exactness: d2 = max(qn + pn - 2*cross, 0) with each sum taken x, y, z in
// that order through __fmul_rn/__fadd_rn, so nvcc cannot contract it into
// FMAs; the plain PyTorch versions do the same elementwise ops. A list is
// ordered by the key (d2, stream position): streamed in position order,
// a candidate enters only when strictly less than entry k - 1 (ties keep
// the earlier position, the reference merge's rule and the order of a
// stable sort), and two partial lists merge by the same key in any order.
//
// Beyond the list length the kernels are built for (128) a launch is one
// pass of several: pass p keeps only the candidates whose key lies after
// the last key of pass p - 1 (lo_d, lo_p, carried per query in scratch),
// and writes output columns [col0, col0 + k). The key order is total, so
// the passes compose into the one-stream result.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace knn_stream {

constexpr float kBig = 3.4e38f;     // "empty" distance; emitted as +inf
constexpr int kRounds = 4;          // ids per thread per compaction round
constexpr unsigned kAll = 0xffffffffu;

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

// Whether the key (d, p) comes after (lo_d, lo_p): a later pass's filter.
__device__ __forceinline__ bool after(float d, int p, float lo_d, int lo_p) {
  return d > lo_d || (d == lo_d && p > lo_p);
}

__device__ __forceinline__ bool before(float d, int p, float bd, int bp) {
  return d < bd || (d == bd && p < bp);
}

// One query's best-K, ascending by the key (d2, stream position), with the
// entry k - 1 that a new candidate must go before. Up to 8 entries stay in
// registers (unrolled, constant indices); a longer list lives in local
// memory, and `held` (the entries that are not empty) bounds its shifts.
template <int KMAX>
struct Best {
  float d[KMAX];
  int p[KMAX];
  int held;
  float worst;
  int worst_p;

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int e = 0; e < KMAX; ++e) {
      d[e] = kBig;
      p[e] = -1;
    }
    held = 0;
    worst = kBig;
    worst_p = -1;
  }

  // Inserts (nd, np), which the caller has checked goes before entry
  // k - 1; that entry drops out. Streamed in position order this is the
  // strictly-less rule, and it merges two partial lists as well.
  __device__ __forceinline__ void insert(int k, float nd, int np) {
    if constexpr (KMAX <= 8) {
#pragma unroll
      for (int e = KMAX - 1; e > 0; --e) {
        if (e < k) {
          if (before(nd, np, d[e - 1], p[e - 1])) {
            d[e] = d[e - 1];
            p[e] = p[e - 1];
          } else if (before(nd, np, d[e], p[e])) {
            d[e] = nd;
            p[e] = np;
          }
        }
      }
      if (before(nd, np, d[0], p[0])) {
        d[0] = nd;
        p[0] = np;
      }
#pragma unroll
      for (int e = 0; e < KMAX; ++e) {
        if (e == k - 1) {
          worst = d[e];
          worst_p = p[e];
        }
      }
    } else {
      int e = held < k ? held : k - 1;  // entries from `held` on are empty
      for (; e > 0 && before(nd, np, d[e - 1], p[e - 1]); --e) {
        d[e] = d[e - 1];
        p[e] = p[e - 1];
      }
      d[e] = nd;
      p[e] = np;
      held += held < k;
      if (held == k) {
        worst = d[k - 1];
        worst_p = p[k - 1];
      }
    }
  }
};

// Warp 0 turns v[0..n) into its exclusive prefix sums, in place, and
// writes the sum to *total.
__device__ __forceinline__ void warp_exclusive_scan(int* v, int n,
                                                    int* total) {
  const int lane = threadIdx.x & 31;
  const int per = (n + 31) / 32;
  const int lo = min(lane * per, n), hi = min(lo + per, n);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += v[i];
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kAll, incl, o);
    if (lane >= o) incl += y;
  }
  int run = incl - sum;
  for (int i = lo; i < hi; ++i) {
    const int x = v[i];
    v[i] = run;
    run += x;
  }
  if (lane == 31) *total = incl;
}

// The shared-memory counts of a compaction round: per (round, warp), two
// rounds in flight, and the round's total.
struct Ranks {
  int cnt[2][kRounds * 32];
  int total;
};

// Warp ballots of a round's flags, then warp 0 scans the per-warp counts:
// a flagged thread's rank in stream order is cnt[r * nw + warp] plus its
// lane's rank in mk[r], and rk.total is the round's count. Rounds take the
// two count buffers in turn, so a round may start while the threads of
// the one before still read theirs.
__device__ __forceinline__ const int* rank_round(
    Ranks& rk, int& parity, const bool (&flag)[kRounds],
    unsigned (&mk)[kRounds]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int* cnt = rk.cnt[parity];
  parity ^= 1;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    mk[r] = __ballot_sync(kAll, flag[r]);
    if (lane == 0) cnt[r * nw + warp] = __popc(mk[r]);
  }
  __syncthreads();
  if (warp == 0) warp_exclusive_scan(cnt, kRounds * nw, &rk.total);
  __syncthreads();
  return cnt;
}

// Fills the stage up to a multiple of 4 with candidates no query takes:
// at |p|^2 = +inf the distance is +inf. (The stage holds a multiple of 4.)
__device__ __forceinline__ void pad_stage(float4* s_pt, int fill) {
  const int t = threadIdx.x;
  if (t < ((fill + 3) & ~3) - fill)
    s_pt[fill + t] = make_float4(0.f, 0.f, 0.f, CUDART_INF_F);
}

// Every query against the n staged candidates (n a multiple of 4), in
// stream order, four at a time: independent distances and one test on
// their unclamped minimum (clamping at 0 only raises a value); on the rare
// hit the four are taken again one by one, so the list is inserted into
// at one place in the code (more copies push the list out of registers).
// ``lim`` is what a candidate's d2 must stay under: the lesser of entry
// k - 1's and ``cap`` (the least float above r2, as d <= r2 iff d < it, or
// kBig where the sphere test is skipped).
// kPass: only keys after (lo_d, lo_p) count, and the cheap test is taken on
// the clamped distances, at least lo_d and under ``lim``.
template <int KMAX, bool kPass = false>
__device__ __forceinline__ void scan_stage(const float4* s_pt,
                                           const int* s_pos, int n, float qx,
                                           float qy, float qz, float qn,
                                           Best<KMAX>& b, int k, float cap,
                                           float& lim, float lo_d = 0.f,
                                           int lo_p = 0) {
  for (int j = 0; j < n; j += 4) {
    float d[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 c = s_pt[j + u];
      d[u] = __fsub_rn(__fadd_rn(qn, c.w),
                       __fmul_rn(2.f, dot3(qx, qy, qz, c.x, c.y, c.z)));
    }
    bool hit;
    if constexpr (kPass) {
      hit = false;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float du = fmaxf(d[u], 0.f);
        hit |= du >= lo_d && du < lim;
      }
    } else {
      hit = fminf(fminf(d[0], d[1]), fminf(d[2], d[3])) < lim;
    }
    if (hit) {
#pragma unroll 1
      for (int u = 0; u < 4; ++u) {
        const float4 c = s_pt[j + u];
        const float du = sq_dist(qn, c.w, dot3(qx, qy, qz, c.x, c.y, c.z));
        if (du < lim && (!kPass || after(du, s_pos[j + u], lo_d, lo_p))) {
          b.insert(k, du, s_pos[j + u]);
          lim = fminf(b.worst, cap);
        }
      }
    }
  }
}

// Writes one query's final row: ascending d2 (+inf where empty) and the
// ids ``id_of(position)`` (-1 where empty). A pass also leaves its last
// key, where the next pass starts. ``A`` holds the launch's outputs: k
// (this launch's list length), ld and col0 (a pass writes columns
// [col0, col0 + k) of rows of ld), out_d2, out_idx, lo_d and lo_p.
template <int KMAX, bool kPass, class A, class Ids>
__device__ __forceinline__ void emit_final(const Best<KMAX>& b,
                                           long long row, const Ids& id_of,
                                           const A& a) {
  const int k = a.k;
  const int ld = kPass ? a.ld : k;
  const int col0 = kPass ? a.col0 : 0;
#pragma unroll
  for (int e = 0; e < KMAX; ++e) {
    if (e < k) {
      const bool has = b.d[e] < kBig;
      a.out_d2[row * ld + col0 + e] = has ? b.d[e] : CUDART_INF_F;
      a.out_idx[row * ld + col0 + e] = has ? id_of(b.p[e]) : -1;
    }
  }
  if constexpr (kPass) {                 // the next pass starts after it
    a.lo_d[row] = b.d[k - 1];
    a.lo_p[row] = b.p[k - 1];
  }
}

// Ends a run that streamed ``covered`` of its unit's ``nseg`` work items
// into ``best``. A run that covers the whole unit writes its rows. Else,
// under the unit's lock (a.locks[unit], with a.merged[unit] the items
// merged so far, both zeroed before the launch), it merges its list by
// the key (d2, position) into the unit's rows of the outputs themselves
// (d2, and the position in place of the id), and the run that completes
// the unit writes the final rows. The result is bitwise the one-stream
// result, ties included, in whatever order runs finish. Every thread of
// the CTA calls this together; ``s_merged`` is a shared int.
template <int KMAX, bool kPass, class A, class Ids>
__device__ __forceinline__ void finish_unit(const A& a, Best<KMAX>& best,
                                            int unit, long long row,
                                            bool active, int covered,
                                            int nseg, const Ids& id_of,
                                            int& s_merged) {
  if (covered == nseg) {                  // the whole stream: write it
    if (active) emit_final<KMAX, kPass>(best, row, id_of, a);
    __syncthreads();
    return;
  }
  if (threadIdx.x == 0) {
    while (atomicCAS(a.locks + unit, 0, 1) != 0) __nanosleep(64);
    __threadfence();
    s_merged = *reinterpret_cast<volatile int*>(a.merged + unit);
  }
  __syncthreads();
  const int merged = s_merged;
  const int ld = kPass ? a.ld : a.k;
  const int col0 = kPass ? a.col0 : 0;
  float* rd = a.out_d2 + row * ld + col0;
  int* rp = a.out_idx + row * ld + col0;
  if (active && merged > 0) {
    for (int e = 0; e < a.k; ++e) {       // the held rows, ascending
      const float gd = __ldcg(rd + e);
      const int gp = __ldcg(rp + e);
      if (!before(gd, gp, best.worst, best.worst_p)) break;
      best.insert(a.k, gd, gp);
    }
  }
  if (!active) {
  } else if (merged + covered == nseg) {
    emit_final<KMAX, kPass>(best, row, id_of, a);
  } else {
#pragma unroll
    for (int e = 0; e < KMAX; ++e) {
      if (e < a.k) {
        __stcg(rd + e, best.d[e]);
        __stcg(rp + e, best.p[e]);
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    *reinterpret_cast<volatile int*>(a.merged + unit) = merged + covered;
    __threadfence();
    atomicExch(a.locks + unit, 0);
  }
  __syncthreads();
}

// Host side: how many CTAs of ``block`` threads and ``smem`` bytes of
// dynamic shared memory of ``kernel`` the current card holds at once (its
// SM count times the kernel's occupancy), into *out.
template <class Kernel>
cudaError_t resident_ctas(Kernel kernel, int block, size_t smem, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        block, smem);
  *out = sms * per_sm;
  return err;
}

}  // namespace knn_stream
