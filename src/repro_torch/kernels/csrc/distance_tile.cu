// Pairwise squared distances d2[i, j] = max(|q_i|^2 + |p_j|^2 - 2 q_i.p_j, 0)
// of q [Nq, 3] and p [Np, 3] in float32 or bfloat16, written for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/distance_tile.py, distance_tile (Pallas body
// _distance_kernel). Inputs are converted to float32 before any arithmetic,
// as the reference wrapper does; the output is [Nq, Np] float32.
//
// What bounds it on this card: the bytes written, 4 B a pair; the inputs
// are 12 B (or 6 B) a point and stay in L2, and a pair needs about ten FP32
// operations, under the card's 20 operations a byte. Tensor cores do not
// apply: the contraction depth is 3, and TF32 would break the float32
// parity with the plain version.
//
// What the design does about it: each thread owns four neighbouring
// columns and writes them with one 16-byte store per row (a warp writes
// 512 contiguous bytes), for kRows rows, so it reads its four points and
// computes their |p|^2 once per kRows rows. Offsets are 64-bit: Nq * Np
// passes 2^31 at the sizes chip_smoke.py runs. When Np is not a multiple of
// 4 a row does not start 16-byte aligned, and the kernel stores scalars.
//
// Exactness: the sums are taken x, y, z through __fmul_rn/__fadd_rn and the
// clamp follows, as the plain PyTorch version in distance_tile.py (ref's
// pairwise_d2) writes them, so the two agree bitwise.
#include <cuda_bf16.h>

#include "knn_stream.cuh"

namespace {

using knn_stream::dot3;

constexpr int kCols = 4;      // columns per thread: one 16-byte store
constexpr int kRows = 8;      // rows per thread
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads) distance_tile_kernel(
    const T* __restrict__ q, const T* __restrict__ p, int nq, int np,
    float* __restrict__ out) {
  const long long j0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * kCols;
  if (j0 >= np) return;
  float px[kCols], py[kCols], pz[kCols], pn[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const long long j = j0 + c < np ? j0 + c : np - 1;
    px[c] = to_f32(p[j * 3 + 0]);
    py[c] = to_f32(p[j * 3 + 1]);
    pz[c] = to_f32(p[j * 3 + 2]);
    pn[c] = dot3(px[c], py[c], pz[c], px[c], py[c], pz[c]);
  }
  for (int i0 = blockIdx.y * kRows; i0 < nq; i0 += gridDim.y * kRows) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;
      if (i >= nq) break;
      const float qx = to_f32(q[(long long)i * 3 + 0]);
      const float qy = to_f32(q[(long long)i * 3 + 1]);
      const float qz = to_f32(q[(long long)i * 3 + 2]);
      const float qn = dot3(qx, qy, qz, qx, qy, qz);
      float d[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        d[c] = knn_stream::sq_dist(
            qn, pn[c], dot3(qx, qy, qz, px[c], py[c], pz[c]));
      }
      float* row = out + (long long)i * np + j0;
      if (kVec) {
        *reinterpret_cast<float4*>(row) = make_float4(d[0], d[1], d[2], d[3]);
      } else {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          if (j0 + c < np) row[c] = d[c];
        }
      }
    }
  }
}

template <typename T>
int launch(const T* q, const T* p, int nq, int np, float* out,
           cudaStream_t s) {
  const int col_blocks = (np + kCols * kThreads - 1) / (kCols * kThreads);
  const int row_blocks = (nq + kRows - 1) / kRows;
  dim3 grid(col_blocks, row_blocks < 65535 ? row_blocks : 65535);
  if (np % kCols == 0) {
    distance_tile_kernel<T, true><<<grid, kThreads, 0, s>>>(q, p, nq, np,
                                                            out);
  } else {
    distance_tile_kernel<T, false><<<grid, kThreads, 0, s>>>(q, p, nq, np,
                                                             out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). ``bf16`` selects bfloat16 inputs
// (else float32); ``out`` is 16-byte aligned. Launches on ``stream`` and
// returns cudaGetLastError() of the launch: 0 on success.
extern "C" int distance_tile_launch(const void* q, const void* p, int nq,
                                    int np, int bf16, float* out,
                                    void* stream) {
  if (nq <= 0 || np <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch(static_cast<const __nv_bfloat16*>(q),
                  static_cast<const __nv_bfloat16*>(p), nq, np, out, s);
  }
  return launch(static_cast<const float*>(q), static_cast<const float*>(p),
                nq, np, out, s);
}
