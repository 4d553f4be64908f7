// Fused re-binning + motion statistics of the dynamic-scene grid update,
// written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/update_tile.py:32, bin_disp_tile (Pallas).
// In one pass over N moved points it writes each point's clipped cell
// floor((p - origin) * inv_cell), counts the points whose true cell lies
// outside [0, dims - 1], and takes the largest squared displacement
// against the plan-anchor positions.
//
// What bounds it on this card: bytes. Each point costs 36 B (24 B read:
// its position and its anchor; 12 B written: its cell) against about 20
// FP32 operations, so at 3.35 TB/s the bound is 10.7 us per million
// points and the arithmetic is free.
//
// What the design does about it: one thread per point, 256 per block,
// each reading its 24 B once and writing its 12 B once, neighbouring
// threads on neighbouring addresses. Nothing else touches device memory:
// the two statistics are reduced in registers (warp shuffles), then across
// the block in shared memory, and each block adds ONE atomicAdd (the
// count) and ONE atomicMax (the displacement) to two words the wrapper
// zeroed. The displacement is >= 0, so the order of its int32 bit pattern
// is the order of the floats, and the result does not depend on the order
// in which the blocks finish.
//
// Exactness: the cell is floorf(__fmul_rn(__fsub_rn(p, o), inv_cell)),
// compared with 0 and dims - 1 and clamped while still float (a cast of
// an out-of-range float to int is undefined). The squared displacement is
// (dx*dx + dy*dy) + dz*dz through __fmul_rn/__fadd_rn, so nvcc cannot
// contract it into FMAs; the plain PyTorch version in update_tile.py does
// the same elementwise ops and the two agree bitwise.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kParkThreshold = 1e29f;   // core/types.py PARK_THRESHOLD

__global__ void __launch_bounds__(kThreads) bin_disp_tile_kernel(
    const float* __restrict__ points, const float* __restrict__ anchors,
    const float* __restrict__ origin, float inv_cell, int dx, int dy, int dz,
    int n, int mask_parked, int* __restrict__ ccoord,
    int* __restrict__ stats) {
  __shared__ int s_oob[kWarps];
  __shared__ int s_d2[kWarps];
  const int t = threadIdx.x;
  const int i = blockIdx.x * kThreads + t;
  int oob = 0;
  int d2_bits = 0;                        // +0.0f
  if (i < n) {
    const float px = points[3 * i + 0];
    const float py = points[3 * i + 1];
    const float pz = points[3 * i + 2];
    const float hx = static_cast<float>(dx - 1);
    const float hy = static_cast<float>(dy - 1);
    const float hz = static_cast<float>(dz - 1);
    const float cx = floorf(__fmul_rn(__fsub_rn(px, origin[0]), inv_cell));
    const float cy = floorf(__fmul_rn(__fsub_rn(py, origin[1]), inv_cell));
    const float cz = floorf(__fmul_rn(__fsub_rn(pz, origin[2]), inv_cell));
    ccoord[3 * i + 0] = static_cast<int>(fminf(fmaxf(cx, 0.f), hx));
    ccoord[3 * i + 1] = static_cast<int>(fminf(fmaxf(cy, 0.f), hy));
    ccoord[3 * i + 2] = static_cast<int>(fminf(fmaxf(cz, 0.f), hz));
    const bool parked = fabsf(px) >= kParkThreshold ||
                        fabsf(py) >= kParkThreshold ||
                        fabsf(pz) >= kParkThreshold;
    if (!(mask_parked && parked)) {
      oob = (cx < 0.f || cx > hx || cy < 0.f || cy > hy || cz < 0.f ||
             cz > hz) ? 1 : 0;
      const float ex = __fsub_rn(px, anchors[3 * i + 0]);
      const float ey = __fsub_rn(py, anchors[3 * i + 1]);
      const float ez = __fsub_rn(pz, anchors[3 * i + 2]);
      const float d2 = __fadd_rn(
          __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)), __fmul_rn(ez, ez));
      d2_bits = __float_as_int(d2);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    oob += __shfl_down_sync(0xffffffffu, oob, off);
    d2_bits = max(d2_bits, __shfl_down_sync(0xffffffffu, d2_bits, off));
  }
  if ((t & 31) == 0) {
    s_oob[t >> 5] = oob;
    s_d2[t >> 5] = d2_bits;
  }
  __syncthreads();
  if (t < 32) {
    oob = t < kWarps ? s_oob[t] : 0;
    d2_bits = t < kWarps ? s_d2[t] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      oob += __shfl_down_sync(0xffffffffu, oob, off);
      d2_bits = max(d2_bits, __shfl_down_sync(0xffffffffu, d2_bits, off));
    }
    if (t == 0) {
      if (oob != 0) atomicAdd(&stats[0], oob);
      if (d2_bits != 0) atomicMax(&stats[1], d2_bits);
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). ``stats`` is two zeroed int32
// words: [0] the out-of-bounds count, [1] the float bits of max_disp2.
// Launches on ``stream`` and returns cudaGetLastError() of the launch.
extern "C" int bin_disp_tile_launch(const float* points, const float* anchors,
                                    const float* origin, float inv_cell,
                                    int dx, int dy, int dz, int n,
                                    int mask_parked, int* ccoord, int* stats,
                                    void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kThreads - 1) / kThreads;
  bin_disp_tile_kernel<<<blocks, kThreads, 0, s>>>(
      points, anchors, origin, inv_cell, dx, dy, dz, n, mask_parked, ccoord,
      stats);
  return static_cast<int>(cudaGetLastError());
}
