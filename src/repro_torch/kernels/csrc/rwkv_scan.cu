// RWKV-6 recurrence, one (batch, head) per CTA, written for Hopper (sm_90a):
//     out_t = r_t (S + u (x) k_t^T v_t),   S <- diag(w_t) S + k_t^T v_t
// with S the [hd, hd] float32 state (row i is the k index, column j the v
// index), r/k/v/w [B, S, H, hd] float32 read in place through their strides,
// u [H, hd] broadcast over B, state0 [B, H, hd, hd]; out [B, S, H, hd] and
// state_T [B, H, hd, hd] float32, both contiguous.
//
// Replaces: src/repro/kernels/rwkv_scan.py, rwkv_scan (Pallas body
// _rwkv_kernel). That kernel folds the inputs to [B*H, S, hd] for its
// BlockSpec; this one reads [B, S, H, hd] with no fold copy, and every
// offset is 64-bit (B*S*H*hd passes 2^31 at prefill_32k's shape).
//
// What bounds it on this card: at least 5 hd^2 FP32 operations per
// (b, h, t) against 5 hd floats moved (r, k, v, w in, out back), so at
// hd = 64 it is bound by bytes (16 operations per byte, below the card's
// 20). In practice
// it is bound by latency: the loop over t is sequential, and there are only
// B*H CTAs (256 at B = 4, about two per SM).
//
// What the design does about it: the state lives in registers for the whole
// sequence, spread over 4*hd threads (hd columns x 4 row groups; at hd = 64,
// 256 threads of 16 cells each); it is read once and written once. The
// inputs are staged a chunk of kChunk steps at a time into shared memory,
// double-buffered: while the CTA computes chunk c from one buffer, each
// thread's loads for chunk c+1 are in flight into registers, and they are
// stored into the other buffer at the end of the chunk. So a step waits on
// no global load and needs no barrier; there is one __syncthreads per
// chunk. Each thread adds its rows' part of out_j; the four threads of a
// column sit in one warp and reduce with two xor-shuffles, in a fixed order.
// No atomics: a run repeats bitwise.
//
// Order of operations, as the reference's _rwkv_scan_core: out_t reads the
// state before step t's update; w_t scales row i (the k index); the sum
// over i is taken per row group, then across the four groups. nvcc may
// contract the products into FMAs, so the kernel agrees with the plain
// version to float32 rounding, not bitwise.
#include <cuda_runtime.h>

namespace {

constexpr int kGroups = 4;   // row groups: threads per column
constexpr int kChunk = 16;   // time steps staged per chunk

struct Inputs {
  const float* p[4];         // r, k, v, w
  long long sb[4], ss[4], sh[4];   // strides (elements) of b, t, h
};

template <int HD>
__global__ void __launch_bounds__(kGroups * HD) rwkv_scan_kernel(
    Inputs in, const float* __restrict__ u, const float* __restrict__ s0,
    int seq, int heads, float* __restrict__ out, float* __restrict__ s_t) {
  constexpr int R = HD / kGroups;          // rows per thread
  __shared__ float buf[2][4][kChunk][HD];  // [buffer][r,k,v,w][step][elem]

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int tid = threadIdx.x;
  // compute layout: column j, rows i = m * kGroups + g (interleaved, so a
  // warp's shared-memory reads of a row vector hit distinct banks)
  const int g = tid % kGroups;
  const int j = tid / kGroups;
  // staging layout: one input array and one element of it per thread
  const int a = tid / HD;
  const int e = tid % HD;
  const float* src = in.p[a] + b * in.sb[a] + h * in.sh[a] + e;
  const long long sstep = in.ss[a];

  const long long head = (long long)blockIdx.x * HD * HD;
  float st[R], uu[R];
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const int i = m * kGroups + g;
    st[m] = s0[head + (long long)i * HD + j];
    uu[m] = u[(long long)h * HD + i];
  }

  const int n_chunks = (seq + kChunk - 1) / kChunk;
  float pre[kChunk];
#pragma unroll
  for (int s = 0; s < kChunk; ++s) {
    pre[s] = s < seq ? src[s * sstep] : 0.f;
  }
#pragma unroll
  for (int s = 0; s < kChunk; ++s) buf[0][a][s][e] = pre[s];
  __syncthreads();

  const long long out_step = (long long)heads * HD;
  float* out_p = out + ((long long)b * seq * heads + h) * HD + j;

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kChunk;
    const bool more = c + 1 < n_chunks;
    if (more) {
      const int t1 = t0 + kChunk;
#pragma unroll
      for (int s = 0; s < kChunk; ++s) {
        pre[s] = t1 + s < seq ? src[(long long)(t1 + s) * sstep] : 0.f;
      }
    }
    float(*cur)[kChunk][HD] = buf[c & 1];
    const int steps = seq - t0 < kChunk ? seq - t0 : kChunk;
    for (int s = 0; s < steps; ++s) {
      const float vj = cur[2][s][j];
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const int i = m * kGroups + g;
        const float kv = cur[1][s][i] * vj;
        acc += cur[0][s][i] * (st[m] + uu[m] * kv);
        st[m] = cur[3][s][i] * st[m] + kv;
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (g == 0) out_p[(long long)(t0 + s) * out_step] = acc;
    }
    if (more) {
#pragma unroll
      for (int s = 0; s < kChunk; ++s) buf[(c + 1) & 1][a][s][e] = pre[s];
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < R; ++m) {
    const int i = m * kGroups + g;
    s_t[head + (long long)i * HD + j] = st[m];
  }
}

template <int HD>
int launch(const Inputs& in, const float* u, const float* s0, int batch,
           int seq, int heads, float* out, float* s_t, cudaStream_t s) {
  rwkv_scan_kernel<HD><<<batch * heads, kGroups * HD, 0, s>>>(
      in, u, s0, seq, heads, out, s_t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). r/k/v/w are float32 with unit
// stride in the last axis and the given strides (elements) of b, t and h;
// u [H, hd], state0 [B, H, hd, hd], out [B, S, H, hd] and state_T
// [B, H, hd, hd] are contiguous float32. hd is 8, 16, 32 or 64 (else
// returns cudaErrorInvalidValue). Launches on ``stream`` and returns
// cudaGetLastError() of the launch: 0 on success.
extern "C" int rwkv_scan_launch(
    const float* r, const float* k, const float* v, const float* w,
    long long sb_r, long long ss_r, long long sh_r,
    long long sb_k, long long ss_k, long long sh_k,
    long long sb_v, long long ss_v, long long sh_v,
    long long sb_w, long long ss_w, long long sh_w,
    const float* u, const float* state0, int batch, int seq, int heads,
    int hd, float* out, float* state_t, void* stream) {
  if (batch <= 0 || heads <= 0) return 0;
  Inputs in = {{r, k, v, w},
               {sb_r, sb_k, sb_v, sb_w},
               {ss_r, ss_k, ss_v, ss_w},
               {sh_r, sh_k, sh_v, sh_w}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 8: return launch<8>(in, u, state0, batch, seq, heads, out, state_t, s);
    case 16: return launch<16>(in, u, state0, batch, seq, heads, out, state_t, s);
    case 32: return launch<32>(in, u, state0, batch, seq, heads, out, state_t, s);
    case 64: return launch<64>(in, u, state0, batch, seq, heads, out, state_t, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
