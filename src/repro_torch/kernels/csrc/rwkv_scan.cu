// RWKV-6 recurrence, each head's columns split over several one-warp CTAs,
// written for Hopper (sm_90a):
//     out_t = r_t (S + u (x) k_t^T v_t),   S <- diag(w_t) S + k_t^T v_t
// with S the [hd, hd] float32 state (row i is the k index, column j the v
// index), r/k/v/w [B, S, H, hd] float32 read in place through their strides,
// u [H, hd] broadcast over B, state0 [B, H, hd, hd]; out [B, S, H, hd] and
// state_T [B, H, hd, hd] float32, both contiguous. Any hd.
//
// Replaces: src/repro/kernels/rwkv_scan.py, rwkv_scan (Pallas body
// _rwkv_kernel). That kernel folds the inputs to [B*H, S, hd] for its
// BlockSpec; this one reads [B, S, H, hd] with no fold copy, and every
// offset is 64-bit (B*S*H*hd passes 2^31 at prefill_32k's shape).
//
// What bounds it on this card: at least 5 hd^2 FP32 operations per
// (b, h, t) against 5 hd floats moved (r, k, v, w in, out back), so at
// hd = 64 it is bound by bytes (16 operations per byte, below the card's
// 20). The loop over t is sequential: what sets the pace is the latency of
// one step's chain (shared-memory reads, a column's sum over its rows, the
// meeting of the row groups' sums, the store) and how many warps an SM has
// to overlap those chains.
//
// What the design does about it:
// - More CTAs. Column j's recurrence is independent of the other columns
//   (S[:, j] <- w (.) S[:, j] + k v_j), so each head's columns are split
//   over n_slices CTAs of kWarps warps (at B*H = 256 and hd = 64, two a
//   head of 32 columns: 512 CTAs, 1024 warps, about eight warps resident
//   an SM). Each re-reads r, k and w, from L2.
// - Few instructions and shared-memory reads a cell. A lane holds kCols =
//   4 columns over R rows (8 at hd = 64) in registers; one float4 read of
//   r, k and w serves its four columns (a warp's reads of a row vector are
//   broadcasts, so shared-memory traffic a cell falls as kCols grows). Its
//   rows are float4 chunks interleaved with the other row groups' (chunk
//   q * G + g), so those reads hit distinct banks. The bonus term is
//   hoisted: out_t[j] = sum_i r_i S_ij + v_j (sum_i r_i u_i k_i), the
//   scalar computed once a step for the CTA, so a cell costs three FP32
//   operations a step (k_i v_j, the r FMA, the w FMA). A column's G
//   row-group sums meet in a transposing xor-butterfly (each level halves
//   the columns a lane holds), in a fixed order.
// - Steps overlap. The layout (G, R) is a template, so every offset
//   is a constant and a stage's eight steps are straight-line code: the
//   compiler overlaps one step's butterfly and store with the next step's
//   reads and FMAs, which depend on it only through the state.
// - Asynchronous staging. The inputs of kSteps steps form a stage; stages
//   are copied with cp.async (16 bytes where the tensors allow it) into a
//   ring of kStages, issued kStages - 1 stages ahead, one barrier a
//   stage.
// - Any hd. A panel is up to 128 rows (G row groups of R rows; rows and
//   columns past hd are zero-filled in shared memory and registers, and are
//   never written). A larger hd runs its panels one after another inside
//   the CTA, each over the whole sequence with its rows' state in
//   registers, out accumulating in global memory (the lane that writes a
//   column reads back only what it wrote itself).
// One CTA per (b, h, column slice); no atomics, so a run repeats bitwise.
//
// Order of operations: out_t reads the state before step t's update; w_t
// scales row i (the k index); each row group sums r_i S_ij over its rows
// in chunk order, the groups' sums meet in the butterfly, and v_j times the
// bonus scalar is added last (one FMA). nvcc contracts the
// products into FMAs, so the kernel agrees with the plain version to
// float32 rounding, not bitwise (tests/test_torch_rwkv_scan.py models this
// order on the CPU).
#include <cuda_runtime.h>

namespace {

constexpr int kSteps = 8;       // time steps per stage
constexpr int kStages = 3;      // stages in the ring
constexpr int kCols = 4;        // state columns a lane
constexpr int kWarps = 2;       // warps a CTA, side by side in columns
constexpr unsigned kAll = 0xffffffffu;

struct Inputs {
  const float* p[4];             // r, k, v, w
  long long sb[4], ss[4], sh[4];   // strides (elements) of b, t, h
};

struct Shape {
  int seq, heads, hd;
  int n_panels;   // ceil(hd / rows)
  int n_slices;   // CTAs per (b, h), ceil(hd / cols)
  bool vec;       // rows and columns may be copied 16 bytes at a time
  bool svec;      // the states may be read and written 16 bytes at a time
};

// A lane's share and a stage's layout: G row groups (lanes of one column
// group) of R rows, kCols columns a lane, kWarps warps a CTA side by side
// in columns; per step r, k, w (rows each) then v (cols), a step's stride =
// 4 (mod 32) floats so that the bonus lanes' steps hit distinct banks.
template <int G, int R>
struct Layout {
  static constexpr int rows = G * R;              // rows of a panel
  static constexpr int warp_cols = 32 / G * kCols;  // columns of a warp
  static constexpr int cols = kWarps * warp_cols;   // columns of a CTA
  static constexpr int base = (3 * rows + cols + 3) / 4 * 4;
  static constexpr int stride = base + (36 - base % 32) % 32;
  static constexpr int stage = kSteps * stride;
  static constexpr size_t smem_bytes =
      (size_t)(kStages * stage + rows) * sizeof(float);
};

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of 4 or 16 bytes; ``ok`` false zero-fills (reads nothing).
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// in.p[a] etc. without indexing the parameter struct at run time (which
// would copy it to local memory).
__device__ __forceinline__ const float* input_at(const Inputs& in, int a,
                                                 int b, int h, long long& ss) {
  const float* p = a == 0 ? in.p[0] : a == 1 ? in.p[1] : a == 2 ? in.p[2]
                                                                 : in.p[3];
  const long long sb = a == 0 ? in.sb[0] : a == 1 ? in.sb[1]
                       : a == 2 ? in.sb[2] : in.sb[3];
  const long long sh = a == 0 ? in.sh[0] : a == 1 ? in.sh[1]
                       : a == 2 ? in.sh[2] : in.sh[3];
  ss = a == 0 ? in.ss[0] : a == 1 ? in.ss[1] : a == 2 ? in.ss[2] : in.ss[3];
  return p + b * sb + h * sh;
}

// Issues the copies of stage c (steps c * kSteps ...) into ``buf``: in the
// 16-byte path a lane takes the chunks lane + 32 u of a step's 3 * rows / 4
// (r, k, w) and issues them for every step of the stage, then the stage's
// v chunks.
template <class L>
__device__ __forceinline__ void stage_in(const Inputs& in, const Shape& sh,
                                         int b, int h, int i0, int c0,
                                         int c, float* buf) {
  constexpr int kThreads = 32 * kWarps;
  const int lane = threadIdx.x;
  const int t0 = c * kSteps;
  const int steps = min(kSteps, sh.seq - t0);
  long long ss_v;
  const float* vsrc = input_at(in, 2, b, h, ss_v);
  if (sh.vec) {
    constexpr int n4 = L::rows / 4, n3 = 3 * n4;
#pragma unroll
    for (int y0 = 0; y0 < n3; y0 += kThreads) {
      const int y = y0 + lane;
      if (y < n3) {
        const int a = y / n4, ch = y - a * n4;
        const int i = i0 + 4 * ch;
        long long ss;
        const float* src = input_at(in, a == 2 ? 3 : a, b, h, ss);
        const bool ok = i < sh.hd;
        src += ok ? t0 * ss + i : 0;
        float* dst = buf + a * L::rows + 4 * ch;
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
          copy16(dst + s * L::stride, src, ok && s < steps);
          if (ok && s + 1 < steps) src += ss;
        }
      }
    }
    constexpr int c4 = L::cols / 4;
#pragma unroll
    for (int y0 = 0; y0 < kSteps * c4; y0 += kThreads) {
      const int y = y0 + lane;
      const int s = y / c4, ch = y - s * c4;
      const int j = c0 + 4 * ch;
      const bool ok = y < kSteps * c4 && s < steps && j < sh.hd;
      if (y < kSteps * c4)
        copy16(buf + s * L::stride + 3 * L::rows + 4 * ch,
               ok ? vsrc + (t0 + s) * ss_v + j : vsrc, ok);
    }
  } else {
    for (int s = 0; s < kSteps; ++s) {
      const int t = t0 + s;
      for (int y = lane; y < 3 * L::rows; y += kThreads) {
        const int a = y / L::rows, i = y - a * L::rows;
        long long ss;
        const float* base = input_at(in, a == 2 ? 3 : a, b, h, ss);
        const bool ok = s < steps && i0 + i < sh.hd;
        copy4(buf + s * L::stride + y, ok ? base + t * ss + i0 + i : base,
              ok);
      }
      for (int y = lane; y < L::cols; y += kThreads) {
        const bool ok = s < steps && c0 + y < sh.hd;
        copy4(buf + s * L::stride + 3 * L::rows + y,
              ok ? vsrc + t * ss_v + c0 + y : vsrc, ok);
      }
    }
  }
}

// The stage's bonus scalars sum_i r_i u_i k_i over the panel's rows: lane
// L takes step L % kSteps and the chunks L / kSteps + m * kParts, in two
// partial sums; the kParts lanes of a step meet in xor-shuffles. Returns
// step (lane % kSteps)'s scalar.
template <class L>
__device__ __forceinline__ float stage_bonus(const float* buf,
                                             const float* s_u) {
  constexpr int kParts = 32 / kSteps;
  static_assert(kParts * kSteps == 32, "whole lanes a step");
  const int lane = threadIdx.x & 31;
  const float* st = buf + (lane % kSteps) * L::stride;
  float acc[2] = {0.f, 0.f};
#pragma unroll
  for (int m = 0; m < (L::rows / 4 + kParts - 1) / kParts; ++m) {
    const int ch = lane / kSteps + kParts * m;
    if (ch < L::rows / 4) {
      const float4 r = reinterpret_cast<const float4*>(st)[ch];
      const float4 k = reinterpret_cast<const float4*>(st + L::rows)[ch];
      const float4 u = reinterpret_cast<const float4*>(s_u)[ch];
      float& a = acc[m & 1];
      a = fmaf(r.x * k.x, u.x, a);
      a = fmaf(r.y * k.y, u.y, a);
      a = fmaf(r.z * k.z, u.z, a);
      a = fmaf(r.w * k.w, u.w, a);
    }
  }
  float total = acc[0] + acc[1];
#pragma unroll
  for (int o = kSteps; o < 32; o <<= 1)
    total += __shfl_xor_sync(kAll, total, o);
  return total;
}

// The G lanes of a column group sum their kCols partial columns: at xor
// distance o = 1, 2, ... each lane keeps half of the columns it holds and
// sends the other half (a transposing butterfly), until it holds one;
// further levels add that column across lanes, and only the lane whose
// bits at those levels are 0 keeps it. Afterwards the lane holds ``kKept``
// columns, acc[0 .. kKept) being its columns off + 0 ...; ``mine`` says
// whether it writes them.
template <int G>
struct Reduce {
  static constexpr int kKept = kCols >= G ? kCols / G : 1;

  __device__ __forceinline__ static void run(float (&acc)[kCols], int g,
                                             int& off, bool& mine) {
    off = 0;
    mine = true;
    int held = kCols;                   // columns held before a level
#pragma unroll
    for (int o = 1; o < G; o <<= 1) {
      if (held > 1) {
        const int half = held / 2;
        const bool hi = (g & o) != 0;
#pragma unroll
        for (int c = 0; c < kCols / 2; ++c) {
          if (c < half) {
            const float send = hi ? acc[c] : acc[c + half];
            const float keep = hi ? acc[c + half] : acc[c];
            acc[c] = keep + __shfl_xor_sync(kAll, send, o);
          }
        }
        if (hi) off += half;
        held = half;
      } else {
        acc[0] += __shfl_xor_sync(kAll, acc[0], o);
        if (g & o) mine = false;
      }
    }
  }
};

// One step: row group g's sums over its rows, the state update, the
// butterfly, v_j times the bonus added to each kept column, the store (or,
// past the first panel, the add to what the earlier panels stored).
template <int G, int R, bool kPanels>
__device__ __forceinline__ void step(const float* sp, float bon, int g,
                                     int jl, float (&st)[R / 4][4][kCols],
                                     float* o, int n_valid, bool first) {
  using L = Layout<G, R>;
  const float* sv = sp + 3 * L::rows + jl;     // the lane's v columns
  float v[kCols], acc[kCols];
  const float4 vx = *reinterpret_cast<const float4*>(sv);
  v[0] = vx.x, v[1] = vx.y, v[2] = vx.z, v[3] = vx.w;
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
#pragma unroll
  for (int q = 0; q < R / 4; ++q) {
    const int ch = q * G + g;
    const float4 r4 = reinterpret_cast<const float4*>(sp)[ch];
    const float4 k4 = reinterpret_cast<const float4*>(sp + L::rows)[ch];
    const float4 w4 = reinterpret_cast<const float4*>(sp + 2 * L::rows)[ch];
    const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
    const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
    const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float kv = kk[e] * v[c];
        acc[c] = fmaf(rr[e], st[q][e][c], acc[c]);
        st[q][e][c] = fmaf(ww[e], st[q][e][c], kv);
      }
    }
  }
  using Red = Reduce<G>;
  int off;
  bool mine;
  Red::run(acc, g, off, mine);
#pragma unroll
  for (int c = 0; c < Red::kKept; ++c) {
    if (mine && off + c < n_valid) {
      float val = fmaf(sv[off + c], bon, acc[c]);
      if constexpr (kPanels) {
        if (!first) val += o[off + c];
      }
      o[off + c] = val;
    }
  }
}

// One CTA: the column slice of (b, h) given by blockIdx.x, every panel of
// rows in turn. kPanels: more than one panel (out accumulates across them).
template <int G, int R, bool kPanels>
__global__ void __launch_bounds__(32 * kWarps) rwkv_scan_kernel(
    Inputs in, Shape sh, const float* __restrict__ u,
    const float* __restrict__ s0, float* __restrict__ out,
    float* __restrict__ s_t) {
  using L = Layout<G, R>;
  static_assert(R % 4 == 0 && R <= 16 && kCols == 4, "layout");
  constexpr int Q = R / 4;
  extern __shared__ float4 dyn[];
  float* ring = reinterpret_cast<float*>(dyn);
  float* s_u = ring + kStages * L::stage;

  const int lane = threadIdx.x & 31;
  const int g = lane & (G - 1);               // row group
  const int jl = (threadIdx.x >> 5) * L::warp_cols + lane / G * kCols;
                                              // the lane's first column,
                                              // within the CTA
  const int slice = blockIdx.x % sh.n_slices;
  const int bh = blockIdx.x / sh.n_slices;
  const int h = bh % sh.heads, b = bh / sh.heads;
  const int c0 = slice * L::cols;             // first column of the CTA
  const int n_valid = sh.hd - c0 - jl;        // the lane's columns < hd
  const long long head = (long long)bh * sh.hd * sh.hd;
  const long long out_step = (long long)sh.heads * sh.hd;
  float* out_p =
      out + ((long long)b * sh.seq * sh.heads + h) * sh.hd + c0 + jl;
  const int n_stages = (sh.seq + kSteps - 1) / kSteps;

  for (int panel = 0; panel < (kPanels ? sh.n_panels : 1); ++panel) {
    const int i0 = panel * L::rows;
    for (int i = threadIdx.x; i < L::rows; i += 32 * kWarps)
      s_u[i] = i0 + i < sh.hd ? u[(long long)h * sh.hd + i0 + i] : 0.f;
    // a row's kCols columns in 16-byte accesses where they are all < hd and
    // aligned, else one by one
    const bool whole = sh.svec && n_valid >= kCols;
    float st[Q][4][kCols];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + 4 * (q * G + g) + e;
        const float* src = s0 + head + (long long)i * sh.hd + c0 + jl;
#pragma unroll
        for (int c = 0; c < kCols; c += 4) {
          if (whole && i < sh.hd) {
            const float4 x = *reinterpret_cast<const float4*>(src + c);
            st[q][e][c] = x.x, st[q][e][c + 1] = x.y;
            st[q][e][c + 2] = x.z, st[q][e][c + 3] = x.w;
          } else {
#pragma unroll
            for (int cc = c; cc < c + 4; ++cc)
              st[q][e][cc] = i < sh.hd && cc < n_valid ? src[cc] : 0.f;
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kStages - 1; ++c) {
      if (c < n_stages)
        stage_in<L>(in, sh, b, h, i0, c0, c, ring + c * L::stage);
      commit();
    }

    float* o = out_p;
    for (int c = 0; c < n_stages; ++c) {
      wait_groups<kStages - 2>();
      __syncthreads();              // stage c landed; stage c - 1 is read
      const int nc = c + kStages - 1;
      if (nc < n_stages)
        stage_in<L>(in, sh, b, h, i0, c0, nc,
                    ring + (nc % kStages) * L::stage);
      commit();
      const float* buf = ring + (c % kStages) * L::stage;
      const int steps = min(kSteps, sh.seq - c * kSteps);
      if (steps == kSteps) {        // a whole stage: straight-line steps
        const float bonus = stage_bonus<L>(buf, s_u);
#pragma unroll
        for (int s = 0; s < kSteps; ++s)
          step<G, R, kPanels>(buf + s * L::stride,
                                   __shfl_sync(kAll, bonus, s), g, jl, st,
                                   o + s * out_step, n_valid, panel == 0);
      } else {
        const float bonus = stage_bonus<L>(buf, s_u);
        for (int s = 0; s < steps; ++s)
          step<G, R, kPanels>(buf + s * L::stride,
                                   __shfl_sync(kAll, bonus, s), g, jl, st,
                                   o + s * out_step, n_valid, panel == 0);
      }
      o += kSteps * out_step;
    }
    wait_groups<0>();
    __syncthreads();                // the ring is free for the next panel
#pragma unroll
    for (int q = 0; q < Q; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + 4 * (q * G + g) + e;
        float* dst = s_t + head + (long long)i * sh.hd + c0 + jl;
#pragma unroll
        for (int c = 0; c < kCols; c += 4) {
          if (whole && i < sh.hd) {
            *reinterpret_cast<float4*>(dst + c) =
                make_float4(st[q][e][c], st[q][e][c + 1], st[q][e][c + 2],
                            st[q][e][c + 3]);
          } else {
#pragma unroll
            for (int cc = c; cc < c + 4; ++cc)
              if (i < sh.hd && cc < n_valid) dst[cc] = st[q][e][cc];
          }
        }
      }
    }
  }
}

template <int G, int R, bool kPanels = false>
int launch(const Inputs& in, const Shape& sh, const float* u,
           const float* s0, int batch, float* out, float* s_t,
           cudaStream_t s) {
  using L = Layout<G, R>;
  auto kernel = rwkv_scan_kernel<G, R, kPanels>;
  cudaError_t err = cudaSuccess;
  if (L::smem_bytes > 48 * 1024)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(L::smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_ctas = (long long)batch * sh.heads * sh.n_slices;
  if (n_ctas >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(n_ctas), 32 * kWarps, L::smem_bytes, s>>>(
      in, sh, u, s0, out, s_t);
  return static_cast<int>(cudaGetLastError());
}

// The layouts scan_plan (kernels/rwkv_scan.py) gives: (G, R) = (1, 4),
// (1, 8), (2, 8), (4, 8), (8, 8), (8, 12), (8, 16), and 8 x 16 in panels.
int launch_plan(const Inputs& in, const Shape& sh, int g, int r,
                const float* u, const float* s0, int batch, float* out,
                float* s_t, cudaStream_t s) {
  const int key = g * 100 + r;
  if (sh.n_panels > 1) {
    if (key == 816)
      return launch<8, 16, true>(in, sh, u, s0, batch, out, s_t, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (key) {
    case 104: return launch<1, 4>(in, sh, u, s0, batch, out, s_t, s);
    case 108: return launch<1, 8>(in, sh, u, s0, batch, out, s_t, s);
    case 208: return launch<2, 8>(in, sh, u, s0, batch, out, s_t, s);
    case 408: return launch<4, 8>(in, sh, u, s0, batch, out, s_t, s);
    case 808: return launch<8, 8>(in, sh, u, s0, batch, out, s_t, s);
    case 812: return launch<8, 12>(in, sh, u, s0, batch, out, s_t, s);
    case 816: return launch<8, 16>(in, sh, u, s0, batch, out, s_t, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

}  // namespace

// Plain C entry point (bound with ctypes). r/k/v/w are float32 with unit
// stride in the last axis and the given strides (elements) of b, t and h;
// u [H, hd], state0 [B, H, hd, hd], out [B, S, H, hd] and state_T
// [B, H, hd, hd] are contiguous float32. The layout (kernels/rwkv_scan.py,
// scan_plan): ``groups`` row groups of ``rows_per_lane`` rows a lane, one
// of launch_plan's layouts, ``nct`` columns a lane and ``warps`` warps a
// CTA (kCols and kWarps, for which this file is built); anything else
// returns cudaErrorInvalidValue. Launches on ``stream`` and returns
// cudaGetLastError() of the launch: 0 on success.
extern "C" int rwkv_scan_launch(
    const float* r, const float* k, const float* v, const float* w,
    long long sb_r, long long ss_r, long long sh_r,
    long long sb_k, long long ss_k, long long sh_k,
    long long sb_v, long long ss_v, long long sh_v,
    long long sb_w, long long ss_w, long long sh_w,
    const float* u, const float* state0, int batch, int seq, int heads,
    int hd, int groups, int rows_per_lane, int nct, int warps, float* out,
    float* state_t, void* stream) {
  if (batch <= 0 || heads <= 0 || hd <= 0) return 0;
  const Inputs in = {{r, k, v, w},
                     {sb_r, sb_k, sb_v, sb_w},
                     {ss_r, ss_k, ss_v, ss_w},
                     {sh_r, sh_k, sh_v, sh_w}};
  const int rows = groups * rows_per_lane;
  const int cols =
      groups >= 1 && groups <= 32 && warps >= 1 ? warps * (32 / groups) * nct
                                                : 0;
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Shape sh;
  sh.seq = seq;
  sh.heads = heads;
  sh.hd = hd;
  sh.n_panels = (hd + rows - 1) / rows;
  sh.n_slices = (hd + cols - 1) / cols;
  bool vec = hd % 4 == 0 && aligned16(r) && aligned16(k) && aligned16(v) &&
             aligned16(w);
  for (int a = 0; a < 4; ++a)
    vec = vec && in.sb[a] % 4 == 0 && in.ss[a] % 4 == 0 && in.sh[a] % 4 == 0;
  sh.vec = vec;
  sh.svec = hd % 4 == 0 && aligned16(state0) && aligned16(state_t);
  if (nct != kCols || warps != kWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_plan(in, sh, groups, rows_per_lane, u, state0, batch, out,
                     state_t, static_cast<cudaStream_t>(stream));
}
