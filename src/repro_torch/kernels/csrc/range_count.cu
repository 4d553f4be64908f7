// Per-query count of window candidates within the radius, written for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/range_tile.py:46, range_count (pallas_call
// :68; Pallas body _range_count_kernel). For query tile i, each query
// counts the candidates j of wnd_pos[i, j] / wnd_idx[i, j] with
// wnd_idx >= 0 and d2 = max(|q|^2 + |p|^2 - 2 q.p, 0) <= r2.
//
// What bounds it on this card: every id must be read (4 B), but a
// position (12 B) only where its id is valid, and each valid candidate
// needs about ten FP32 operations per query of its tile. On a stream of
// mostly invalid ids (empty grid slots) the bytes bound it; chip_smoke.py
// computes which from the run's data.
//
// What the design does about it:
// - Split each stream across a full grid, as knn_tile.cu does: a unit is
//   one (tile, row block), its m ids cut into nseg segments of seg
//   consecutive positions (knn_tile.py, stream_split, sized from the
//   card's resident CTAs for this kernel, range_count_resident); a plain
//   grid of one CTA an item, segment-major (CTA b runs segment
//   b / n_units of unit b % n_units).
// - Read and compute only on valid ids. A CTA reads its segment's ids
//   coalesced, kRounds a thread a round, compacts the valid ones (warp
//   ballot, then a scan of the per-warp counts) and reads only their
//   positions, into shared memory with |p|^2; each thread then counts its
//   query's hits over the compacted candidates alone.
// - Count without order. Each item adds its integer partial count of a
//   query to out[row] with atomicAdd into a zeroed output. Integer
//   addition is exact and commutes, so the result is deterministic.
// A tile that is not a whole number of warps, or has more than 1024 rows,
// runs masked in row blocks of at most 1024 rows that share the tile's
// stream: threads past a block's rows stage candidates with the others and
// add nothing.
//
// Exactness: the sums are taken x, y, z through __fmul_rn/__fadd_rn
// (knn_stream.cuh), as the plain PyTorch version in range_tile.py writes
// them, so the two agree.
#include "knn_stream.cuh"

namespace {

using knn_stream::dot3;
using knn_stream::kRounds;

struct Args {
  const float* __restrict__ q;         // [rows, 3]
  const float* __restrict__ wnd_pos;   // [n_tiles, m, 3]
  const int* __restrict__ wnd_idx;     // [n_tiles, m]
  int* out;                            // [rows], zeroed
  int n_units, m, seg;                 // seg: ids per item
  float r2;
  // masked launch: unit u is rows [r0, r0 + rb_rows) of tile u / n_rb,
  // r0 = (u % n_rb) * rb_rows, clipped to the tile's tile_rows
  int tile_rows, rb_rows, n_rb;
};

// The hits among the n staged candidates of a query.
__device__ __forceinline__ int count_stage(const float4* s_pt, int n,
                                           float qx, float qy, float qz,
                                           float qn, float r2) {
  int c = 0;
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    const float4 p = s_pt[j];
    c += knn_stream::sq_dist(qn, p.w, dot3(qx, qy, qz, p.x, p.y, p.z)) <= r2;
  }
  return c;
}

// One work item: segment blockIdx.x / n_units of unit blockIdx.x %
// n_units. (Dynamic shared memory: (kRounds + 1) * blockDim.x compacted
// candidates, each a float4 of its position and |p|^2.)
template <bool kMasked>
__global__ void __launch_bounds__(1024) range_count_kernel(Args a) {
  extern __shared__ float4 s_pt[];
  __shared__ knn_stream::Ranks rk;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nthr = blockDim.x, nw = nthr >> 5;
  const int unit = blockIdx.x % a.n_units;
  const int s = blockIdx.x / a.n_units;
  int tile = unit;
  long long row = (long long)unit * nthr + t;
  bool active = true;
  if constexpr (kMasked) {
    tile = unit / a.n_rb;
    const int r0 = (unit - tile * a.n_rb) * a.rb_rows;
    active = t < min(a.rb_rows, a.tile_rows - r0);
    row = (long long)tile * a.tile_rows + r0 + t;
  }
  const float qx = active ? a.q[row * 3 + 0] : 0.f,
              qy = active ? a.q[row * 3 + 1] : 0.f,
              qz = active ? a.q[row * 3 + 2] : 0.f;
  const float qn = dot3(qx, qy, qz, qx, qy, qz);
  const long long tile_base = (long long)tile * a.m;
  const long long first = (long long)s * a.seg;
  const long long last = min(first + a.seg, (long long)a.m);
  const unsigned below = (1u << lane) - 1;
  int count = 0, parity = 0, fill = 0;
  // Rounds of kRounds * nthr ids, then a final count of the stage.
  for (long long base = first;; base += (long long)kRounds * nthr) {
    const bool more = base < last;        // uniform across the CTA
    if (more) {
      bool valid[kRounds];
      unsigned mk[kRounds];
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        const long long i = base + r * nthr + t;
        valid[r] = i < last && a.wnd_idx[tile_base + i] >= 0;
      }
      const int* cnt = knn_stream::rank_round(rk, parity, valid, mk);
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        if (valid[r]) {
          const long long j = tile_base + base + r * nthr + t;
          const float px = a.wnd_pos[j * 3 + 0], py = a.wnd_pos[j * 3 + 1],
                      pz = a.wnd_pos[j * 3 + 2];
          s_pt[fill + cnt[r * nw + warp] + __popc(mk[r] & below)] =
              make_float4(px, py, pz, dot3(px, py, pz, px, py, pz));
        }
      }
      fill += rk.total;
    }
    // count when only one more round fits, and at the end
    if (fill > nthr || (!more && fill > 0)) {
      __syncthreads();
      if (active) count += count_stage(s_pt, fill, qx, qy, qz, qn, a.r2);
      fill = 0;
    }
    if (!more) break;
  }
  if (active && count > 0) atomicAdd(a.out + row, count);
}

// Launches one instantiation, or with ``resident`` non-null only reports
// how many of its CTAs of ``block`` threads the card holds at once.
template <bool kMasked>
int run(const Args& a, int n_items, int block, cudaStream_t stream,
        int* resident) {
  const size_t smem = (size_t)(kRounds + 1) * block * sizeof(float4);
  auto kernel = range_count_kernel<kMasked>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (resident != nullptr)
    return static_cast<int>(
        knn_stream::resident_ctas(kernel, block, smem, resident));
  kernel<<<n_items, block, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const Args& a, int n_items, int tile, int block,
             cudaStream_t s, int* resident) {
  if (block % 32 || block < a.rb_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.n_rb == 1 && block == tile)
    return run<false>(a, n_items, block, s, resident);
  return run<true>(a, n_items, block, s, resident);
}

}  // namespace

// How many CTAs of the kernel that range_count_launch would run for these
// arguments the card holds at once (SM count x occupancy), into *out.
// Returns the first CUDA error: 0 on success.
extern "C" int range_count_resident(int tile, int rb_rows, int n_rb,
                                    int block, int* out) {
  Args a{};
  a.rb_rows = rb_rows;
  a.n_rb = n_rb;
  return dispatch(a, 0, tile, block, nullptr, out);
}

// Plain C entry point (bound with ctypes). Launches on ``stream`` and
// returns the first CUDA error of the set-up or the launch: 0 on success.
// Each tile of ``tile`` rows runs as ``n_rb`` units of ``rb_rows`` rows
// (CTAs of ``block`` threads, a multiple of 32); ``block == tile`` and
// ``n_rb == 1`` is the unmasked kernel. Each unit's ``m`` ids are ``nseg``
// work items of ``seg`` ids (the last may hold fewer). ``out`` must be
// zeroed: the items add to it.
extern "C" int range_count_launch(const float* q, const float* wnd_pos,
                                  const int* wnd_idx, int n_tiles, int tile,
                                  int rb_rows, int n_rb, int block, int m,
                                  int seg, int nseg, float r2, int* out,
                                  void* stream) {
  if (n_tiles <= 0) return 0;
  const long long n_units = (long long)n_tiles * n_rb;
  if (seg < 1 || nseg < 1 || (long long)seg * nseg < m ||
      n_units * nseg >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,   wnd_pos, wnd_idx, out,     static_cast<int>(n_units),
               m,   seg,     r2,      tile,    rb_rows,
               n_rb};
  return dispatch(a, static_cast<int>(n_units * nseg), tile, block,
                  static_cast<cudaStream_t>(stream), nullptr);
}
