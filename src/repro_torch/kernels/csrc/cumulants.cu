// One-pass cumulant sums over unsorted tuples -- replaces the TPU kernel
// repro/kernels/cumulants.py:31 `_cumulants_kernel` (entry
// `cumulant_sums`, :64), and is route (a) of the grouped one,
// repro/kernels/group_cumulants.py:57 `_group_cumulants_kernel`, for at
// most kMaxTileGroups groups (Q1 has 8; more go to group_cumulants.cu).
//
//   s[g, j] = sum_{i : gid_i = g} v_i^j kappa_j(p_i),   j = 1..orders,
//   g < G <= 8  (G = 1: the scalar sums, no gids read)
//
// Bound on the H100: bytes.  A tuple costs 8 bytes (p, v) and 8 more for
// its int64 gid when G > 1 -- no sorted copies are made or read -- against
// O^2 + 4 O - 1 float ops (95 at O = 8): 6 MB per canonical chunk of
// 750,000 tuples (1.8 us at 3.35 TB/s), 800 MB at the value layer's
// 10^8-tuple fit (0.239 ms), each a few times its operation time at
// 67 TFLOP/s.
//
// Design (the first design had 1024-tuple blocks, a 12 x 256 shared tree
// in each, and a second pass whose 8 live lanes walked every block row in
// order: 97,657 dependent reads at 10^8):
//  - cumulant_tiles: each block takes a fixed tile of kTile = 4096 tuples,
//    so the split depends on n alone.  Thread t takes kRuns runs of 4
//    consecutive tuples, as float4 (and 2 x longlong2) loads where the tile
//    is full and the pointers 16-byte aligned, else masked scalar loads of
//    the same tuples in the same order.
//  - Each tuple's O terms are formed once (common.cuh) and added into
//    GB x O register accumulators, GB in {1, kMaxTileGroups} a template
//    argument: one predicated FFMA per (group, order), no dynamic index
//    into local memory, no sort.
//  - The block reduces its accumulators with warp_transpose_sum, adds its
//    warps' rows in order through shared memory, and writes one partial
//    per value, by column (value k of tile b at k * tiles + b).
//  - cumulant_rows_sum: one 1024-thread block per value adds its column --
//    thread t takes rows t, t + 1024, ... in order, four loads in flight,
//    then a fixed shuffle tree.
// No atomics: the same bits on every run.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kVec = 4;
constexpr int kRuns = 4;
constexpr int kTile = kThreads * kVec * kRuns;  // cumulants.TILE
constexpr int kMaxTileGroups = 8;               // group_cumulants.NO_SORT_MAX
constexpr int kRowThreads = 1024;

// Adds one tuple into the accumulator row of its group (GB > 1) or into
// the only row (GB = 1).
template <int O, int GB, int N>
__device__ __forceinline__ void add_tuple(float p, float v, long long g,
                                          float (&acc)[N]) {
  if constexpr (GB == 1) {
    cumulant_add<O>(p, v, acc);
  } else {
    float kap[O], vp[O];
    cumulant_factors<O>(p, v, kap, vp);
#pragma unroll
    for (int h = 0; h < GB; ++h) {
      const bool mine = g == h;
#pragma unroll
      for (int j = 0; j < O; ++j)
        if (mine) acc[h * O + j] = fmaf(kap[j], vp[j], acc[h * O + j]);
    }
  }
}

template <int O, int GB>
__global__ void __launch_bounds__(kThreads)
cumulant_tiles(const float* __restrict__ p, const float* __restrict__ v,
               const long long* __restrict__ gid, float* __restrict__ part,
               int n, int tiles, int width) {
  constexpr int C = (GB * O + kWarp - 1) / kWarp;
  float acc[kWarp * C];
#pragma unroll
  for (int i = 0; i < kWarp * C; ++i) acc[i] = 0.0f;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  uintptr_t addr =
      reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(v);
  if constexpr (GB > 1) addr |= reinterpret_cast<uintptr_t>(gid);
  const bool vec = base + kTile <= n && (addr & 15) == 0;
#pragma unroll
  for (int r = 0; r < kRuns; ++r) {
    const long long i0 = base + kVec * (threadIdx.x + kThreads * r);
    float pr[kVec] = {}, vr[kVec] = {};
    long long gr[kVec] = {};
    bool ok[kVec];
    if (vec) {
      const float4 a = *reinterpret_cast<const float4*>(p + i0);
      const float4 b = *reinterpret_cast<const float4*>(v + i0);
      pr[0] = a.x, pr[1] = a.y, pr[2] = a.z, pr[3] = a.w;
      vr[0] = b.x, vr[1] = b.y, vr[2] = b.z, vr[3] = b.w;
      if constexpr (GB > 1) {
        const longlong2 g0 = *reinterpret_cast<const longlong2*>(gid + i0);
        const longlong2 g1 =
            *reinterpret_cast<const longlong2*>(gid + i0 + 2);
        gr[0] = g0.x, gr[1] = g0.y, gr[2] = g1.x, gr[3] = g1.y;
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) ok[e] = true;
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        ok[e] = i0 + e < n;
        if (ok[e]) {
          pr[e] = p[i0 + e];
          vr[e] = v[i0 + e];
          if constexpr (GB > 1) gr[e] = gid[i0 + e];
        }
      }
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      if (ok[e]) add_tuple<O, GB>(pr[e], vr[e], gr[e], acc);
  }

  warp_transpose_sum<C>(acc);
  __shared__ float red[kWarps][kWarp * C];
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
#pragma unroll
  for (int c = 0; c < C; ++c) red[warp][kWarp * c + lane] = acc[kWarp * c];
  __syncthreads();
  if (threadIdx.x < width) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
    part[static_cast<long long>(threadIdx.x) * tiles + blockIdx.x] = s;
  }
}

// Lane 0 gets the warp's sum of s (a fixed tree).
__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = kWarp / 2; off >= 1; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  return s;
}

// out[k] = sum over the column part[k * rows, (k + 1) * rows).
__global__ void __launch_bounds__(kRowThreads)
cumulant_rows_sum(const float* __restrict__ part, float* __restrict__ out,
                  int rows) {
  const float* col = part + static_cast<long long>(blockIdx.x) * rows;
  float s = 0.0f;
  int r = threadIdx.x;
  for (; r + 3 * kRowThreads < rows; r += 4 * kRowThreads) {
    const float a = col[r], b = col[r + kRowThreads];
    const float c = col[r + 2 * kRowThreads], d = col[r + 3 * kRowThreads];
    s += a;
    s += b;
    s += c;
    s += d;
  }
  for (; r < rows; r += kRowThreads) s += col[r];
  __shared__ float red[kRowThreads / kWarp];
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  s = warp_sum(s);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = warp_sum(red[lane]);
    if (lane == 0) out[blockIdx.x] = s;
  }
}

}  // namespace

// out (num_groups, orders) from n tuples in `tiles` = ceil(n / kTile)
// tiles; gids is read only when num_groups > 1.  partial holds
// num_groups * orders * tiles floats.
extern "C" int cumulant_sums_launch(const float* p, const float* v,
                                    const long long* gids, float* partial,
                                    float* out, int n, int tiles,
                                    int num_groups, int orders,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_groups < 1 || num_groups > kMaxTileGroups || orders < 1 ||
      orders > kMaxOrder || tiles != static_cast<int>(blocks_for(n, kTile)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int width = num_groups * orders;
  if (tiles > 0) {
    dispatch_orders(orders, [&](auto o) {
      constexpr int O = decltype(o)::value;
      if (num_groups == 1)
        cumulant_tiles<O, 1><<<tiles, kThreads, 0, s>>>(p, v, gids, partial,
                                                        n, tiles, width);
      else
        cumulant_tiles<O, kMaxTileGroups><<<tiles, kThreads, 0, s>>>(
            p, v, gids, partial, n, tiles, width);
    });
  }
  cumulant_rows_sum<<<width, kRowThreads, 0, s>>>(partial, out, tiles);
  return static_cast<int>(cudaGetLastError());
}
