// Grouped one-pass cumulant sums over gid-sorted tuples -- route (b) of
// the port of the TPU kernel repro/kernels/group_cumulants.py:57
// `_group_cumulants_kernel` (entry `group_cumulant_sums`, :120), for more
// than kMaxTileGroups groups (Q3 has 262,144; route (a), a few groups and
// no sort, is cumulants.cu).
//
//   s[g, j] = sum_{i in g} v_i^j kappa_j(p_i),   j = 1..orders
//
// Bound on the H100: bytes.  Per canonical chunk the function reads p, v
// and the path's int64 gids (16 bytes a tuple) and writes G x orders
// floats -- 12 MB in, 8.4 MB out at Q3's G = 262,144 -- against
// O^2 + 4 O - 1 float ops per tuple.  Most of Q3's groups hold 1-4 live
// tuples, so the design is about not spending a block, a piece row or a
// host round trip on each.
//
// Design.  The wrapper sorts the tuples by gid as int32 keys (stable: the
// order within a group is the order of its sum; half the radix passes of
// int64 keys) and makes nothing else on the host side:
//  - cumulant_group_bounds: bounds[g] = the first sorted tuple of group g
//    (a binary search per group), bounds[G] = the end of the last.
//  - A group of at most kShortMax tuples is summed directly by the thread
//    that writes it (group_cumulants_direct), all orders in registers.
//  - A longer group is cut into pieces of at most kPiece tuples, and its
//    piece j has a fixed slot, lo / kSlot + j, with lo the group's first
//    tuple and kSlot = kShortMax + 1.  Long groups start at least kSlot
//    tuples apart and a group of c > kShortMax tuples has at most
//    floor(c / kSlot) pieces, so no two pieces share a slot; and the tuple
//    kSlot * s + kShortMax lies inside the group that owns slot s.  So
//    the table needs no count, no scan and no host sync: a slot finds its
//    piece from that one tuple's gid and the group's bounds, and the
//    n / kSlot slots are sized on the host from n alone
//    (kernels/segments.py slot_pieces is this lookup in PyTorch, held
//    against the counted piece table by the CPU tests).
//  - group_cumulants_pieces: a block looks up 32 slots at once (one warp,
//    one ballot), every grid-th slot so that a long group's pieces spread
//    over the card, and sums each live piece with all its threads --
//    thread t takes tuples start + t, start + t + 256, ... in order --
//    then warp_transpose_sum and the warps' rows in order into the slot's
//    row.
//  - group_cumulants_direct, one thread per group, sums a short group's
//    tuples in order and writes its row once (zeros for an empty group),
//    16 bytes at a time where the orders allow; the warp folds each of its
//    long groups' slot rows together (a 750,000-tuple group has 733).
// No atomics: the same bits on every run.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kShortMax = 32;         // group_cumulants.SHORT_MAX
constexpr int kSlot = kShortMax + 1;  // group_cumulants.SLOT
constexpr int kPiece = 1024;          // group_cumulants.PIECE

__device__ __forceinline__ int piece_count(int tuples) {
  return tuples > kShortMax ? (tuples + kPiece - 1) / kPiece : 0;
}

// bounds[g] = the first i with gs[i] >= g, for g <= num_groups.
__global__ void __launch_bounds__(kThreads)
cumulant_group_bounds(const int* __restrict__ gs,
                      int* __restrict__ bounds, int n, int num_groups) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g > num_groups) return;
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (gs[mid] < g)
      lo = mid + 1;
    else
      hi = mid;
  }
  bounds[g] = lo;
}

template <int O>
__global__ void __launch_bounds__(kThreads)
group_cumulants_pieces(const float* __restrict__ p,
                       const float* __restrict__ v,
                       const int* __restrict__ gs,
                       const int* __restrict__ bounds,
                       float* __restrict__ part, int slots, int num_groups) {
  __shared__ int start[kWarp], end[kWarp];
  __shared__ unsigned live_mask;
  __shared__ float red[kWarps][kWarp];
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  if (warp == 0) {
    // slots b, b + grid, b + 2 grid, ...: a long group's consecutive slots
    // land in different blocks
    const int s = blockIdx.x + gridDim.x * lane;
    int lo_i = 0, hi_i = 0;
    if (s < slots) {
      // the tuple kSlot * s + kShortMax < n lies in the owner, if any
      const int g = gs[static_cast<long long>(s) * kSlot + kShortMax];
      if (g >= 0 && g < num_groups) {
        const int lo = bounds[g], hi = bounds[g + 1];
        const int j = s - lo / kSlot;
        if (j >= 0 && j < piece_count(hi - lo)) {
          lo_i = lo + j * kPiece;
          hi_i = min(lo_i + kPiece, hi);
        }
      }
    }
    start[lane] = lo_i;
    end[lane] = hi_i;
    const unsigned live = __ballot_sync(0xffffffffu, hi_i > lo_i);
    if (lane == 0) live_mask = live;
  }
  __syncthreads();
  // the block sums each live piece: thread t takes tuples start + t,
  // start + t + 256, ... in order; then the warps' trees, then the 8 warps
  // in order
  for (unsigned live = live_mask; live; live &= live - 1) {
    const int b = __ffs(live) - 1;
    const int hi = end[b];
    float acc[kWarp] = {};
#pragma unroll 4
    for (int i = start[b] + threadIdx.x; i < hi; i += kThreads)
      cumulant_add<O>(p[i], v[i], acc);
    warp_transpose_sum<1>(acc);
    red[warp][lane] = acc[0];
    __syncthreads();
    if (threadIdx.x < O) {
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[w][threadIdx.x];
      part[(static_cast<long long>(b) * gridDim.x + blockIdx.x) * O +
           threadIdx.x] = sum;
    }
    __syncthreads();
  }
}

template <int O>
__global__ void __launch_bounds__(kThreads)
group_cumulants_direct(const float* __restrict__ p,
                       const float* __restrict__ v,
                       const int* __restrict__ bounds,
                       const float* __restrict__ part,
                       float* __restrict__ out, int num_groups) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int g = blockIdx.x * kThreads + threadIdx.x;
  int lo = 0, hi = 0;
  if (g < num_groups) {
    lo = bounds[g];
    hi = bounds[g + 1];
  }
  // The warp folds its long groups one at a time: lane l adds the group's
  // slot rows l, l + 32, ... in order, a fixed tree adds the lanes, and
  // lane j < O writes order j.
  const bool long_group = hi - lo > kShortMax;
  for (unsigned longs = __ballot_sync(0xffffffffu, long_group); longs;
       longs &= longs - 1) {
    const int src = __ffs(longs) - 1;
    const int glo = __shfl_sync(0xffffffffu, lo, src);
    const int pieces = piece_count(__shfl_sync(0xffffffffu, hi, src) - glo);
    const float* rows = part + static_cast<long long>(glo / kSlot) * O;
    float acc[kWarp] = {};
    for (int r = lane; r < pieces; r += kWarp) {
#pragma unroll
      for (int j = 0; j < O; ++j) acc[j] += rows[r * O + j];
    }
    warp_transpose_sum<1>(acc);
    if (lane < O)
      out[static_cast<long long>(g - lane + src) * O + lane] = acc[0];
  }
  if (g >= num_groups || long_group) return;
  float acc[O] = {};
  for (int i = lo; i < hi; ++i) cumulant_add<O>(p[i], v[i], acc);
  store_row<O>(out + static_cast<long long>(g) * O, acc);
}

}  // namespace

// out (num_groups, orders) from n tuples sorted by gid (gs).
// bounds holds num_groups + 1 ints and partial slots * orders floats,
// slots = n / kSlot.
extern "C" int group_cumulant_sums_launch(const float* p, const float* v,
                                          const int* gs, int* bounds,
                                          float* partial, float* out, int n,
                                          int slots, int num_groups,
                                          int orders, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_groups < 1 || orders < 1 || orders > kMaxOrder ||
      slots != n / kSlot)
    return static_cast<int>(cudaErrorInvalidValue);
  cumulant_group_bounds<<<blocks_for(num_groups + 1LL, kThreads), kThreads,
                          0, s>>>(gs, bounds, n, num_groups);
  dispatch_orders(orders, [&](auto o) {
    constexpr int O = decltype(o)::value;
    if (slots > 0)
      group_cumulants_pieces<O><<<blocks_for(slots, kWarp), kThreads, 0, s>>>(
          p, v, gs, bounds, partial, slots, num_groups);
    group_cumulants_direct<O><<<blocks_for(num_groups, kThreads), kThreads,
                                0, s>>>(p, v, bounds, partial, out,
                                        num_groups);
  });
  return static_cast<int>(cudaGetLastError());
}
