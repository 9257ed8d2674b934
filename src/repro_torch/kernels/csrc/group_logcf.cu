// Grouped summed log characteristic function over a frequency window --
// replaces the TPU kernel repro/kernels/group_cf.py:67
// `_group_logcf_kernel` (entry `group_logcf`, :141 / `_group_logcf`, :177).
//
//   la[g, f] = sum_{i in g} 0.5 log|q_i + p_i w^{k a_i}|^2
//   an[g, f] = sum_{i in g} arg(q_i + p_i w^{k a_i}),   k = freq_lo + f
//
// Bound on the H100: bytes at the Q18 shape.  The work is n * cnt pairs
// (750,000 tuples x 89 frequencies per canonical chunk and slab, ~7e7
// pairs of 11 float ops), while the output is two (G, cnt) float32
// arrays of 1.5M x 89 -- about 1.07 GB written per launch, most of it the
// zeros of the groups the chunk does not touch.
//
// Design: tuples arrive sorted by group id, with the group bounds and the
// piece table of the long groups built once per chunk on the host side
// (kernels/segments.py, hoisted above the frequency slabs).
//  - group_logcf_direct writes every output element exactly once, in one
//    pass: the block's threads walk the flat (g, f) range of a run of
//    groups, so the writes along f coalesce, and (g, f) advance by adding
//    the block width -- no division per element.  A group of at most
//    short_max tuples is summed right there by the thread that owns (g, f)
//    (threads of one group read the same tuples: broadcast loads); an empty
//    group gets its zeros in the same store.
//  - A group longer than short_max was cut into pieces of at most PIECE
//    tuples; cf_partial (cf.cuh) sums each piece at every frequency of the
//    window first, and the direct pass folds the group's pieces in order.
//    So the work stays n * cnt pairs whatever the skew.
//  - Per pair: the Barrett phase, the twiddle table, logf and atan2f
//    (cf.cuh); p == 0 tuples are skipped bit-identically.  The direct
//    pass runs on the resident blocks, each taking runs of groups in turn.
//  - Both passes read the twiddle table from device memory (through L1):
//    a shared-memory copy gained 0.6% at Q18's shape, within noise
//    (PERF.md), since the pass is bound by its stores.
//  No atomics: the same bits on every run.
#include "cf.cuh"

namespace {

constexpr int kRangeOutputs = 8192;  // outputs per run of groups

__global__ void __launch_bounds__(kCfThreads)
group_logcf_direct(const float* __restrict__ p, const int* __restrict__ a,
                   const int* __restrict__ a2,
                   const int* __restrict__ bounds,
                   const int* __restrict__ piece_first,
                   const float* __restrict__ part_lg,
                   const float* __restrict__ part_an,
                   const float2* __restrict__ tab,
                   float* __restrict__ la, float* __restrict__ an,
                   int num_groups, int groups_per_range, int n_ranges,
                   int short_max, int freq_lo, int freq_cnt,
                   unsigned num_freq, unsigned magic, int shift) {
  const int dg = kCfThreads / freq_cnt, df = kCfThreads % freq_cnt;
  const int g_off = threadIdx.x / freq_cnt, f0 = threadIdx.x % freq_cnt;
  const unsigned k_mask = (1u << shift) - 1u;
  for (int range = blockIdx.x; range < n_ranges; range += gridDim.x) {
    const int g_end = min((range + 1) * groups_per_range, num_groups);
    int g = range * groups_per_range + g_off, f = f0;
    while (g < g_end) {
      const int lo = bounds[g], hi = bounds[g + 1];
      float lg = 0.0f, sa = 0.0f;
      if (hi - lo <= short_max) {
        const unsigned k = freq_lo + f;
        const unsigned k_hi = k >> shift, k_lo = k & k_mask;
        for (int i = lo; i < hi; ++i) {
          const float pi = p[i];
          if (pi == 0.0f) continue;
          float tl, ta;
          cf_term(pi, 1.0f - pi,
                  tab[cf_phase(k_hi, k_lo, a[i], a2[i], num_freq, magic)],
                  tl, ta);
          lg += tl;
          sa += ta;
        }
      } else {
        for (int r = piece_first[g]; r < piece_first[g + 1]; ++r) {
          lg += part_lg[static_cast<long long>(r) * freq_cnt + f];
          sa += part_an[static_cast<long long>(r) * freq_cnt + f];
        }
      }
      const long long o = static_cast<long long>(g) * freq_cnt + f;
      la[o] = 0.5f * lg;
      an[o] = sa;
      g += dg;
      f += df;
      if (f >= freq_cnt) {
        f -= freq_cnt;
        ++g;
      }
    }
  }
}

}  // namespace

extern "C" int group_logcf_launch(
    const float* p, const int* a, const int* a2, const int* bounds,
    const int* piece_first, const int* piece_start, const int* piece_end,
    float* twiddles, float* part_la, float* part_an, float* la, float* an,
    int n_pieces, int num_groups, int num_freq, int shift, unsigned magic,
    int short_max, int freq_lo, int freq_cnt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_groups == 0 || freq_cnt == 0)
    return static_cast<int>(cudaGetLastError());
  float2* tab = reinterpret_cast<float2*>(twiddles);
  launch_cf_twiddles(tab, num_freq, s);
  launch_cf_partial(p, a, a2, tab, piece_start, piece_end, n_pieces, 0, 0,
                    part_la, part_an, freq_lo, freq_cnt, num_freq, magic,
                    shift, false, s);
  const int per_range = std::max(1, kRangeOutputs / freq_cnt);
  const int n_ranges = (num_groups + per_range - 1) / per_range;
  const int grid =
      std::min(n_ranges, resident_blocks(group_logcf_direct, 0));
  group_logcf_direct<<<grid, kCfThreads, 0, s>>>(
      p, a, a2, bounds, piece_first, part_la, part_an, tab, la, an,
      num_groups, per_range, n_ranges, short_max, freq_lo, freq_cnt,
      num_freq, magic, shift);
  return static_cast<int>(cudaGetLastError());
}
