// Grouped summed log characteristic function over a frequency window --
// replaces the TPU kernel repro/kernels/group_cf.py:67
// `_group_logcf_kernel` (entry `group_logcf`, :141 / `_group_logcf`, :177).
//
//   la[g, f] = sum_{i in g} 0.5 log|q_i + p_i w^{k a_i}|^2
//   an[g, f] = sum_{i in g} arg(q_i + p_i w^{k a_i}),   k = freq_lo + f
//
// Bound on the H100: bytes at the Q18 shape.  The work is n * cnt pairs
// (750,000 tuples x 89 frequencies per canonical chunk and slab, ~7e7
// pairs of ~15 ops), while the output is two (G, cnt) float32 arrays of
// 1.5M x 89 -- about 1.07 GB written per launch.
//
// Design: tuples arrive sorted by group id.  The wrapper cuts every
// group's contiguous tuple range into pieces of at most kPiece tuples.
// One block per (piece, 128-frequency tile) stages the piece in shared
// memory and each thread sums its frequency over the piece, writing a
// partial (piece, f).  segment_rows_sum then adds each group's contiguous
// pieces in order, one thread per output element, and writes zeros for
// empty groups -- a coalesced pass over the output, which is the bound.
// The work is exactly n * cnt pairs whatever the skew (8 huge groups or
// 1.5M groups of 4 rows); the TPU's 0/1 segment-mask matmul, which would
// recompute a tuple tile once per group block it touches, is gone, and so
// is any TF32 rounding.  No atomics.
#include "common.cuh"

namespace {

constexpr int kFreqThreads = 128;
constexpr int kPiece = 1024;  // repro_torch.kernels.group_cf.PIECE

__global__ void group_logcf_partial(const float* __restrict__ p,
                                    const int* __restrict__ a,
                                    const int* __restrict__ a2,
                                    const int* __restrict__ piece_start,
                                    const int* __restrict__ piece_end,
                                    float* __restrict__ part_la,
                                    float* __restrict__ part_an,
                                    int num_freq, int shift, int freq_lo,
                                    int freq_cnt) {
  __shared__ float sp[kPiece];
  __shared__ int sa[kPiece];
  __shared__ int sa2[kPiece];
  const int piece = blockIdx.x;
  const int lo = piece_start[piece];
  const int m = piece_end[piece] - lo;
  for (int i = threadIdx.x; i < m; i += kFreqThreads) {
    sp[i] = p[lo + i];
    sa[i] = a[lo + i];
    sa2[i] = a2[lo + i];
  }
  __syncthreads();
  const int f = blockIdx.y * kFreqThreads + threadIdx.x;
  const int k = min(freq_lo + f, num_freq - 1);
  const int k_hi = k >> shift;
  const int k_lo = k & ((1 << shift) - 1);
  const float w = static_cast<float>(2.0 * 3.14159265358979323846 /
                                     num_freq);
  float la = 0.0f, an = 0.0f;
  for (int i = 0; i < m; ++i) {
    float tl, ta;
    cf_term(sp[i], modmult_phase(k_hi, k_lo, sa[i], sa2[i], num_freq), w,
            tl, ta);
    la += tl;
    an += ta;
  }
  if (f < freq_cnt) {
    part_la[(long long)piece * freq_cnt + f] = la;
    part_an[(long long)piece * freq_cnt + f] = an;
  }
}

}  // namespace

extern "C" int group_logcf_launch(const float* p, const int* a,
                                  const int* a2, const int* piece_start,
                                  const int* piece_end,
                                  const int* group_first, float* part_la,
                                  float* part_an, float* la, float* an,
                                  int n_pieces, int num_groups,
                                  int num_freq, int shift, int freq_lo,
                                  int freq_cnt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_pieces > 0) {
    dim3 grid(n_pieces, blocks_for(freq_cnt, kFreqThreads));
    group_logcf_partial<<<grid, kFreqThreads, 0, s>>>(
        p, a, a2, piece_start, piece_end, part_la, part_an, num_freq, shift,
        freq_lo, freq_cnt);
  }
  const long long outs = (long long)num_groups * freq_cnt;
  segment_rows_sum<<<blocks_for(outs, 256), 256, 0, s>>>(
      part_la, group_first, la, num_groups, freq_cnt);
  segment_rows_sum<<<blocks_for(outs, 256), 256, 0, s>>>(
      part_an, group_first, an, num_groups, freq_cnt);
  return static_cast<int>(cudaGetLastError());
}
