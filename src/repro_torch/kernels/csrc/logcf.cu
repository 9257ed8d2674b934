// Scalar summed log characteristic function -- replaces the TPU kernel
// repro/kernels/pb_cf.py:41 `_logcf_kernel` (entry `logcf`, :110).
//
//   la[k] = sum_i 0.5 log|q_i + p_i w^{k a_i}|^2
//   an[k] = sum_i arg(q_i + p_i w^{k a_i}),   w = exp(2 pi i / N), k < N
//
// Bound on the H100: operations.  Every (frequency, tuple) pair costs a
// sincosf, a logf and an atan2f plus ~12 float ops, against 8 input bytes
// per tuple and 8 output bytes per frequency; at the Q6 shape (N = 4096,
// 750,000 tuples per canonical chunk) that is ~3e9 pairs on 6 MB.
//
// Design: one thread per frequency k, 256 frequencies per block.  The
// tuple column is cut into `splits` contiguous ranges (grid.y); a block
// stages 1024 tuples of p, a and a2 at a time in shared memory, so each
// tuple byte is read from memory once per block and every thread streams
// the same tile.  Each block writes a partial (split, k) sum; rows_sum
// adds the splits in order.  No atomics: the result is the same bits on
// every run.  The phase is integer-exact through the split-modmult
// (exact for N <= 2^20, the dispatch guard).
#include "common.cuh"

namespace {

constexpr int kFreqThreads = 256;
constexpr int kTupleTile = 1024;

__global__ void logcf_partial(const float* __restrict__ p,
                              const int* __restrict__ a,
                              const int* __restrict__ a2,
                              float* __restrict__ part_la,
                              float* __restrict__ part_an, int n,
                              int num_freq, int shift, int split_len) {
  __shared__ float sp[kTupleTile];
  __shared__ int sa[kTupleTile];
  __shared__ int sa2[kTupleTile];
  const int k = blockIdx.x * kFreqThreads + threadIdx.x;
  const int kc = min(k, num_freq - 1);
  const int k_hi = kc >> shift;
  const int k_lo = kc & ((1 << shift) - 1);
  const float w = static_cast<float>(2.0 * 3.14159265358979323846 /
                                     num_freq);
  const int lo = blockIdx.y * split_len;
  const int hi = min(lo + split_len, n);
  float la = 0.0f, an = 0.0f;
  for (int t0 = lo; t0 < hi; t0 += kTupleTile) {
    const int m = min(kTupleTile, hi - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += kFreqThreads) {
      sp[i] = p[t0 + i];
      sa[i] = a[t0 + i];
      sa2[i] = a2[t0 + i];
    }
    __syncthreads();
    for (int i = 0; i < m; ++i) {
      float tl, ta;
      cf_term(sp[i], modmult_phase(k_hi, k_lo, sa[i], sa2[i], num_freq), w,
              tl, ta);
      la += tl;
      an += ta;
    }
  }
  if (k < num_freq) {
    part_la[(long long)blockIdx.y * num_freq + k] = la;
    part_an[(long long)blockIdx.y * num_freq + k] = an;
  }
}

}  // namespace

extern "C" int logcf_launch(const float* p, const int* a, const int* a2,
                            float* part_la, float* part_an, float* la,
                            float* an, int n, int num_freq, int shift,
                            int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int split_len = (n + splits - 1) / splits;
  dim3 grid(blocks_for(num_freq, kFreqThreads), splits);
  logcf_partial<<<grid, kFreqThreads, 0, s>>>(p, a, a2, part_la, part_an, n,
                                              num_freq, shift, split_len);
  rows_sum<<<blocks_for(num_freq, 256), 256, 0, s>>>(part_la, la, splits,
                                                     num_freq);
  rows_sum<<<blocks_for(num_freq, 256), 256, 0, s>>>(part_an, an, splits,
                                                     num_freq);
  return static_cast<int>(cudaGetLastError());
}
