// Scalar summed log characteristic function -- replaces the TPU kernel
// repro/kernels/pb_cf.py:41 `_logcf_kernel` (entry `logcf`, :110).
//
//   la[k] = sum_i 0.5 log|q_i + p_i w^{k a_i}|^2
//   an[k] = sum_i arg(q_i + p_i w^{k a_i}),   w = exp(2 pi i / N), k < N
//
// Bound on the H100: operations.  Every (frequency, tuple) pair costs a
// logf and an atan2f plus 9 float ops, against 8 input bytes per tuple
// (p and a) and 8 output bytes per frequency; at the Q6 shape (N = 4096,
// 750,000 tuples per canonical chunk) that is ~1.5e9 pairs on 6 MB.
//
// Design (cf.cuh has the phase, the twiddle table and the partial kernel):
//  - Conjugate symmetry: for real p the CF at N - k is the conjugate of
//    the CF at k, so only k in [0, N/2] is computed (N/2 + 1 frequencies,
//    half the pairs) and cf_mirror_sum writes la[N - k] = la[k] and
//    an[N - k] = -an[k].  k = 0 and, for even N, k = N/2 are their own
//    mirrors.
//  - No integer division and no sincosf per pair: a Barrett-reduced
//    integer phase indexes the twiddle table (shared memory up to N =
//    4096); the pair pays two integer multiply-adds, a umulhi, a table
//    load, a logf and an atan2f.
//  - Tuples with p == 0 (rows a filter dropped: 95% at Q6) are dropped
//    from each staged tile, bit for bit as if computed.
//  - One thread per frequency, 256 per block; the tuple column is cut into
//    `splits` contiguous rows, and the (row, frequency block) items go to
//    the resident blocks in turn.  Each item writes a partial row;
//    cf_mirror_sum adds the rows in order for both outputs in one launch.
//    No atomics: the same bits on every run.
//  - A window: freq_cnt frequencies from freq_lo inside [0, N/2] (a model
//    rank's share of a scalar pass) run the same partial rows and sums,
//    so each frequency has the bits of the whole launch; the window is
//    written as it is, and the caller mirrors the gathered half.
#include "cf.cuh"

namespace {

// la[f], an[f] = the in-order sums of the partial rows (la halved) at
// frequency freq_lo + f, for f < cnt; with `mirror` (the whole half,
// freq_lo = 0) also la[N - k] = la[k] and an[N - k] = -an[k].
__global__ void cf_mirror_sum(const float* __restrict__ part_lg,
                              const float* __restrict__ part_an,
                              float* __restrict__ la, float* __restrict__ an,
                              int rows, int cnt, int N, int mirror) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= cnt) return;
  float lg = 0.0f, a = 0.0f;
  for (int r = 0; r < rows; ++r) {
    lg += part_lg[static_cast<long long>(r) * cnt + k];
    a += part_an[static_cast<long long>(r) * cnt + k];
  }
  lg *= 0.5f;
  la[k] = lg;
  an[k] = a;
  const int m = N - k;
  if (mirror && k > 0 && m != k) {
    la[m] = lg;
    an[m] = -a;
  }
}

}  // namespace

extern "C" int logcf_launch(const float* p, const int* a, const int* a2,
                            float* twiddles,
                            float* part_la, float* part_an, float* la,
                            float* an, int n, int num_freq, int shift,
                            unsigned magic, int smem_table, int splits,
                            int freq_lo, int freq_cnt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int K = num_freq / 2 + 1;
  if (freq_lo < 0 || freq_cnt < 1 || freq_lo + freq_cnt > K)
    return static_cast<int>(cudaErrorInvalidValue);
  const int split_len = (n + splits - 1) / splits;
  float2* tab = reinterpret_cast<float2*>(twiddles);
  launch_cf_twiddles(tab, num_freq, s);
  launch_cf_partial(p, a, a2, tab, nullptr, nullptr, splits, split_len, n,
                    part_la, part_an, freq_lo, freq_cnt, num_freq, magic,
                    shift, smem_table != 0, s);
  cf_mirror_sum<<<(freq_cnt + 255) / 256, 256, 0, s>>>(
      part_la, part_an, la, an, splits, freq_cnt, num_freq,
      freq_lo == 0 && freq_cnt == K);
  return static_cast<int>(cudaGetLastError());
}
