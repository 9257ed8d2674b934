// Grouped one-pass cumulant sums -- replaces the TPU kernel
// repro/kernels/group_cumulants.py:57 `_group_cumulants_kernel` (entry
// `group_cumulant_sums`, :120).
//
//   s[g, j] = sum_{i in g} v_i^j kappa_j(p_i),   j = 1..orders
//
// Bound on the H100: bytes.  Per canonical chunk the kernel reads 8 bytes
// per tuple (p and v, plus the small piece table) and writes G x orders
// floats -- 6 MB in, 8.4 MB out at Q3's G = 262,144 -- against ~150 float
// ops per tuple.
//
// Design: tuples arrive sorted by group id and the wrapper cuts every
// group's range into pieces of at most kPiece tuples (the piece scheme of
// group_logcf.cu).  One 256-thread block per piece accumulates `orders`
// register sums per thread (Horner sweep over the shared-memory
// coefficient table, v^j by iterated multiplication), reduces them with a
// fixed tree and writes one partial row per piece; segment_rows_sum adds
// each group's pieces in order and writes zeros for empty groups.  Only
// the `orders` real rows are ever computed or stored.  No atomics, no
// segment-mask matmul.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void group_cumulants_partial(const float* __restrict__ p,
                                        const float* __restrict__ v,
                                        const float* __restrict__ coef,
                                        const int* __restrict__ piece_start,
                                        const int* __restrict__ piece_end,
                                        float* __restrict__ partial,
                                        int orders) {
  __shared__ float sc[kMaxOrder * (kMaxOrder + 1)];
  for (int i = threadIdx.x; i < orders * (orders + 1); i += kThreads)
    sc[i] = coef[i];
  __syncthreads();
  float acc[kMaxOrder];
#pragma unroll
  for (int j = 0; j < kMaxOrder; ++j) acc[j] = 0.0f;
  const int hi = piece_end[blockIdx.x];
  for (int i = piece_start[blockIdx.x] + threadIdx.x; i < hi; i += kThreads)
    cumulant_accumulate(p[i], v[i], sc, orders, acc);
  block_reduce_orders<kThreads>(acc, orders,
                                partial + (long long)blockIdx.x * orders);
}

}  // namespace

extern "C" int group_cumulant_sums_launch(const float* p, const float* v,
                                          const float* coef,
                                          const int* piece_start,
                                          const int* piece_end,
                                          const int* group_first,
                                          float* partial, float* out,
                                          int n_pieces, int num_groups,
                                          int orders, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_pieces > 0)
    group_cumulants_partial<<<n_pieces, kThreads, 0, s>>>(
        p, v, coef, piece_start, piece_end, partial, orders);
  const long long outs = (long long)num_groups * orders;
  segment_rows_sum<<<blocks_for(outs, 256), 256, 0, s>>>(
      partial, group_first, out, num_groups, orders);
  return static_cast<int>(cudaGetLastError());
}
