// Scalar one-pass cumulant sums -- replaces the TPU kernel
// repro/kernels/cumulants.py:31 `_cumulants_kernel` (entry
// `cumulant_sums`, :64).
//
//   s_j = sum_i v_i^j kappa_j(p_i),   j = 1..orders (orders <= 12)
//
// Bound on the H100: bytes and operations are both tiny at the Q6 shape
// (750,000 tuples = 6 MB read, ~150 float ops per tuple at orders = 8, so
// a few microseconds either way); in practice the two launches' fixed cost
// dominates.
//
// Design: 256 threads per block, 1024 tuples per block, coalesced strided
// loads.  Each thread keeps `orders` accumulators in registers, evaluates
// every kappa_j by one Horner sweep over the coefficient table staged in
// shared memory and v^j by iterated multiplication, then a fixed-tree
// block reduction writes one partial row per block; rows_sum adds the
// rows in block order.  No atomics.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;

__global__ void cumulants_partial(const float* __restrict__ p,
                                  const float* __restrict__ v,
                                  const float* __restrict__ coef,
                                  float* __restrict__ partial, int n,
                                  int orders) {
  __shared__ float sc[kMaxOrder * (kMaxOrder + 1)];
  for (int i = threadIdx.x; i < orders * (orders + 1); i += kThreads)
    sc[i] = coef[i];
  __syncthreads();
  float acc[kMaxOrder];
#pragma unroll
  for (int j = 0; j < kMaxOrder; ++j) acc[j] = 0.0f;
  const int lo = blockIdx.x * kTile;
  const int hi = min(lo + kTile, n);
  for (int i = lo + threadIdx.x; i < hi; i += kThreads)
    cumulant_accumulate(p[i], v[i], sc, orders, acc);
  block_reduce_orders<kThreads>(acc, orders,
                                partial + (long long)blockIdx.x * orders);
}

}  // namespace

extern "C" int cumulant_sums_launch(const float* p, const float* v,
                                    const float* coef, float* partial,
                                    float* out, int n, int orders,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = static_cast<int>(blocks_for(n, kTile));
  cumulants_partial<<<blocks, kThreads, 0, s>>>(p, v, coef, partial, n,
                                                orders);
  rows_sum<<<1, 32, 0, s>>>(partial, out, blocks, orders);
  return static_cast<int>(cudaGetLastError());
}
