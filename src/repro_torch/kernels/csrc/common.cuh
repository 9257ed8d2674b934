// Device helpers shared by the two cumulant kernels of the port (the CF
// kernels' own are in cf.cuh).
//
// Everything here is float32 (no fast math).  Sums run in a fixed order in
// every kernel -- one thread's sequential loop, a fixed shared-memory
// tree, then a row-ordered second pass -- so a launch gives the same bits
// every run.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kMaxOrder = 12;  // repro_torch.core.approx.MAX_ORDER

// acc[j] += kappa_{j+1}(p) * v^{j+1} for j < orders: one Horner sweep over
// the (orders, orders + 1) coefficient table coef (row j = kappa_{j+1},
// ascending powers), and v^j by iterated multiplication.
__device__ __forceinline__ void cumulant_accumulate(float p, float v,
                                                    const float* coef,
                                                    int orders,
                                                    float* acc) {
  const int deg = orders;
  float kap[kMaxOrder];
#pragma unroll
  for (int j = 0; j < kMaxOrder; ++j)
    if (j < orders) kap[j] = coef[j * (deg + 1) + deg];
  for (int d = deg - 1; d >= 0; --d) {
#pragma unroll
    for (int j = 0; j < kMaxOrder; ++j)
      if (j < orders) kap[j] = kap[j] * p + coef[j * (deg + 1) + d];
  }
  float vp = v;
#pragma unroll
  for (int j = 0; j < kMaxOrder; ++j) {
    if (j < orders) {
      acc[j] += kap[j] * vp;
      vp *= v;
    }
  }
}

// Fixed-tree block reduction of acc[0..orders) over blockDim.x (a power of
// two) threads; thread j < orders writes the block's sum of order j.
template <int kThreads>
__device__ __forceinline__ void block_reduce_orders(const float* acc,
                                                    int orders,
                                                    float* out) {
  __shared__ float red[kMaxOrder][kThreads];
#pragma unroll
  for (int j = 0; j < kMaxOrder; ++j)
    if (j < orders) red[j][threadIdx.x] = acc[j];
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
#pragma unroll
      for (int j = 0; j < kMaxOrder; ++j)
        if (j < orders) red[j][threadIdx.x] += red[j][threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x < orders) out[threadIdx.x] = red[threadIdx.x][0];
}

// out[f] = sum_{r < rows} part[r * width + f], rows in order.
__global__ void rows_sum(const float* __restrict__ part,
                         float* __restrict__ out, int rows, int width) {
  int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= width) return;
  float s = 0.0f;
  for (int r = 0; r < rows; ++r) s += part[(long long)r * width + f];
  out[f] = s;
}

// out[g, f] = sum of part rows [first[g], first[g + 1]) at column f, in
// row order; zero for a group with no rows.
__global__ void segment_rows_sum(const float* __restrict__ part,
                                 const int* __restrict__ first,
                                 float* __restrict__ out, int num_groups,
                                 int width) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)num_groups * width) return;
  int g = static_cast<int>(idx / width);
  int f = static_cast<int>(idx % width);
  float s = 0.0f;
  for (int r = first[g]; r < first[g + 1]; ++r)
    s += part[(long long)r * width + f];
  out[idx] = s;
}

inline unsigned int blocks_for(long long n, int threads) {
  return static_cast<unsigned int>((n + threads - 1) / threads);
}

}  // namespace
