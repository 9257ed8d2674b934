// Schoolbook linear convolution c = a * b in float32 -- replaces the TPU
// kernel repro/kernels/polymul.py:34 `_polymul_kernel` (entry `polymul`,
// :56; call :70), the same function as jnp.convolve:
//
//   c[t] = sum_u a[u] * b[t - u],      t = 0 .. na + nb - 2
//
// Bound on the H100: 2 * na * nb float32 operations over 67 TFLOP/s
// against the bytes of a, b and c (4 * (na + nb + nc)) over 3.35 TB/s; the
// operations bound from about 100 x 100 up.
//
// Design: one block of 256 threads owns 256 consecutive outputs, one per
// thread.  The block walks the u range that reaches its outputs in tiles
// of 256: each tile stages a[u0 .. u0 + 256) and the 511-long window of b
// those products read in shared memory (zero fill at the ragged edges),
// then every thread accumulates its output in a register in increasing u.
// No atomics and no second pass, so every run gives the same bits.  Each
// FMA reads two shared-memory words, so the loop runs well below the FP32
// peak; the product as a Toeplitz GEMM on the tensor cores (`wgmma`) is
// left to a later PR.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void polymul_tile(const float* __restrict__ a,
                             const float* __restrict__ b,
                             float* __restrict__ c, int na, int nb, int nc) {
  __shared__ float sa[kThreads];
  __shared__ float sb[2 * kThreads];
  const int t0 = blockIdx.x * kThreads;
  const int tt = threadIdx.x;
  // u reaches an output of this block iff t0 - (nb - 1) <= u <= t0 + 255.
  const int u_lo = max(0, t0 - (nb - 1));
  const int u_hi = min(na - 1, t0 + kThreads - 1);
  float acc = 0.0f;
  for (int u0 = u_lo; u0 <= u_hi; u0 += kThreads) {
    __syncthreads();  // the previous tile is consumed
    const int ua = u0 + tt;
    sa[tt] = ua < na ? a[ua] : 0.0f;
    // sb[j] = b[t0 - u0 - 255 + j], so b[t - u] = sb[tt - uu + 255].
    const int base = t0 - u0 - (kThreads - 1);
    for (int j = tt; j < 2 * kThreads; j += kThreads) {
      const int ib = base + j;
      sb[j] = (ib >= 0 && ib < nb) ? b[ib] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int uu = 0; uu < kThreads; ++uu)
      acc = fmaf(sa[uu], sb[tt - uu + kThreads - 1], acc);
  }
  const int t = t0 + tt;
  if (t < nc) c[t] = acc;
}

}  // namespace

extern "C" int polymul_launch(const float* a, const float* b, float* c,
                              int na, int nb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = na + nb - 1;
  const unsigned int blocks =
      static_cast<unsigned int>((nc + kThreads - 1) / kThreads);
  polymul_tile<<<blocks, kThreads, 0, s>>>(a, b, c, na, nb, nc);
  return static_cast<int>(cudaGetLastError());
}
