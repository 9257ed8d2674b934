// Device code shared by the two cumulant kernels of the port (cumulants.cu,
// group_cumulants.cu; the CF kernels' own is in cf.cuh).
//
//   term_j(p, v) = kappa_j(p) * v^j,   j = 1..O  (O = orders <= 12)
//
// The orders are a template argument, so every loop over them unrolls and
// the accumulators live in registers.  The coefficients of kappa_j are a
// __constant__ table: after unrolling each Horner step is one FFMA that
// reads its coefficient straight from the constant bank, with no load and
// no work for the zero coefficients above degree j.
//
// Everything is float32 (no fast math).  A tuple with p = 0 is computed
// like any other: kappa_j(0) = 0, but 0 * v^j is NaN where v^j overflows,
// and the plain versions keep that NaN.  Every sum runs in a fixed order --
// each thread's tuples in sequence, then fixed shuffle and shared-memory
// trees -- so a launch gives the same bits every run.  No atomics.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxOrder = 12;  // repro_torch.core.approx.MAX_ORDER
constexpr int kWarp = 32;

// kCumulantCoef[j][d] = the coefficient of p^d in kappa_{j+1}(p), rounded
// to float32: repro_torch.core.approx._bernoulli_cumulant_polys()[1:] as
// the plain versions use it (tests/test_torch_kernels.py holds this table
// against it bit for bit).
// cumulant table begin
__constant__ float kCumulantCoef[kMaxOrder][kMaxOrder + 1] = {
    {0.f, 1.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f},
    {0.f, 1.f, -1.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f},
    {0.f, 1.f, -3.f, 2.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f},
    {0.f, 1.f, -7.f, 12.f, -6.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f},
    {0.f, 1.f, -15.f, 50.f, -60.f, 24.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f},
    {0.f, 1.f, -31.f, 180.f, -390.f, 360.f, -120.f, 0.f, 0.f, 0.f, 0.f, 0.f,
     0.f},
    {0.f, 1.f, -63.f, 602.f, -2100.f, 3360.f, -2520.f, 720.f, 0.f, 0.f, 0.f,
     0.f, 0.f},
    {0.f, 1.f, -127.f, 1932.f, -10206.f, 25200.f, -31920.f, 20160.f, -5040.f,
     0.f, 0.f, 0.f, 0.f},
    {0.f, 1.f, -255.f, 6050.f, -46620.f, 166824.f, -317520.f, 332640.f,
     -181440.f, 40320.f, 0.f, 0.f, 0.f},
    {0.f, 1.f, -511.f, 18660.f, -204630.f, 1020600.f, -2739240.f, 4233600.f,
     -3780000.f, 1814400.f, -362880.f, 0.f, 0.f},
    {0.f, 1.f, -1023.f, 57002.f, -874500.f, 5921520.f, -21538440.f,
     46070640.f, -59875200.f, 46569600.f, -19958400.f, 3628800.f, 0.f},
    {0.f, 1.f, -2047.f, 173052.f, -3669006.f, 33105600.f, -158838240.f,
     451725120.f, -801496064.f, 898128000.f, -618710400.f, 239500800.f,
     -39916800.f},
};
// cumulant table end

// kap[j] = kappa_{j+1}(p) by Horner over its own degree j + 1, and
// vp[j] = v^{j+1} by iterated multiplication.
template <int O>
__device__ __forceinline__ void cumulant_factors(float p, float v,
                                                 float (&kap)[O],
                                                 float (&vp)[O]) {
  float w = v;
#pragma unroll
  for (int j = 0; j < O; ++j) {
    float k = kCumulantCoef[j][j + 1];
#pragma unroll
    for (int d = j; d >= 0; --d) k = fmaf(k, p, kCumulantCoef[j][d]);
    kap[j] = k;
    vp[j] = w;
    w *= v;
  }
}

// acc[j] += kappa_{j+1}(p) * v^{j+1}, j < O.
template <int O, int N>
__device__ __forceinline__ void cumulant_add(float p, float v,
                                             float (&acc)[N]) {
  static_assert(N >= O, "accumulator too short");
  float kap[O], vp[O];
  cumulant_factors<O>(p, v, kap, vp);
#pragma unroll
  for (int j = 0; j < O; ++j) acc[j] = fmaf(kap[j], vp[j], acc[j]);
}

// One step of warp_transpose_sum: lanes with bit S set keep the upper
// half of each run of 2S values, the others the lower half.
template <int S, int C>
__device__ __forceinline__ void transpose_step(float (&x)[kWarp * C],
                                               int lane) {
  if constexpr (S >= 1) {
    const bool upper = lane & S;
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const float lo = x[kWarp * c + i], hi = x[kWarp * c + i + S];
        const float got = __shfl_xor_sync(0xffffffffu, upper ? lo : hi, S);
        x[kWarp * c + i] = (upper ? hi : lo) + got;
      }
    }
    transpose_step<S / 2, C>(x, lane);
  }
}

// Sums x[i] over the 32 lanes of a warp for each i < 32 * C and leaves in
// lane l, as x[32 * c] (c < C), the warp's sum of value 32 * c + l.  Each
// of the five steps halves the values a lane keeps: it sends the half its
// partner keeps and adds the partner's copy of its own half, so 32 values
// cost 31 shuffles (a butterfly per value would cost 160).  The steps are
// templates, so every index is a constant and x stays in registers.  The
// tree is the same on every run.
template <int C>
__device__ __forceinline__ void warp_transpose_sum(float (&x)[kWarp * C]) {
  transpose_step<kWarp / 2, C>(x, threadIdx.x & (kWarp - 1));
}

// out[0..O) = acc: 16-byte stores where O allows (the caller's row starts
// at a multiple of O floats of a 16-byte-aligned buffer).
template <int O>
__device__ __forceinline__ void store_row(float* out, const float* acc) {
  if constexpr (O % 4 == 0) {
#pragma unroll
    for (int j = 0; j < O; j += 4)
      *reinterpret_cast<float4*>(out + j) =
          make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
  } else if constexpr (O % 2 == 0) {
#pragma unroll
    for (int j = 0; j < O; j += 2)
      *reinterpret_cast<float2*>(out + j) = make_float2(acc[j], acc[j + 1]);
  } else {
#pragma unroll
    for (int j = 0; j < O; ++j) out[j] = acc[j];
  }
}

// Calls launch(std::integral_constant<int, O>()) for the runtime orders
// O = orders (1..12): one instantiation of each kernel per order.
template <int O = 1, typename Launch>
inline void dispatch_orders(int orders, Launch&& launch) {
  if constexpr (O <= kMaxOrder) {
    if (orders == O) {
      launch(std::integral_constant<int, O>());
      return;
    }
    dispatch_orders<O + 1>(orders, launch);
  }
}

inline unsigned int blocks_for(long long n, int threads) {
  return static_cast<unsigned int>((n + threads - 1) / threads);
}

}  // namespace
