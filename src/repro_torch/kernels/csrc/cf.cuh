// Device code shared by the two CF kernels (logcf.cu, group_logcf.cu):
// the exact integer phase, the twiddle table, one CF term and the
// frequency-by-tuple partial kernel.
//
// Phase.  (k * a) mod N stays integer-exact for N <= 2^20 without an
// integer division: k = k_hi * 2^S + k_lo and a2 = (a << S) mod N (the
// split-modmult of the TPU kernels; a and a2 come from the host,
// kernels/pb_cf.py split_modmult_operands) give x = k_hi * a2 + k_lo * a
// < 2^32, and a Barrett step with magic = floor(2^32 / N), computed once
// on the host, leaves x - umulhi(x, magic) * N in [0, 2N); one unsigned
// min folds it into [0, N).  N = 1 has a = a2 = 0 and magic 0, so the
// phase is 0.
//
// Twiddles.  The phase is an integer in [0, N), so cos and sin of the
// angle are a table lookup: cf_twiddles fills the N entries once per
// launch.  An entry holds exactly the reference's twiddle -- the angle
// (2 pi / N) * phase formed in float64 and rounded once to float32
// (kernels/ref.py _cf_terms), then float32 cosf / sinf of it, the
// functions the plain version runs on the card.  An exact-angle table
// would be closer to the true CF but not to the plain version: where
// |q + p w| is near 0 (p near 1/2, angle near pi) one float32 rounding of
// the angle moves a term's angle by up to ~1e-2, beyond the 2e-5 of
// sum |term| the kernel is held to in a group of four tuples.  logcf
// copies the table into shared memory up to DIRECT_TABLE_MAX = 4096
// entries (32 KB, Q6's N; 8% faster there than device memory, PERF.md);
// above it, and in group_logcf always, the kernels read it from device
// memory through the cache (8 MB at N = 2^20).
//
// Bank conflicts.  The 32 lanes of a warp read entries a apart, so a read
// conflicts 2^v ways where 2^v divides a (at most 16 ways for the 8-byte
// entries of a half-warp), 3 ways on average over uniform values.  No
// swizzle: a pair runs dozens of ALU instructions (logf, atan2f) against
// one 8-byte shared load, so the load pipe has room for the average
// conflict, and a swizzle would add integer work to every pair (values 64
// apart cost 1.25x the time of uniform ones on an H100, PERF.md).
//
// Every transcendental is IEEE float32 (logf, atan2f; no fast math), and
// every sum runs in a fixed order, so a launch gives the same bits every
// run.  A tuple with p == 0 contributes exactly (0, +-0) -- re = 1, im =
// +-0, logf(1) = 0, atan2f(+-0, 1) = +-0 -- and adding a zero never changes
// an accumulator that starts at +0, so such tuples are skipped: the skip is
// bit-identical to computing them.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr double kPi = 3.141592653589793;

// x mod n for x < 2^32, n <= 2^20, magic = floor(2^32 / n) (0 for n = 1).
__device__ __forceinline__ unsigned reduce_phase(unsigned x, unsigned n,
                                                 unsigned magic) {
  const unsigned r = x - __umulhi(x, magic) * n;  // in [0, 2n)
  return min(r, r - n);
}

// (k * a) mod n from k = k_hi * 2^S + k_lo and a2 = (a << S) mod n.
__device__ __forceinline__ unsigned cf_phase(unsigned k_hi, unsigned k_lo,
                                             unsigned a, unsigned a2,
                                             unsigned n, unsigned magic) {
  return reduce_phase(k_hi * a2 + k_lo * a, n, magic);
}

// tab[j] = (cos, sin) of float32((2 pi / n) * j), j < n.
__global__ void cf_twiddles(float2* __restrict__ tab, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const float theta = static_cast<float>(2.0 * kPi / n * j);
  tab[j] = make_float2(cosf(theta), sinf(theta));
}

// log|.|^2 and arg of q + p w (w = cos + i sin): the caller halves the
// summed log|.|^2 once (a power-of-two scale is exact, so the halved sum
// is the sum of halved terms bit for bit).
__device__ __forceinline__ void cf_term(float p, float q, float2 w,
                                        float& lg, float& an) {
  const float re = q + p * w.x;
  const float im = p * w.y;
  lg = logf(fmaxf(re * re + im * im, 1e-30f));
  an = atan2f(im, re);
}

// The table in shared memory (kSmem, N <= 4096) or the device-memory table
// itself; callers sync before the first lookup.
template <bool kSmem>
__device__ __forceinline__ const float2* table(float2* smem_tab,
                                               const float2* twiddles,
                                               int n) {
  if (!kSmem) return twiddles;
  for (int j = threadIdx.x; j < n; j += blockDim.x) smem_tab[j] = twiddles[j];
  return smem_tab;
}

constexpr int kCfThreads = 256;  // repro_torch.kernels.pb_cf.FREQ_THREADS
constexpr int kCfTile = 512;     // tuples staged per round
constexpr int kCfWarps = kCfThreads / 32;
constexpr int kCfRounds = kCfTile / kCfThreads;

// One staged tuple: p, 1 - p and the two phase operands.
struct __align__(16) CfTuple {
  float p, q;
  unsigned a, a2;
};

// Dynamic shared memory of cf_partial: the tuple tile, then the table.
inline size_t cf_partial_smem(bool smem_table, int num_freq) {
  return kCfTile * sizeof(CfTuple) +
         (smem_table ? static_cast<size_t>(num_freq) * sizeof(float2) : 0);
}

// part_lg[row, f], part_an[row, f] = sums over the tuples of row `row` of
// the CF terms at frequency k = freq_lo + f (f < freq_cnt), one thread per
// frequency.  Row r covers tuples [row_start[r], row_end[r]), or
// [r * split_len, min((r + 1) * split_len, n)) when row_start is null.
// Work items (row, 256-frequency block) go to the resident blocks in turn.
// A block stages kCfTile tuples at a time and keeps only those with
// p != 0, in order (warp ballots and a prefix over the warps), as
// (p, 1 - p, a, a2); every thread then streams the same compacted tile
// (broadcast reads), and a warp whose frequencies all lie past freq_cnt
// skips it.  Writes raw log|.|^2 sums (not halved).
template <bool kSmem>
__global__ void __launch_bounds__(kCfThreads)
cf_partial(const float* __restrict__ p, const int* __restrict__ a,
           const int* __restrict__ a2, const float2* __restrict__ twiddles,
           const int* __restrict__ row_start,
           const int* __restrict__ row_end, int rows, int split_len, int n,
           float* __restrict__ part_lg, float* __restrict__ part_an,
           int freq_lo, int freq_cnt, unsigned num_freq, unsigned magic,
           int shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_live_count[kCfRounds * kCfWarps];
  CfTuple* tile = reinterpret_cast<CfTuple*>(smem);
  const float2* tab = table<kSmem>(
      reinterpret_cast<float2*>(smem + kCfTile * sizeof(CfTuple)), twiddles,
      num_freq);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int fblocks = (freq_cnt + kCfThreads - 1) / kCfThreads;
  const int items = fblocks * rows;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int row = item / fblocks, fb = item % fblocks;
    int lo, hi;
    if (row_start != nullptr) {
      lo = row_start[row];
      hi = row_end[row];
    } else {
      lo = row * split_len;
      hi = min(lo + split_len, n);
    }
    const int f = fb * kCfThreads + threadIdx.x;
    const unsigned k = freq_lo + min(f, freq_cnt - 1);
    const unsigned k_hi = k >> shift;
    const unsigned k_lo = k & ((1u << shift) - 1u);
    const bool warp_live = fb * kCfThreads + warp * 32 < freq_cnt;
    float lg = 0.0f, an = 0.0f;
    for (int t0 = lo; t0 < hi; t0 += kCfTile) {
      const int m = min(kCfTile, hi - t0);
      __syncthreads();  // the table is in place; the last tile is consumed
      float pv[kCfRounds];
      unsigned av[kCfRounds], a2v[kCfRounds], live[kCfRounds];
#pragma unroll
      for (int r = 0; r < kCfRounds; ++r) {
        const int i = r * kCfThreads + threadIdx.x;
        pv[r] = i < m ? p[t0 + i] : 0.0f;
        av[r] = i < m ? static_cast<unsigned>(a[t0 + i]) : 0u;
        a2v[r] = i < m ? static_cast<unsigned>(a2[t0 + i]) : 0u;
        live[r] = __ballot_sync(0xffffffffu, pv[r] != 0.0f);
        if (lane == 0) warp_live_count[r * kCfWarps + warp] = __popc(live[r]);
      }
      __syncthreads();
      int base = 0, count = 0;
#pragma unroll
      for (int r = 0; r < kCfRounds; ++r) {
        for (int j = 0; j < kCfWarps; ++j) {
          const int c = warp_live_count[r * kCfWarps + j];
          base += j < warp ? c : 0;
          count += c;
        }
        if (pv[r] != 0.0f)
          tile[base + __popc(live[r] & below)] =
              CfTuple{pv[r], 1.0f - pv[r], av[r], a2v[r]};
        base = count;
      }
      __syncthreads();
      if (!warp_live) continue;
      for (int i = 0; i < count; ++i) {
        const CfTuple u = tile[i];
        float tl, ta;
        cf_term(u.p, u.q,
                tab[cf_phase(k_hi, k_lo, u.a, u.a2, num_freq, magic)], tl,
                ta);
        lg += tl;
        an += ta;
      }
    }
    if (f < freq_cnt) {
      part_lg[static_cast<long long>(row) * freq_cnt + f] = lg;
      part_an[static_cast<long long>(row) * freq_cnt + f] = an;
    }
  }
}

// Blocks of `kernel` that fit on the card at once (at least one).
template <typename Kernel>
inline int resident_blocks(Kernel kernel, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kCfThreads,
                                                smem);
  return sms * per_sm > 0 ? sms * per_sm : 1;
}

// The twiddle table of an N-point grid into `tab` (N float2).
inline void launch_cf_twiddles(float2* tab, int num_freq, cudaStream_t s) {
  cf_twiddles<<<(num_freq + 255) / 256, 256, 0, s>>>(tab, num_freq);
}

// One cf_partial launch over `rows` rows, on at most the resident blocks
// (the caller reads cudaGetLastError() once after all its launches).
inline void launch_cf_partial(const float* p, const int* a, const int* a2,
                              const float2* tab, const int* row_start,
                              const int* row_end, int rows, int split_len,
                              int n, float* part_lg, float* part_an,
                              int freq_lo, int freq_cnt, unsigned num_freq,
                              unsigned magic, int shift, bool smem_table,
                              cudaStream_t s) {
  if (rows == 0 || freq_cnt == 0) return;
  const long long fblocks = (freq_cnt + kCfThreads - 1) / kCfThreads;
  const size_t smem = cf_partial_smem(smem_table, num_freq);
  auto kernel = smem_table ? cf_partial<true> : cf_partial<false>;
  const int grid = static_cast<int>(std::min<long long>(
      fblocks * rows, resident_blocks(kernel, smem)));
  kernel<<<grid, kCfThreads, smem, s>>>(p, a, a2, tab, row_start, row_end,
                                        rows, split_len, n, part_lg,
                                        part_an, freq_lo, freq_cnt,
                                        num_freq, magic, shift);
}

}  // namespace
