// Schoolbook linear convolution c = a * b in float32 -- replaces the TPU
// kernel repro/kernels/polymul.py:34 `_polymul_kernel` (entry `polymul`,
// :56; call :70), the same function as jnp.convolve:
//
//   c[t] = sum_u a[u] * b[t - u],      t = 0 .. na + nb - 2
//
// The wrapper (kernels/polymul.py) passes the shorter factor as `a`, so u
// runs over the shorter factor, as in the plain version.
//
// Bound on the H100: 2 * na * nb float32 operations over 67 TFLOP/s
// against the bytes of a, b and c (4 * (na + nb + nc)) over 3.35 TB/s; the
// operations bound from about 100 x 100 up.  A design with one output per
// thread reads two shared-memory words per FMA and so runs at 1/8 of the
// FP32 rate at best, and one block per output tile leaves most of the card
// idle at the value layer's 1001 x 1001.
//
// Design, sized by `tiling` in kernels/polymul.py from (na, nb) alone.
// Block (i, s) takes output tile i (kRows consecutive outputs per thread,
// kRows * blockDim.x per tile) and u slice s (a multiple of `chunk` u
// values).  It walks its slice in chunks: each chunk stages a[uc .. uc +
// chunk) and the b window of the tile in shared memory by cp.async (zero
// fill at the ragged edges), the next chunk's copies in flight behind this
// chunk's FMAs.  A thread keeps its kRows accumulators and a sliding window
// of b in registers: per step of four u values it reads one 16-byte run of
// a (the same address for the whole warp, a broadcast) and one new 16-byte
// run of b, and issues 4 * kRows = 48 independent FMAs.  With kRows = 12 a
// warp's b runs lie 3 x 16 bytes apart, so each quarter-warp hits eight
// distinct bank groups: five shared-memory wavefronts per 48 FMA
// instructions, and the FMA pipe, not shared memory, bounds the loop.
// The slices of a tile are then added in increasing s, on one of two
// routes:
//
// - polymul_cluster (one launch, products below WIDE_BLOCKS_FROM): the 16
//   blocks of a tile form a thread block cluster and add the slices
//   through distributed shared memory; no scratch, no second launch, which
//   at the value layer's sizes cost as much as the products themselves.
// - polymul_partial + polymul_fold (two launches, larger products): the
//   blocks write their sums to row s of a float32 scratch (pitch n_tiles *
//   tile, 64-bit offsets), blocks outside the band 0 <= t - u < nb exit at
//   once, and the fold kernel adds the rows, sixteen loads in flight.
//
// At 16,384 x 16,384 and 32,768 x 32,768 the kernel runs at about a third
// of the FP32 rate (chip_smoke.py): the ~500 blocks of a wave stage before
// they compute, and the hardware does not spread them evenly over the SMs
// (capping the blocks per SM ran faster).  Every output sums in increasing
// u within a slice and its
// slices in increasing order, with no atomics, so every run gives the same
// bits, and on the same partition both routes give the same bits.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 12;              // consecutive outputs per thread
constexpr int kRuns = kRows / 4 + 1;   // 4-float runs of the b window
constexpr int kStep = 4 * kRuns;       // u values per unrolled group
constexpr int kMaxChunk = 512;
constexpr int kFoldThreads = 256;
constexpr int kFoldBatch = 16;
constexpr int kMaxCluster = 16;  // blocks of a cluster (non-portable above 8)

__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// The u range of tile i that meets the band: [lo, hi], never empty.
__device__ __forceinline__ void band(int t0, int tile, int na, int nb,
                                     int& lo, int& hi) {
  lo = max(0, t0 - (nb - 1));
  hi = min(na - 1, t0 + tile - 1);
}

// Stage chunk [uc, uc + chunk): sa[k] = a[uc + k], sb[m] =
// b[t0 - uc - chunk + m] for m < tile + chunk, zero outside the factors.
__device__ __forceinline__ void stage(float* sa, float* sb, const float* a,
                                      const float* b, int na, int nb, int uc,
                                      int t0, int chunk, int tile) {
  for (int k = threadIdx.x; k < chunk; k += blockDim.x) {
    const int u = uc + k;
    const bool ok = u < na;
    copy4(sa + k, a + (ok ? u : 0), ok);
  }
  const int jb = t0 - uc - chunk;
  for (int m = threadIdx.x; m < tile + chunk; m += blockDim.x) {
    const int j = jb + m;
    const bool ok = j >= 0 && j < nb;
    copy4(sb + m, b + (ok ? j : 0), ok);
  }
  commit();
}

__device__ __forceinline__ void load4(float (&w)[4], const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}

// acc[r] += sum_{k < chunk} sa[k] * sb[kRows * tid + r - k + chunk], in
// increasing k.  Window slot (g - step) mod kRuns holds the 4-run g of
// sb[base - 4 * step ..]; each step loads the one new run.
__device__ __forceinline__ void accumulate(float (&acc)[kRows],
                                           const float* sa, const float* sb,
                                           int chunk) {
  const float* base = sb + kRows * threadIdx.x + chunk - 4;
  float w[kRuns][4];
#pragma unroll
  for (int g = 1; g < kRuns; ++g) load4(w[g], base + 4 * g);
  for (int k0 = 0; k0 < chunk; k0 += kStep) {
#pragma unroll
    for (int s = 0; s < kRuns; ++s) {
      const int kk = k0 + 4 * s;
      load4(w[(kRuns - s) % kRuns], base - kk);
      float av[4];
      load4(av, sa + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int j = r - q + 4;  // window index, 1 .. kRows + 3
          acc[r] = fmaf(av[q], w[(j / 4 - s + kRuns) % kRuns][j % 4],
                        acc[r]);
        }
      }
    }
  }
}

// The sums of block (tile at t0, slice s) in acc: the chunks of the slice
// that meet the tile's band [lo, hi], staged two buffers deep.
__device__ __forceinline__ void slice_sums(float (&acc)[kRows], float* smem,
                                           const float* a, const float* b,
                                           int na, int nb, int t0, int tile,
                                           int lo, int hi, int s, int slice,
                                           int chunk) {
  const int us = s * slice;
  const int c_first = (max(us, lo) - us) / chunk;
  const int c_last = (min(us + slice - 1, hi) - us) / chunk;
  const int span = 2 * chunk + tile;  // one buffer: sa, then sb
  stage(smem, smem + chunk, a, b, na, nb, us + c_first * chunk, t0, chunk,
        tile);
  for (int c = c_first; c <= c_last; ++c) {
    float* buf = smem + ((c - c_first) & 1) * span;
    if (c < c_last) {
      float* next = smem + ((c - c_first + 1) & 1) * span;
      stage(next, next + chunk, a, b, na, nb, us + (c + 1) * chunk, t0,
            chunk, tile);
      wait_groups<1>();
    } else {
      wait_groups<0>();
    }
    __syncthreads();
    accumulate(acc, buf, buf + chunk, chunk);
    __syncthreads();  // buf is free for the chunk after next
  }
}

// Two-launch route: block (i, s) writes its sums to row s of the scratch.
__global__ void __launch_bounds__(256)
polymul_partial(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ partial, int na, int nb, int slice,
                int chunk, long long pitch) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tile = kRows * blockDim.x;
  const int t0 = blockIdx.x * tile;
  const int s = blockIdx.y;
  int lo, hi;
  band(t0, tile, na, nb, lo, hi);
  if (s < lo / slice || s > hi / slice) return;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  slice_sums(acc, smem, a, b, na, nb, t0, tile, lo, hi, s, slice, chunk);
  float4* out = reinterpret_cast<float4*>(
      partial + s * pitch + t0 + kRows * threadIdx.x);
#pragma unroll
  for (int r = 0; r < kRows; r += 4)
    out[r / 4] = make_float4(acc[r], acc[r + 1], acc[r + 2], acc[r + 3]);
}

// One-launch route: the gridDim.y blocks of a tile form one thread block
// cluster, block s its slice s.  Each leaves its sums in its own shared
// memory; after the cluster barrier block s adds outputs
// [s * per, (s + 1) * per) of the tile over the band's slices in
// increasing order, reading the other blocks' shared memory (the same
// additions in the same order as polymul_fold), and writes c.
__global__ void __launch_bounds__(256)
polymul_cluster(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ c, int na, int nb, int nc, int slice,
                int chunk) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tile = kRows * blockDim.x;
  const int t0 = blockIdx.x * tile;
  const int s = static_cast<int>(cluster.block_rank());  // == blockIdx.y
  int lo, hi;
  band(t0, tile, na, nb, lo, hi);
  const int s_lo = lo / slice, s_hi = hi / slice;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  if (s >= s_lo && s <= s_hi)  // the same for the whole block
    slice_sums(acc, smem, a, b, na, nb, t0, tile, lo, hi, s, slice, chunk);
  float4* mine = reinterpret_cast<float4*>(smem + kRows * threadIdx.x);
#pragma unroll
  for (int r = 0; r < kRows; r += 4)
    mine[r / 4] = make_float4(acc[r], acc[r + 1], acc[r + 2], acc[r + 3]);
  cluster.sync();
  const int k = static_cast<int>(cluster.num_blocks());
  const int per = (tile + k - 1) / k;
  const int o_end = min((s + 1) * per, tile);
  for (int o = s * per + threadIdx.x; o < o_end; o += blockDim.x) {
    float v[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      v[q] = s_lo + q <= s_hi ? cluster.map_shared_rank(smem, s_lo + q)[o]
                              : 0.0f;
    float sum = 0.0f;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (s_lo + q <= s_hi) sum += v[q];
    if (t0 + o < nc) c[t0 + o] = sum;
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

__global__ void __launch_bounds__(kFoldThreads)
polymul_fold(const float* __restrict__ partial, float* __restrict__ c,
             int na, int nb, int nc, int slice, int tile, long long pitch) {
  const int t = blockIdx.x * kFoldThreads + threadIdx.x;
  if (t >= nc) return;
  int lo, hi;
  band(t - t % tile, tile, na, nb, lo, hi);
  // kFoldBatch loads in flight at once, then added in increasing s: each
  // batch waits one round trip to L2.
  const float* p = partial + t;
  const int s_hi = hi / slice;
  float sum = 0.0f;
  for (int s0 = lo / slice; s0 <= s_hi; s0 += kFoldBatch) {
    float v[kFoldBatch];
#pragma unroll
    for (int k = 0; k < kFoldBatch; ++k)
      v[k] = s0 + k <= s_hi ? p[(s0 + k) * pitch] : 0.0f;
#pragma unroll
    for (int k = 0; k < kFoldBatch; ++k)
      if (s0 + k <= s_hi) sum += v[k];
  }
  c[t] = sum;
}

}  // namespace

// a: the shorter factor (na <= nb); n_slices = ceil(na / slice), n_tiles =
// ceil(nc / tile), tile = 12 * threads.  threads a multiple of 32 up to
// 256, chunk a multiple of 16 up to 512, slice a multiple of chunk.
// cluster = 0: two launches through `partial`, n_slices * n_tiles * tile
// floats; cluster = 16 (kMaxCluster, n_slices <= 16): one launch of
// clusters and no scratch.
extern "C" int polymul_launch(const float* a, const float* b, float* partial,
                              float* c, int na, int nb, int threads,
                              int slice, int chunk, int cluster,
                              void* stream) {
  if (na < 1 || nb < 1 || threads < 32 || threads > 256 || threads % 32 ||
      chunk < kStep || chunk > kMaxChunk || chunk % kStep || slice < chunk ||
      slice % chunk || (cluster != 0 && cluster != kMaxCluster))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nc = na + nb - 1;
  const int tile = kRows * threads;
  const unsigned int n_tiles = static_cast<unsigned int>(
      (static_cast<long long>(nc) + tile - 1) / tile);
  const unsigned int n_slices = static_cast<unsigned int>(
      (na + slice - 1) / slice);
  // two buffers only where a block walks more than one chunk
  const size_t smem =
      (slice > chunk ? 2 : 1) * (2 * chunk + tile) * sizeof(float);
  if (cluster) {
    if (n_slices > static_cast<unsigned int>(cluster))
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        polymul_cluster, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n_tiles, cluster);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = cluster;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, polymul_cluster, a, b, c, na, nb, nc,
                             slice, chunk);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  const long long pitch = static_cast<long long>(n_tiles) * tile;
  polymul_partial<<<dim3(n_tiles, n_slices), threads, smem, st>>>(
      a, b, partial, na, nb, slice, chunk, pitch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int blocks = static_cast<unsigned int>(
      (static_cast<long long>(nc) + kFoldThreads - 1) / kFoldThreads);
  polymul_fold<<<blocks, kFoldThreads, 0, st>>>(partial, c, na, nb, nc,
                                                slice, tile, pitch);
  return static_cast<int>(cudaGetLastError());
}
