// The bin sort of the window encoder: from sample positions x01 [3, M] to
// the counting-sort destinations dest [M] (int64, an injection into
// [0, M_pad): each of the 64 spatial tiles' samples in sample order, each
// tile's region padded to whole blocks of `block` slots) and the tile of
// each block, tob [NB] (int64).
//
// Replaces the TPU kernel tngp/kernels/window_encoder.py
// `_make_bin_rank_kernel` (launched by `_bin_ranks_pallas`) and the XLA
// scans around it in `bin_dest_pallas`.  The TPU kernel forms each key
// block's ranks as a one-hot [64, 512] matrix times a lower-triangular
// constant on the MXU; XLA then scans the [NBk, 64] block histograms down
// each tile, sums and scans the tile counts and gathers per sample.  Here
// the whole function is three kernels in one call, with nothing between
// them:
//   1. `bin_rank_kernel`, one block of 512 threads per key block: each
//      thread forms its sample's tile key from x01 (`tile_key`, the floor,
//      clamp and NaN -> 0 rule of `sample_tiles`), `__match_any_sync` finds
//      the lanes of its warp with the same key, the popcount of the lower
//      ones is its rank in the warp, and a per-warp 64-bin histogram in
//      shared memory gives the count of the earlier warps.  Writes the rank
//      (-1 past M) and the block's histogram tot [NBk, 64];
//   2. `bin_scan_kernel`, one block of 1024 threads per tile column: the
//      exclusive scan of the column of tot down the key blocks into base
//      [NBk, 64] (a block-wide shuffle scan, one row a thread at the eval's
//      widths) and the column's total, the tile's count;
//   3. `bin_dest_kernel`, one thread per sample: each block forms the
//      block-padded exclusive scan of the 64 counts, `starts`, in shared
//      memory; dest = starts[key] + base[key block, key] + rank, the key
//      formed again from x01; the first NB threads also write tob, the last
//      tile whose start is at or before the block's first slot.
// All integer, so the result equals the reference exactly.
//
// Bound on the H100 (3.35 TB/s): bytes.  The function reads 12 B of x01
// and writes 8 B of dest per sample, plus 256 B of histogram per key block
// and 8 B of tob per block; this design moves ~36 B per sample (x01 twice,
// the rank written and read) and ~1 KB per key block.  At the eval's top
// width (M = 393,216: 0.0024 ms of bytes) it takes 0.014 ms on an H100 80GB
// HBM3 at 700 W (tngp_torch/diagnostics/kernel_times.py): three dependent
// launches, each a few microseconds of latency.

#include <cuda_runtime.h>
#include <stdint.h>

#define RANK_BS 512
#define N_TILES 64
#define TILES_SIDE 4
#define N_WARPS (RANK_BS / 32)
#define SCAN_THREADS 1024

// `sample_tiles`: per dimension floor(nan_to_num(x) * 4) clamped to [0, 3]
// (an infinity lands on its end as nan_to_num's largest finite value does:
// times 4 it overflows to an infinity again), x-major, z fastest.
__device__ __forceinline__ int tile_coord(float v) {
  if (isnan(v)) v = 0.0f;
  return (int)fminf(fmaxf(floorf(v * (float)TILES_SIDE), 0.0f), (float)(TILES_SIDE - 1));
}

__device__ __forceinline__ int tile_key(const float* __restrict__ x01, int64_t s0, int64_t s1,
                                        int64_t m) {
  const int tx = tile_coord(x01[m * s1]);
  const int ty = tile_coord(x01[s0 + m * s1]);
  const int tz = tile_coord(x01[2 * s0 + m * s1]);
  return (tx * TILES_SIDE + ty) * TILES_SIDE + tz;
}

__global__ void __launch_bounds__(RANK_BS)
    bin_rank_kernel(const float* __restrict__ x01, int64_t s0, int64_t s1, int64_t M,
                    int32_t* __restrict__ rank, int32_t* __restrict__ tot) {
  __shared__ int hist[N_WARPS][N_TILES];
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int64_t m = (int64_t)blockIdx.x * RANK_BS + t;
  for (int i = t; i < N_WARPS * N_TILES; i += RANK_BS) (&hist[0][0])[i] = 0;
  __syncthreads();

  const int key = m < M ? tile_key(x01, s0, s1, m) : -1;
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  const int within = __popc(peers & ((1u << lane) - 1u));
  if (key >= 0 && lane == __ffs(peers) - 1) hist[warp][key] = __popc(peers);
  __syncthreads();

  int r = -1;
  if (key >= 0) {
    r = within;
    for (int w = 0; w < warp; ++w) r += hist[w][key];
  }
  rank[m] = r;
  if (t < N_TILES) {
    int s = 0;
    for (int w = 0; w < N_WARPS; ++w) s += hist[w][t];
    tot[(size_t)blockIdx.x * N_TILES + t] = s;
  }
}

// Inclusive scan of v over the block's threads (at most 32 warps).
__device__ __forceinline__ int block_inclusive_scan(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int o = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += o;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int o = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += o;
    }
    warp_sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  return warp ? v + warp_sums[warp - 1] : v;
}

// One block per tile column c: the exclusive scan of tot[:, c] into
// base[:, c] (each thread a run of R = ceil(NBk / 1024) rows, one row at the
// eval's widths) and the column's total, the tile's count.
__global__ void __launch_bounds__(SCAN_THREADS)
    bin_scan_kernel(const int32_t* __restrict__ tot, int32_t* __restrict__ base,
                    int32_t* __restrict__ counts, int NBk) {
  __shared__ int warp_sums[32];
  const int c = blockIdx.x;
  const int R = (NBk + SCAN_THREADS - 1) / SCAN_THREADS;
  const int r0 = min(NBk, (int)threadIdx.x * R), r1 = min(NBk, r0 + R);
  int s = 0;
  for (int r = r0; r < r1; ++r) s += tot[(size_t)r * N_TILES + c];
  const int incl = block_inclusive_scan(s, warp_sums);
  s = incl - s;
  for (int r = r0; r < r1; ++r) {
    const size_t i = (size_t)r * N_TILES + c;
    const int v = tot[i];
    base[i] = s;
    s += v;
  }
  if (threadIdx.x == blockDim.x - 1) counts[c] = incl;
}

// Per sample: dest = starts[key] + base[key block, key] + rank, with
// `starts` the block-padded exclusive scan of the 64 counts, formed by each
// block in shared memory; the first NB threads of the grid also write tob,
// the last tile whose start is at or before the block's first slot.
__global__ void __launch_bounds__(RANK_BS)
    bin_dest_kernel(const float* __restrict__ x01, int64_t s0, int64_t s1, int64_t M,
                    const int32_t* __restrict__ rank, const int32_t* __restrict__ base,
                    const int32_t* __restrict__ counts, int64_t* __restrict__ dest,
                    int64_t* __restrict__ tob, int NB, int block) {
  __shared__ long long st[N_TILES];
  if (threadIdx.x < 32) {  // two tiles a lane: padded counts, scanned over the warp
    const int lane = threadIdx.x;
    const long long p0 = (long long)((counts[2 * lane] + block - 1) / block) * block;
    const long long p1 = (long long)((counts[2 * lane + 1] + block - 1) / block) * block;
    long long v = p0 + p1;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const long long o = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += o;
    }
    st[2 * lane] = v - p0 - p1;
    st[2 * lane + 1] = v - p1;
  }
  __syncthreads();
  const int64_t gid = (int64_t)blockIdx.x * RANK_BS + threadIdx.x;
  for (int64_t b = gid; b < NB; b += (int64_t)gridDim.x * RANK_BS) {
    const long long b_start = b * block;
    int n = 0;
#pragma unroll 8
    for (int k = 0; k < N_TILES; ++k) n += st[k] <= b_start;
    tob[b] = n - 1;
  }
  if (gid >= M) return;
  const int key = tile_key(x01, s0, s1, gid);
  dest[gid] = st[key] + base[(gid / RANK_BS) * N_TILES + key] + rank[gid];
}

// x01 [3, M] f32 with strides (s0, s1) in elements; scratch: rank
// [NBk * 512], tot and base [NBk, 64] and counts [64] int32, NBk =
// ceil(M / 512); dest [M] and tob [NB] int64.
extern "C" int tngp_bin_dest(const float* x01, int64_t s0, int64_t s1, int64_t M, int block,
                             int NB, int32_t* rank, int32_t* tot, int32_t* base, int32_t* counts,
                             int64_t* dest, int64_t* tob, cudaStream_t stream) {
  if (block <= 0 || M < 0 || NB < 0) return (int)cudaErrorInvalidValue;
  const int64_t NBk = (M + RANK_BS - 1) / RANK_BS;
  if (NBk > 0)
    bin_rank_kernel<<<(unsigned)NBk, RANK_BS, 0, stream>>>(x01, s0, s1, M, rank, tot);
  bin_scan_kernel<<<N_TILES, SCAN_THREADS, 0, stream>>>(tot, base, counts, (int)NBk);
  bin_dest_kernel<<<(unsigned)(NBk > 0 ? NBk : 1), RANK_BS, 0, stream>>>(
      x01, s0, s1, M, rank, base, counts, dest, tob, NB, block);
  return (int)cudaGetLastError();
}
