// Scatters in f32: three forms of the scatter-add, one per index structure
// the caller states, and the last-write-wins set-scatter.
//
// ---------------------------------------------------------------------------
// Scatter-add: out[idx[j], :] += vals[j, :] into zeros, rows outside
// [0, num_rows) dropped.
//
// Replaces the TPU kernel tngp/kernels/scatter.py `_scatter_kernel` /
// `_scatter_kernel_acc` (launched by `_one_chunk` / `_one_chunk_acc` via
// `scatter_add`).  The TPU kernel walks the indices in one sequential loop
// with the whole accumulator resident in VMEM, which makes it deterministic.
// Blocks run in parallel and in no order on the H100, so the order comes
// from what the caller knows about its indices instead:
//
//  unique  (`tngp_scatter_add_unique_f32`; the encoder's payload and
//          cotangent sorts): no two j name one row, so each row is stored,
//          not added: one thread per (row j, 16-byte chunk), a vector load
//          of vals[j] and a vector store to out[idx[j]], no atomics and no
//          integer division (the chunk is threadIdx.x).  The zero fill is a
//          cudaMemsetAsync on the same stream, in the same call.  Exact; the
//          one visible difference from an add into zeros: a stored -0.0
//          stays -0.0 where 0 + -0.0 gives +0.0 (equal under == and in
//          every max-abs check).
//          Bound: bytes.  idx (8 B) and vals (4C B) read once, the output
//          (4C B per row) written by the fill and by the stores.
//  sorted  (`tngp_scatter_add_sorted_f32`; the compositor's per-ray
//          reduction, the eval round update): idx is nondecreasing, so the
//          entries of a row are one contiguous run.  A deterministic
//          segmented reduce: one warp per output row finds the run
//          [lo, hi) with two 16-ary searches (half a warp each, five
//          rounds of 16 probes for 393K indices instead of ~19 dependent
//          loads), strides over the run's rows of vals with a fixed lane
//          for each j, adds each lane's channels in j order, folds the 32
//          lanes with a fixed __shfl_down_sync tree and writes the row once
//          (0 for a row with no entries; a row of one entry skips the
//          fold).  No atomics and no zero fill.
//          The order of every add is fixed by (lo, hi) alone, so the same
//          inputs give bitwise the same output on every run.  Indices
//          below 0 or at or past num_rows fall outside every row's run and
//          are dropped.  Each row's sum is one ordering of its n terms, so
//          it is within (n - 1) 2^-24 sum|v| of the exact sum.
//          Bound: bytes.  idx and vals read once (the searches touch
//          ~160 idx entries per row, which stay in L2), the output written
//          once.  A run longer than a few thousand rows keeps one warp
//          busy alone: the callers' runs are one ray's samples (at most
//          max_steps) and padding is given an out-of-range row.  With few
//          entries per row (the round update: 1024 into 4096 rows) the
//          search's dependent loads bound it, not bytes.
//  any     (`tngp_scatter_add_any_f32`; general indices: the golden hash
//          grid's table gradient, one launch per level, C = 2, so float2
//          atomics): the unique form's threads, each adding its chunk with
//          a vector atomic (sm_90's atomicAdd on float4 / float2 in global
//          memory: one atomic per 16 bytes) into the memset output.
//          Repeated rows are added in the order the atomics land: within
//          f32 reordering error, not bitwise reproducible.
//          Bound: bytes, as unique; contention on a repeated row is on top
//          (the per-ray reduction's ~96 adds into one row serialise).
//
// The vector width is 4 floats where C % 4 == 0 and vals and out are
// 16-byte aligned, else 2 where C % 2 == 0 and 8-byte aligned, else 1.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// One thread per (row j, vector chunk): threadIdx.x is the chunk, so no
// integer division.  UNIQUE stores, the general form adds atomically.
template <bool UNIQUE, typename V>
__global__ void scatter_add_rows_kernel(const int64_t* __restrict__ idx,
                                        const V* __restrict__ vals,
                                        V* __restrict__ out, int64_t n, int cv,
                                        int64_t num_rows) {
  int64_t j = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  if (j >= n) return;
  int64_t r = idx[j];
  // an out-of-range update is dropped, as an out-of-range JAX scatter is
  if (r < 0 || r >= num_rows) return;
  const V* src = vals + j * cv;
  V* dst = out + r * cv;
  for (int c = threadIdx.x; c < cv; c += blockDim.x) {
    if constexpr (UNIQUE)
      dst[c] = src[c];
    else
      atomicAdd(dst + c, src[c]);
  }
}

// First p in [0, n) with idx[p] >= key (n if none), searched by the 16
// lanes of one half-warp (`half` names them): each round probes 16 evenly
// spaced positions of [lo, hi) and keeps the gap after the last probe below
// key, so the range shrinks 16-fold per round.  idx must be nondecreasing.
__device__ __forceinline__ int64_t half_warp_lower_bound(
    const int64_t* __restrict__ idx, int64_t n, int64_t key, unsigned half,
    int hl) {
  int64_t lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    int64_t step = (hi - lo + 15) / 16;
    int64_t p = lo + hl * step;
    bool below = p < hi && idx[p] < key;
    int c = __popc(__ballot_sync(half, below));
    if (c == 0) {
      hi = lo;  // idx[lo] >= key
    } else {
      int64_t next = lo + c * step;  // the first probe at or above key
      lo += (int64_t)(c - 1) * step + 1;
      if (next < hi) hi = next;
    }
  }
  return lo;
}

constexpr int SORTED_CB = 8;  // channels accumulated per pass over a run

__global__ void scatter_add_sorted_kernel(const int64_t* __restrict__ idx,
                                          const float* __restrict__ vals,
                                          float* __restrict__ out, int64_t n,
                                          int C, int64_t num_rows) {
  int64_t r = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (r >= num_rows) return;  // whole warps leave together
  int lane = threadIdx.x & 31;
  // lanes 0-15 find the run's start (key r), lanes 16-31 its end (key r + 1)
  unsigned half = lane < 16 ? 0x0000ffffu : 0xffff0000u;
  int64_t b = half_warp_lower_bound(idx, n, r + (lane >> 4), half, lane & 15);
  int64_t lo = __shfl_sync(0xffffffffu, b, 0);
  int64_t hi = __shfl_sync(0xffffffffu, b, 16);
  if (hi - lo <= 1) {  // no entry or one (most rows of the eval round update)
    if (lane == 0)
      for (int c = 0; c < C; ++c) out[r * C + c] = hi > lo ? vals[lo * C + c] : 0.0f;
    return;
  }
  for (int c0 = 0; c0 < C; c0 += SORTED_CB) {
    float acc[SORTED_CB];
#pragma unroll
    for (int c = 0; c < SORTED_CB; ++c) acc[c] = 0.0f;
#pragma unroll 4
    for (int64_t j = lo + lane; j < hi; j += 32) {
      const float* v = vals + j * C + c0;
#pragma unroll
      for (int c = 0; c < SORTED_CB; ++c)
        if (c0 + c < C) acc[c] += v[c];
    }
#pragma unroll
    for (int c = 0; c < SORTED_CB; ++c) {
      float s = acc[c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_down_sync(0xffffffffu, s, off);
      if (lane == 0 && c0 + c < C) out[r * C + c0 + c] = s;
    }
  }
}

static int vec_width(const void* a, const void* b, int C) {
  uintptr_t p = (uintptr_t)a | (uintptr_t)b;
  if (C % 4 == 0 && p % 16 == 0) return 4;
  if (C % 2 == 0 && p % 8 == 0) return 2;
  return 1;
}

// zero the output, then launch the unique or the any form at the widest
// vector width that C and the pointers' alignment allow
template <bool UNIQUE, typename V>
static void launch_rows(const int64_t* idx, const float* vals, float* out,
                        int64_t n, int cv, int64_t num_rows,
                        cudaStream_t stream) {
  int bx = cv < 32 ? cv : 32;  // threads per row, one vector each
  int by = 256 / bx;           // rows per block
  int64_t blocks = (n + by - 1) / by;
  scatter_add_rows_kernel<UNIQUE, V><<<(unsigned)blocks, dim3(bx, by), 0, stream>>>(
      idx, (const V*)vals, (V*)out, n, cv, num_rows);
}

template <bool UNIQUE>
static int zero_then_add(const int64_t* idx, const float* vals, float* out,
                         int64_t n, int C, int64_t num_rows,
                         cudaStream_t stream) {
  if (num_rows <= 0 || C <= 0) return (int)cudaGetLastError();
  cudaError_t err =
      cudaMemsetAsync(out, 0, num_rows * C * sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    int v = vec_width(vals, out, C);
    if (v == 4)
      launch_rows<UNIQUE, float4>(idx, vals, out, n, C / 4, num_rows, stream);
    else if (v == 2)
      launch_rows<UNIQUE, float2>(idx, vals, out, n, C / 2, num_rows, stream);
    else
      launch_rows<UNIQUE, float>(idx, vals, out, n, C, num_rows, stream);
  }
  return (int)cudaGetLastError();
}

extern "C" int tngp_scatter_add_unique_f32(const int64_t* idx, const float* vals,
                                           float* out, int64_t n, int C,
                                           int64_t num_rows,
                                           cudaStream_t stream) {
  return zero_then_add<true>(idx, vals, out, n, C, num_rows, stream);
}

extern "C" int tngp_scatter_add_any_f32(const int64_t* idx, const float* vals,
                                        float* out, int64_t n, int C,
                                        int64_t num_rows, cudaStream_t stream) {
  return zero_then_add<false>(idx, vals, out, n, C, num_rows, stream);
}

extern "C" int tngp_scatter_add_sorted_f32(const int64_t* idx, const float* vals,
                                           float* out, int64_t n, int C,
                                           int64_t num_rows,
                                           cudaStream_t stream) {
  if (num_rows <= 0 || C <= 0) return (int)cudaGetLastError();
  const int threads = 256;  // 8 rows per block
  int64_t blocks = (num_rows * 32 + threads - 1) / threads;
  scatter_add_sorted_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      idx, vals, out, n, C, num_rows);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Set-scatter: out[c] = init, then out[idx[j]] = vals[j] for every j with
// 0 <= idx[j] < num_cells, the LAST write (largest j) winning a cell.
//
// Replaces the TPU kernel tngp/kernels/scatter.py `_scatter_set_kernel`
// (launched by `scatter_set_flat`).  The TPU kernel keeps the whole
// lane-packed [rows, 128] target in VMEM and walks the indices in one
// sequential loop, so a later write overwrites an earlier one.  No block
// here can hold the 8 MB target and blocks have no order, so the last-write
// rule becomes a maximum, which is the same in any order:
//   1. winner[c] = -1 for every cell;
//   2. atomicMax(&winner[idx[j]], j), indices out of range (the -1 skips,
//      and caller errors) dropped;
//   3. out[c] = winner[c] >= 0 ? vals[winner[c]] : init.
// The three phases run in ONE cooperative launch: a persistent grid of
// co-resident blocks of 1024 threads (occupancy x SMs, fewer for a small
// input; each grid.sync() waits for one arrival per block, so few large
// blocks sync sooner) strides over each phase, with cooperative_groups'
// grid.sync() between them in place of two launch gaps.  The result is exact and deterministic: phase 3
// reads only after every atomic of phase 2 (the grid barrier orders them),
// and the maximum of the j's does not depend on the order the atomics
// land.  `winner` is int32 scratch the caller allocates, so j < 2^31 (the
// wrapper checks M); num_cells % 4 == 0 (the wrapper holds it to 128) lets
// phases 1 and 3 move 16 bytes per thread.
//
// Bound on the H100: bytes.  The function needs idx (8 B per write), the
// winning values (4 B per written cell) and the output (4 B per cell).  The
// kernel moves more: winner is written, hit by the atomics and read again,
// 8 B per cell and 4 B per write on top.
//
// Measured beside it and dropped: a 64-bit atomicMax of
// ((j + 1) << 32 | bits(vals[j])) into a uint64 scratch, which spares phase
// 3 the dependent vals[winner] gather but moves 8 B of scratch per cell
// instead of 4 (slower on the H100: PERF.md, section 6).

__global__ void scatter_set_kernel(const int64_t* __restrict__ idx,
                                   const float* __restrict__ vals,
                                   int* winner,
                                   float* __restrict__ out, int n,
                                   int64_t num_cells, float init) {
  cg::grid_group grid = cg::this_grid();
  int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t nth = (int64_t)gridDim.x * blockDim.x;
  int64_t n4 = num_cells / 4;
  int4* w4 = reinterpret_cast<int4*>(winner);
  for (int64_t c = tid; c < n4; c += nth) w4[c] = make_int4(-1, -1, -1, -1);
  grid.sync();
  for (int64_t j = tid; j < n; j += nth) {
    int64_t c = idx[j];
    if (c >= 0 && c < num_cells) atomicMax(winner + c, (int)j);
  }
  grid.sync();
  float4* o4 = reinterpret_cast<float4*>(out);
  for (int64_t c = tid; c < n4; c += nth) {
    int4 w = __ldcg(w4 + c);  // from L2, where the atomics landed
    o4[c] = make_float4(w.x >= 0 ? vals[w.x] : init, w.y >= 0 ? vals[w.y] : init,
                        w.z >= 0 ? vals[w.z] : init, w.w >= 0 ? vals[w.w] : init);
  }
}

// Blocks of `threads` that fit on the card at once for the set-scatter
// kernel, cached per device (the answer does not change within a process).
static int resident_blocks(int threads) {
  static int cache[16];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 16) return 0;
  if (cache[dev] == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, scatter_set_kernel, threads, 0) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    cache[dev] = per_sm * sms;
  }
  return cache[dev];
}

extern "C" int tngp_scatter_set_f32(const int64_t* idx, const float* vals,
                                    int* winner, float* out, int n,
                                    int64_t num_cells, float init,
                                    cudaStream_t stream) {
  // large blocks: each grid.sync() waits for one arrival per block
  const int threads = 1024;
  if (num_cells <= 0) return (int)cudaGetLastError();
  if (num_cells % 4 != 0) return (int)cudaErrorInvalidValue;
  int most = resident_blocks(threads);
  if (most <= 0) return (int)cudaErrorInvalidConfiguration;
  int64_t work = num_cells / 4 > n ? num_cells / 4 : n;
  int64_t want = (work + threads - 1) / threads;
  int blocks = (int)(want < most ? want : most);
  void* args[] = {(void*)&idx, (void*)&vals, (void*)&winner,   (void*)&out,
                  (void*)&n,   (void*)&num_cells, (void*)&init};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)scatter_set_kernel, blocks, threads, args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
