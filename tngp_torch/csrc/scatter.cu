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
//          grid's table gradient, one launch per level, C = 2; TensoRF's and
//          CCNeRF's factor gradients, one per factor).  The TPU kernel keeps
//          the whole [rows, C] accumulator in VMEM and walks the indices in
//          order: deterministic, no contention.  The counterpart here is
//          shared memory, 227 KB a block, where the output fits and its rows
//          are crowded; elsewhere the adds go to global memory, pre-summed
//          where they repeat.  `any_form` (kernels/scatter.py) picks the
//          design from (n, C, rows) alone and passes threads, blocks and
//          the shared-memory request; a refused opt-in or launch is
//          returned, never worked around.  The four designs:
//    owner   the output fits a block (rows * C * 4 <= 232,448 bytes), >= 200
//            adds a row, and >= 384 owned columns (the wide lines: CCNeRF's
//            rank-64, TensoRF's 48 and 96 at 128 rows): a persistent grid,
//            one block an SM, each block a contiguous range of j.  A group
//            of threads (C in whole warps) owns one of the block's private
//            copies of the accumulator, thread c its column c, and walks the
//            group's contiguous share of the range in order, 32 rows a
//            round: the warp reads their indices once and passes each to all
//            lanes by shuffle, and the next round's values load while this
//            round's are added.  A run of equal rows is summed in a register
//            and added to the copy when the row changes.  No two threads
//            write one word, so no atomics.  The block sums its copies in
//            copy order into its partial ([blocks, rows, C] scratch from the
//            wrapper) and `partials` sums the partials in block order.
//            Deterministic: the same inputs on the same card give bitwise
//            the same sums.  It pays over the bytes bound with the partials,
//            written and read once (blocks x rows x C x 4 bytes each way).
//    shared  the output fits, >= 200 adds a row, C <= 16 (level 0 of the
//            grids, TensoRF's rank-16 lines): one copy a block, 1024
//            threads adding with shared-memory atomics, zeros skipped, and
//            for one vector a row (C = 1, 2, 4) a run of lanes naming one row
//            pre-summed (`run_sum`); partials as above.  sm_90 has no
//            shared-memory f32 add: `atomicAdd` there compiles to a
//            compare-and-swap loop (ATOMS.CAST.SPIN), which is why wide rows
//            go to the owner design or to global atomics.  The shared atomics
//            land in no fixed order: within f32 reordering error, not
//            bitwise reproducible.
//    warp    one vector a row (C <= 4) otherwise (the grids' other levels,
//            CCNeRF's rank-4 planes): lane l of a warp takes row j; a run of
//            consecutive lanes that name one row with nonzero chunks is
//            summed by a segmented tree of shuffles and its first lane
//            issues one vector atomic into the zeroed output (a golden-grid
//            level's samples come ray by ray, so consecutive entries often
//            share a cell).  With no run in the warp the tree is skipped.
//    rows    everything else (wide rows with few adds a row: TensoRF's
//            planes, CCNeRF's wider planes, TensoRF's 288-wide CP line): the
//            unique form's threads, one vector atomic (atomicAdd on float4 /
//            float2 in global memory) a 16-byte chunk into the zeroed output.
//          Every design skips zeros, which is exact: the output starts at
//          +0.0, x + (+-0) = x for x != 0 and +0 + (+-0) = +0, so no sum ever
//          holds -0.0 and a zero changes nothing.  Half of CCNeRF's vals rows
//          are its masked slots' zero cotangents, all on the centre rows,
//          where the parent's atomics serialised (1.6-2.8 ms a call).
//          Bound: bytes.  idx (8 B) and vals (4C B) read once, the output
//          (4C B a row) written once.  Each row's sum is one summation tree
//          of its n terms: within (n - 1) 2^-24 sum|v| of the exact sum.
//
// The vector width is 4 floats where C % 4 == 0 and vals and out are
// 16-byte aligned, else 2 where C % 2 == 0 and 8-byte aligned, else 1.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

__device__ __forceinline__ bool nonzero(float v) { return v != 0.0f; }
__device__ __forceinline__ bool nonzero(float2 v) { return v.x != 0.0f || v.y != 0.0f; }
__device__ __forceinline__ bool nonzero(float4 v) {
  return v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f;
}
template <typename V> __device__ __forceinline__ V vzero();
template <> __device__ __forceinline__ float vzero<float>() { return 0.0f; }
template <> __device__ __forceinline__ float2 vzero<float2>() { return make_float2(0.0f, 0.0f); }
template <> __device__ __forceinline__ float4 vzero<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}
__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
__device__ __forceinline__ float2 vadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float vshfl_down(float v, int off) {
  return __shfl_down_sync(0xffffffffu, v, off);
}
__device__ __forceinline__ float2 vshfl_down(float2 v, int off) {
  return make_float2(__shfl_down_sync(0xffffffffu, v.x, off),
                     __shfl_down_sync(0xffffffffu, v.y, off));
}
__device__ __forceinline__ float4 vshfl_down(float4 v, int off) {
  return make_float4(
      __shfl_down_sync(0xffffffffu, v.x, off), __shfl_down_sync(0xffffffffu, v.y, off),
      __shfl_down_sync(0xffffffffu, v.z, off), __shfl_down_sync(0xffffffffu, v.w, off));
}
// shared-memory atomics, a component each, zeros skipped
__device__ __forceinline__ void shared_add(float* p, float v) {
  if (v != 0.0f) atomicAdd(p, v);
}
__device__ __forceinline__ void shared_add(float* p, float2 v) {
  shared_add(p, v.x);
  shared_add(p + 1, v.y);
}
__device__ __forceinline__ void shared_add(float* p, float4 v) {
  shared_add(p, v.x);
  shared_add(p + 1, v.y);
  shared_add(p + 2, v.z);
  shared_add(p + 3, v.w);
}

// One thread per (row j, vector chunk): threadIdx.x is the chunk, so no
// integer division.  UNIQUE stores, the general form's rows design adds
// atomically and skips a chunk of zeros.
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
    if constexpr (UNIQUE) {
      dst[c] = src[c];
    } else {
      V v = src[c];
      if (nonzero(v)) atomicAdd(dst + c, v);
    }
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

// ---- the general form's warp, shared and owner designs ----------------

// The lanes of a warp (all 32 active) in a run of consecutive lanes with
// one `key` >= 0 sum their v: a segmented tree of shuffles (lane l adds
// lane l + off while that lane is in its run), which leaves the run's sum
// in its first lane; true there.  A warp with no run of two skips the
// tree: one shuffle and one ballot.
template <typename V>
__device__ __forceinline__ bool run_sum(V& v, long long key, int lane) {
  const long long prev = __shfl_up_sync(0xffffffffu, key, 1);
  const bool head = lane == 0 || key != prev || key < 0;
  const unsigned heads = __ballot_sync(0xffffffffu, head);
  if (heads != 0xffffffffu) {
    const unsigned after = heads & ~((2u << lane) - 1u);  // heads past this lane
    const int end = after ? __ffs(after) - 2 : 31;       // the run's last lane
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const V o = vshfl_down(v, off);
      if (lane + off <= end) v = vadd(v, o);
    }
  }
  return head && key >= 0;
}

// warp: lane l of a warp takes row j = base + l of vals; per vector chunk
// the lanes of a run that names one output row with nonzero chunks sum
// them (`run_sum`) and the run's first lane issues the one atomic: the
// golden grid's consecutive samples share the cells of its coarse levels.
// A grid-stride loop over the warps.
template <typename V>
__global__ void scatter_add_warp_kernel(const int64_t* __restrict__ idx,
                                        const V* __restrict__ vals, V* __restrict__ out,
                                        int64_t n, int cv, int64_t num_rows) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t base = warp * 32; base < n; base += warps * 32) {  // uniform in the warp
    const int64_t j = base + lane;
    int64_t r = j < n ? idx[j] : -1;
    if (r >= num_rows) r = -1;
    for (int c = 0; c < cv; ++c) {
      V v = r >= 0 ? vals[j * cv + c] : vzero<V>();
      long long key = (r >= 0 && nonzero(v)) ? (long long)r : -1ll;
      if (run_sum(v, key, lane)) atomicAdd(out + key * cv + c, v);
    }
  }
}

constexpr int SHARED_UNROLL = 4;  // rows of vals loaded before their adds
constexpr int OWNER_UNROLL = 32;  // one warp's indices a round

// shared: one accumulator copy [rows, C] in shared memory; threadIdx.x a
// vector chunk, threadIdx.y a row of vals; the block walks rows
// [lo, lo + per_block) with shared atomics, then writes its partial.
template <typename V>
__global__ void __launch_bounds__(1024)
    scatter_add_shared_kernel(const int64_t* __restrict__ idx, const V* __restrict__ vals,
                              float* __restrict__ part, int64_t n, int cv, int64_t num_rows,
                              int64_t per_block) {
  extern __shared__ float acc[];
  constexpr int W = sizeof(V) / sizeof(float);
  const int C = cv * W;
  const int E = (int)num_rows * C;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nth = blockDim.x * blockDim.y;
  for (int e = tid; e < E; e += nth) acc[e] = 0.0f;
  __syncthreads();
  const int64_t lo = (int64_t)blockIdx.x * per_block;
  const int64_t hi = lo + per_block < n ? lo + per_block : n;
  const int64_t stride = (int64_t)blockDim.y * SHARED_UNROLL;
  for (int c = threadIdx.x; c < cv; c += blockDim.x) {
    for (int64_t j0 = lo + threadIdx.y; j0 < hi; j0 += stride) {
      int64_t r[SHARED_UNROLL];
      V v[SHARED_UNROLL];
#pragma unroll
      for (int u = 0; u < SHARED_UNROLL; ++u) {
        const int64_t j = j0 + (int64_t)u * blockDim.y;
        r[u] = j < hi ? idx[j] : -1;
        if (r[u] >= num_rows) r[u] = -1;
        v[u] = r[u] >= 0 ? vals[j * cv + c] : vzero<V>();
      }
#pragma unroll
      for (int u = 0; u < SHARED_UNROLL; ++u)
        if (r[u] >= 0) shared_add(acc + r[u] * C + c * W, v[u]);
    }
  }
  __syncthreads();
  float* dst = part + (int64_t)blockIdx.x * E;
  for (int e = tid; e < E; e += nth) dst[e] = acc[e];
}

// shared, one vector a row (C = 1, 2 or 4): lane l of a warp takes row
// j = base + l, a run of lanes that name one row sums it first
// (`run_sum`), and the run's first lane adds the sum to the block's copy.
template <typename V>
__global__ void __launch_bounds__(1024)
    scatter_add_shared1_kernel(const int64_t* __restrict__ idx, const V* __restrict__ vals,
                               float* __restrict__ part, int64_t n, int64_t num_rows,
                               int64_t per_block) {
  extern __shared__ float acc[];
  constexpr int W = sizeof(V) / sizeof(float);
  const int E = (int)num_rows * W;
  for (int e = threadIdx.x; e < E; e += blockDim.x) acc[e] = 0.0f;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t lo = (int64_t)blockIdx.x * per_block;
  const int64_t hi = lo + per_block < n ? lo + per_block : n;
  const int64_t stride = (int64_t)blockDim.x * SHARED_UNROLL;
  // uniform in the warp: every lane runs every round
  for (int64_t w0 = lo + (threadIdx.x & ~31); w0 < hi; w0 += stride) {
    int64_t r[SHARED_UNROLL];
    V v[SHARED_UNROLL];
#pragma unroll
    for (int u = 0; u < SHARED_UNROLL; ++u) {
      const int64_t j = w0 + (int64_t)u * blockDim.x + lane;
      r[u] = j < hi ? idx[j] : -1;
      if (r[u] >= num_rows) r[u] = -1;
      v[u] = r[u] >= 0 ? vals[j] : vzero<V>();
    }
#pragma unroll
    for (int u = 0; u < SHARED_UNROLL; ++u) {
      const long long key = (r[u] >= 0 && nonzero(v[u])) ? (long long)r[u] : -1ll;
      if (run_sum(v[u], key, lane)) shared_add(acc + key * W, v[u]);
    }
  }
  __syncthreads();
  float* dst = part + (int64_t)blockIdx.x * E;
  for (int e = threadIdx.x; e < E; e += blockDim.x) dst[e] = acc[e];
}

// owner: `groups` private copies [rows, C] in shared memory; thread
// (g, c) = (threadIdx.x / C, threadIdx.x % C) walks group g's contiguous
// share of the block's rows in order, keeps the sum of a run of equal
// rows in a register and adds it to copy g's (row, c) when the row
// changes.  No two threads write one word, so no atomics.  The copies are
// summed in copy order into the block's partial.
// The next OWNER_UNROLL rows of one thread: its lane's index (lane u of the
// warp reads row j0 + u, coalesced; -1 outside [0, num_rows) or past b)
// and its column's value of each row (0 for a padding column c >= C).
__device__ __forceinline__ void owner_load(const int64_t* __restrict__ idx,
                                           const float* __restrict__ vals, int64_t j0,
                                           int64_t b, int C, int c, int64_t num_rows, int lane,
                                           int& r, float* v) {
  const int64_t x = j0 + lane < b ? __ldg(idx + j0 + lane) : -1;
  r = x >= 0 && x < num_rows ? (int)x : -1;
#pragma unroll
  for (int u = 0; u < OWNER_UNROLL; ++u)
    v[u] = c < C && j0 + u < b ? __ldg(vals + (j0 + u) * C + c) : 0.0f;
}

// owner: `groups` private copies [rows, C] in shared memory; a group is
// GW = C rounded up to whole warps, thread (g, c) = (threadIdx.x / GW,
// threadIdx.x % GW) owns column c (c < C) of copy g and walks group g's
// contiguous share of the block's rows in order, 32 rows a round: the
// warp reads their indices once and passes each to all lanes by shuffle,
// and each thread keeps the next round's 32 values in flight in registers
// while it adds this round's.  It sums a run of equal rows in a register
// and adds it to copy g's (row, c) when the row changes.  No two threads
// write one word, so no atomics.  The copies are summed in copy order into
// the block's partial.
__global__ void __launch_bounds__(512)
    scatter_add_owner_kernel(const int64_t* __restrict__ idx, const float* __restrict__ vals,
                             float* __restrict__ part, int64_t n, int C, int64_t num_rows,
                             int groups, int64_t per_block) {
  extern __shared__ float acc[];
  const int E = (int)num_rows * C;
  const int GW = (C + 31) & ~31;
  for (int e = threadIdx.x; e < groups * E; e += blockDim.x) acc[e] = 0.0f;
  __syncthreads();
  const int g = threadIdx.x / GW, c = threadIdx.x - g * GW, lane = threadIdx.x & 31;
  const int64_t lo = (int64_t)blockIdx.x * per_block;
  const int64_t hi = lo + per_block < n ? lo + per_block : n;
  const int64_t len = hi > lo ? hi - lo : 0;
  const int64_t share = (len + groups - 1) / groups;
  const int64_t a = lo + g * share;
  const int64_t b = a + share < hi ? a + share : hi;
  float* mine = acc + g * E + c;
  int cur = -1;
  float run = 0.0f;
  int rn;
  float vn[OWNER_UNROLL];
  owner_load(idx, vals, a, b, C, c, num_rows, lane, rn, vn);
  for (int64_t j0 = a; j0 < b; j0 += OWNER_UNROLL) {  // uniform in the warp
    const int rl = rn;
    float v[OWNER_UNROLL];
#pragma unroll
    for (int u = 0; u < OWNER_UNROLL; ++u) v[u] = vn[u];
    if (j0 + OWNER_UNROLL < b)
      owner_load(idx, vals, j0 + OWNER_UNROLL, b, C, c, num_rows, lane, rn, vn);
#pragma unroll
    for (int u = 0; u < OWNER_UNROLL; ++u) {
      const int r = __shfl_sync(0xffffffffu, rl, u);
      if (r < 0) continue;
      if (r == cur) {
        run += v[u];
      } else {
        if (cur >= 0 && c < C) mine[cur * C] += run;
        cur = r;
        run = v[u];
      }
    }
  }
  if (cur >= 0 && c < C) mine[cur * C] += run;
  __syncthreads();
  float* dst = part + (int64_t)blockIdx.x * E;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    float s = acc[e];
    for (int k = 1; k < groups; ++k) s += acc[k * E + e];
    dst[e] = s;
  }
}

// out[e] = the blocks' partials summed in block order: thread (x, y) sums
// partials y, y + 8, ... of element e in order, then row 0 of the block
// sums the 8 slices in order.  A fixed order for a given block count.
constexpr int PART_X = 128, PART_Y = 8;
__global__ void __launch_bounds__(PART_X * PART_Y)
    scatter_add_partials_kernel(const float* __restrict__ part, float* __restrict__ out, int E,
                                int blocks) {
  __shared__ float slice[PART_Y][PART_X];
  const int e = blockIdx.x * PART_X + threadIdx.x;
  float s = 0.0f;
  if (e < E) {
#pragma unroll 8
    for (int b = threadIdx.y; b < blocks; b += PART_Y) s += part[(int64_t)b * E + e];
  }
  slice[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && e < E) {
    float t = slice[0][threadIdx.x];
#pragma unroll
    for (int y = 1; y < PART_Y; ++y) t += slice[y][threadIdx.x];
    out[e] = t;
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

// the general form's designs, as kernels/scatter.py numbers them
enum AnyForm { ANY_ROWS = 0, ANY_WARP = 1, ANY_SHARED = 2, ANY_OWNER = 3 };
constexpr int SMEM_BUDGET = 232448;  // dynamic shared memory a block may opt in to

template <typename V>
static void launch_warp(const int64_t* idx, const float* vals, float* out, int64_t n, int cv,
                        int64_t num_rows, int threads, int blocks, cudaStream_t stream) {
  scatter_add_warp_kernel<V><<<blocks, threads, 0, stream>>>(idx, (const V*)vals, (V*)out, n,
                                                             cv, num_rows);
}

template <typename V>
static cudaError_t launch_shared(const int64_t* idx, const float* vals, float* part, int64_t n,
                                 int cv, int64_t num_rows, int threads, int blocks, int smem,
                                 int64_t per_block, cudaStream_t stream) {
  cudaError_t err;
  if (cv == 1) {
    err = cudaFuncSetAttribute((const void*)scatter_add_shared1_kernel<V>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    scatter_add_shared1_kernel<V><<<blocks, threads & ~31, smem, stream>>>(
        idx, (const V*)vals, part, n, num_rows, per_block);
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute((const void*)scatter_add_shared_kernel<V>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int bx = cv < 32 ? cv : 32;
  scatter_add_shared_kernel<V><<<blocks, dim3(bx, threads / bx), smem, stream>>>(
      idx, (const V*)vals, part, n, cv, num_rows, per_block);
  return cudaSuccess;
}

// form, threads, blocks and smem come from `any_form`; scratch holds
// blocks x rows x C floats where a shared design runs more than one block
extern "C" int tngp_scatter_add_any_f32(const int64_t* idx, const float* vals, float* out,
                                        float* scratch, int64_t n, int C, int64_t num_rows,
                                        int form, int threads, int blocks, int smem,
                                        cudaStream_t stream) {
  if (num_rows <= 0 || C <= 0) return (int)cudaGetLastError();
  if (form == ANY_ROWS || (form != ANY_WARP && n <= 0))
    return zero_then_add<false>(idx, vals, out, n, C, num_rows, stream);
  if (threads < 32 || threads > 1024 || blocks < 1) return (int)cudaErrorInvalidValue;
  if (form == ANY_WARP) {
    cudaError_t err = cudaMemsetAsync(out, 0, num_rows * C * sizeof(float), stream);
    if (err != cudaSuccess) return (int)err;
    if (n > 0) {
      int v = vec_width(vals, out, C);
      if (v == 4)
        launch_warp<float4>(idx, vals, out, n, C / 4, num_rows, threads, blocks, stream);
      else if (v == 2)
        launch_warp<float2>(idx, vals, out, n, C / 2, num_rows, threads, blocks, stream);
      else
        launch_warp<float>(idx, vals, out, n, C, num_rows, threads, blocks, stream);
    }
    return (int)cudaGetLastError();
  }
  if (form != ANY_SHARED && form != ANY_OWNER) return (int)cudaErrorInvalidValue;
  const int64_t E = num_rows * C;
  if (E * (int64_t)sizeof(float) > SMEM_BUDGET || smem > SMEM_BUDGET)
    return (int)cudaErrorInvalidValue;
  if (blocks > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  float* part = blocks > 1 ? scratch : out;
  const int64_t per_block = (n + blocks - 1) / blocks;
  cudaError_t err;
  if (form == ANY_OWNER) {
    const int gw = (C + 31) & ~31;  // a group's threads: C in whole warps
    int groups = threads / gw;
    if (groups < 1 || groups * gw != threads ||
        (int64_t)smem != groups * E * (int64_t)sizeof(float))
      return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute((const void*)scatter_add_owner_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    scatter_add_owner_kernel<<<blocks, threads, smem, stream>>>(idx, vals, part, n, C,
                                                                num_rows, groups, per_block);
  } else {
    if ((int64_t)smem != E * (int64_t)sizeof(float)) return (int)cudaErrorInvalidValue;
    int v = vec_width(vals, vals, C);
    if (v == 4)
      err = launch_shared<float4>(idx, vals, part, n, C / 4, num_rows, threads, blocks, smem,
                                  per_block, stream);
    else if (v == 2)
      err = launch_shared<float2>(idx, vals, part, n, C / 2, num_rows, threads, blocks, smem,
                                  per_block, stream);
    else
      err = launch_shared<float>(idx, vals, part, n, C, num_rows, threads, blocks, smem,
                                 per_block, stream);
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || blocks == 1) return (int)err;
  scatter_add_partials_kernel<<<(unsigned)((E + PART_X - 1) / PART_X), dim3(PART_X, PART_Y), 0,
                                stream>>>(part, out, (int)E, blocks);
  return (int)cudaGetLastError();
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
