// Window encoder over tile-sorted samples: forward, table gradient and
// input gradient.
//
// Forward: per sample and level, the 8-corner trilinear (or smoothstep)
// interpolation of the window-layout table, with the window that the
// sample's tile-sorted block maps to at that level.  Backward: the table
// gradient in the same layout — per sample, level, corner and channel, the
// contribution w * g added into the corner's row.  Input gradient: per
// sample, d features / d x01 contracted with the cotangents, gx [3, M_pad].
//
// Replaces the TPU kernels tngp/kernels/window_encoder.py `_make_fwd_kernel`
// (launched by `_fwd_pallas`), `_make_bwd_kernel` (launched by `_bwd_pallas`)
// and the input-gradient path of `_binned_bwd` (three `_fwd_pallas` launches
// with `deriv=0,1,2`, then an XLA contraction with the cotangents), reached
// through `window_encode_binned` and its VJP.  The TPU kernels cannot gather
// or scatter in VMEM, so they select rows with one-hot matrix products on the
// MXU, and the backward accumulates a window across the consecutive grid
// steps that share it because its grid runs in order.
//
// Bounds on the H100 (3.35 TB/s): bytes, all three.  Forward: 16 B in and
// 4*L*C B out per sample plus one read of each window the samples visit.
// Backward: 16 B + 4*L*C B in per sample plus one write of the whole
// gradient table.  Input gradient: 16 B + 4*L*C B in and 12 B out per
// sample plus one read of each visited window.
//
// Forward and table gradient: one CUDA block per (chunk of S tile-sorted
// blocks, level), S from the sample count alone (`chunk_blocks`: ~128
// chunks per level), so the launch reads nothing from the device.  The
// blocks of one window at one level are consecutive (wob[l] is
// nondecreasing), so a chunk meets runs of one window, and the window sits
// in shared memory while its samples are processed: a gather from global
// memory would cost one 32-byte sector per corner and channel, and a
// scattered global atomic would contend on the coarse levels' few windows,
// each far above the bytes the function must move.  Here:
//  - the forward stages each run's window once per chunk, rounded to bf16
//    while staging (the rounding the numerics apply anyway) with two
//    channels to a 32-bit word: 32 KB for C = 2.  Each corner is then one
//    4-byte shared load for both channels.  A padding slot gathers nothing
//    and writes zeros; a one-block run with few live samples (a small eval
//    width, mostly padding) gathers from global memory instead, since
//    staging 64 KB costs more than its gathers there;
//  - the table gradient accumulates the window in shared memory, C x 8192
//    f32 (64 KB for C = 2, in groups of two channels for C = 4, 8), and
//    flushes it once: a run of at most 2 S blocks is taken whole by one
//    chunk, which stores the whole window (its zeros too); the pieces of a
//    longer run add their nonzero 16-byte groups into a window that a small
//    kernel launched just before zeroed, as it zeroes every window no block
//    visits (`ChunkWalk`).  The 49 MB fill and the ~42M contended global
//    atomics of a training step become one write of the table, the coarse
//    levels' flushes and shared-memory adds.  The card has no shared-memory
//    f32 add instruction: nvcc makes each such atomicAdd a compare-and-swap
//    loop (ATOMS.CAST.SPIN), which is what bounds this kernel now, so runs
//    of consecutive samples in one cell (samples along a ray, at the coarse
//    levels) sum their terms in registers first (`warp_sum_runs`).
// Measured on an H100 80GB HBM3 at 700 W with the flagship spec
// (tngp_torch/diagnostics/kernel_times.py): the forward 0.074 ms at 425,984
// samples, 45% of its bytes bound (the coarse levels' windows are staged by
// every chunk, ~3x the table's bytes from L2); the table gradient 0.16 ms
// on a training step's inputs, 14% of its bound (the shared adds' loops);
// the input gradient 0.077 ms on a D-NeRF step's inputs (M_pad 163,840),
// 19% of its bound (each (chunk, level) piece restages its window from L2,
// and its arithmetic is of the order of its bytes).
// Shared-memory rows are swizzled (`swz`) so that a dense level's
// neighbouring rows fall in different banks.  Sums land through shared (and,
// for split windows, global) atomics in an order that changes from run to
// run: each table entry matches an ordered sum to f32 reordering error.
//
// Input gradient: one CUDA block per (chunk of S tile-sorted blocks, pair
// of levels), the forward's chunks (`dx_schedule`).  Per level it stages each
// run's window once, as the forward does but with all of a thread's loads
// in flight at once, and gathers the 8 corners there (a one-block run with
// few live samples gathers from global memory); each sample's three sums
// wait in shared memory across the pair.  Deterministic: a sample's terms
// are added in (level, channel) order within a pair, and the pairs' partial
// sums [G, 3, M_pad] in order by a small second kernel in the same call.
// Its arithmetic is of the order of its bytes, so it is cut where no
// rounding changes: the derivative weights of two corners that differ in
// bit j are exact negatives (35 products per sample and level, not 96);
// each corner product of two bf16 values is exact in f32, so one FMA
// rounds as the separate add does; and a hashed level's swizzled slot is an
// XOR of three per-dimension parts, the offset's bit rotation and the
// swizzle being linear over XOR.
//
// All three compute a sample's cell with the same arithmetic (the forward
// and table gradient in `corner_geometry`, the input gradient in
// `dx_level_weights` and `row_offset`, the same rows), so a sample lands in
// the same cells in every pass.
// Positions use explicit round-to-nearest intrinsics so that nvcc does not
// contract x * scale + shift into an FMA, which would move samples across
// cell boundaries relative to the plain versions.
//
// Numerics: two forms of each kernel, a template flag F32 and a launcher
// each (`tngp_window_encode_{fwd,bwd,dx}` and their `_f32` twins).  The
// default form computes as the TPU's default bf16 MXU pass.  Forward
// (window_encode_ref with emulate_bf16=True): each corner's table value and
// weight round to bf16, the product is formed in f32 (exact for two bf16
// factors) and the 8 corners sum in f32 in corner order.  Backward: the
// product w * g is formed in f32 and rounded to bf16 ONCE (the TPU kernel
// rounds the product before its exact one-hot matmul), then summed in f32.
// Input gradient: the forward's numerics with the derivative weights, then
// f32 products with the cotangents summed in (level, channel) order within a
// group of levels and the groups' sums added in order.
// The f32 form (F32 = true; the TPU kernels' `mxu_f32` form, Precision
// HIGHEST, `window_encode_ref(emulate_bf16=False)`) rounds nothing to bf16:
// the forward stages each window as f32 words, one plane per channel (64 KB
// for C = 2; with C = 8 the 256 KB would not fit, so that form gathers from
// global memory), and every product w * v, w * g or dw * t is a separate
// round-to-nearest multiply before its add (`__fmul_rn` then `__fadd_rn`, as
// the plain versions compute them: an f32 product is not exact, so one FMA
// would round once where they round twice).  The schedules are the default
// form's: at C = 2 the forward's 64 KB stage leaves three blocks of 512
// threads a multiprocessor (228 KB), the input gradient's 64 KB + 48 KB two.
// Padding slots carry validity 0 as the first factor of w and so add
// nothing.  The cotangents arrive as g_sorted [M_pad, L*C] row-major (the
// scatter-add sort of the [M, L*C] cotangent rows).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#define WIN_ROWS 8192
#define WIN_LANES 128
#define WIN_HI 64

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A corner's operand as the form uses it: rounded to bf16 in the default
// form, unrounded in the f32 form.
template <bool F32>
__device__ __forceinline__ float operand(float x) {
  return F32 ? x : bf16_round(x);
}

// 32-bit planes of WIN_ROWS words a staged window takes: the default form
// packs two bf16 channels to a word; the f32 form takes one plane per
// channel, and none with C = 8 (256 KB: it gathers from global memory).
template <int C, bool F32>
__host__ __device__ constexpr int stage_planes() {
  return F32 ? (C <= 4 ? C : 0) : (C + 1) / 2;
}

// Offsets (within one channel of the window, lo * 64 + hi) and f32 weights
// (validity folded in first) of the 8 corners of sample p at one level, as
// the plain version builds them (`_corner_rows` in ops/window_table.py).
//
// A corner row of a dense level outside [0, WIN_ROWS) contributes nothing:
// its weights are 0 and its offset points at the valid row row & 8191.  The
// TPU kernel selects rows by one-hot matches of hi = row >> 7 against
// [0, 64), so such a row matches none; samples outside the unit cube (D-NeRF
// encodes x + dx) reach them.  Cell coordinates are 64-bit, so no product
// overflows before the range test.
__device__ __forceinline__ void corner_geometry(const float4 p, float scale, int side, int dense,
                                                float shift, int smooth, int off[8],
                                                float w[8]) {
  const float x[3] = {p.x, p.y, p.z};
  long long pg[3];
  float f[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = __fadd_rn(__fmul_rn(x[d], scale), shift);
    const float g = floorf(pos);
    const float fr = __fsub_rn(pos, g);
    f[d] = smooth ? __fmul_rn(__fmul_rn(fr, fr), __fsub_rn(3.0f, __fmul_rn(2.0f, fr))) : fr;
    pg[d] = (long long)g;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const long long c0 = pg[0] + (k & 1);
    const long long c1 = pg[1] + ((k >> 1) & 1);
    const long long c2 = pg[2] + ((k >> 2) & 1);
    long long row;
    bool in_range = true;
    if (dense) {
      row = c0 + c1 * side + c2 * side * side;
      in_range = row >= 0 && row < WIN_ROWS;
    } else {
      row = (uint32_t)c0 ^ ((uint32_t)c1 * 2654435761u) ^ ((uint32_t)c2 * 805459861u);
    }
    const int r = (int)(row & (WIN_ROWS - 1));
    float wk = p.w;  // validity: padding slots weigh 0
#pragma unroll
    for (int d = 0; d < 3; ++d)
      wk = __fmul_rn(wk, ((k >> d) & 1) ? f[d] : __fsub_rn(1.0f, f[d]));
    w[k] = in_range ? wk : 0.0f;
    off[k] = (r & (WIN_LANES - 1)) * WIN_HI + (r >> 7);
  }
}

// ---------------------------------------------------------------------------
// The table gradient's schedule
// ---------------------------------------------------------------------------

// A CUDA block takes one (chunk, level): chunk c is the S tile-sorted blocks
// [c S, (c + 1) S) of wob[l].  A run is a maximal stretch of blocks with one
// window; wob[l] is nondecreasing, so each window visited at a level is one
// run.  A run of at most 2 S blocks is short: the chunk that holds its first
// block takes all of it (it may reach into the next chunk, which skips it).
// A longer run is cut at chunk edges, and each chunk takes its own piece.
// Every block of the level lies in exactly one piece, every piece in one
// window (`encoder_pieces` in tests/test_torch_window_schedule.py states
// the same rule in Python, and the tests there hold the walk to it).
//
// A chunk classifies a run from the stretch of wob[l] within 2 S + 1 blocks
// of its own blocks, loaded once into shared memory: a run that reaches the
// edge of that stretch has more than 2 S blocks, so it is long, and a short
// run's ends always lie inside it.
#define MAX_CHUNK 16  // blocks per chunk, at most (the wrapper's chunk_blocks)
#define WALK_SPAN (5 * MAX_CHUNK + 2)

struct ChunkWalk {
  const int* sw;  // wob[l][lo, hi) in shared memory
  int lo, hi, NB, S, c, b;

  // The next piece [p0, p1) of this chunk and whether it is a whole short
  // run (store) or a piece of a long one (add); false when none is left.
  __device__ bool next(int& p0, int& p1, bool& store) {
    const int end = min(NB, (c + 1) * S);
    while (b < end) {
      const int w = sw[b - lo];
      int r0 = b, r1 = b + 1;
      while (r0 > lo && sw[r0 - 1 - lo] == w) --r0;
      while (r1 < hi && sw[r1 - lo] == w) ++r1;
      if (r1 - r0 > 2 * S) {
        p0 = b;
        p1 = min(r1, end);
        store = false;
        b = p1;
        return true;
      }
      b = r1;
      if (r0 < c * S) continue;  // a short run that an earlier chunk takes
      p0 = r0;
      p1 = r1;
      store = true;
      return true;
    }
    return false;
  }
};

__device__ __forceinline__ ChunkWalk load_walk(int* sw, const int32_t* __restrict__ wl,
                                               int NB, int S) {
  const int c = blockIdx.x;
  const int lo = max(0, (c - 2) * S - 1), hi = min(NB, (c + 3) * S + 1);
  for (int i = threadIdx.x; i < hi - lo; i += blockDim.x) sw[i] = wl[lo + i];
  __syncthreads();
  return ChunkWalk{sw, lo, hi, NB, S, c, c * S};
}

// ---------------------------------------------------------------------------
// Shared-memory layout of a window
// ---------------------------------------------------------------------------

// Shared-memory slot of window position p = lo * 64 + hi.  Position p's
// bank would be hi mod 32, so the neighbouring rows of a dense level (the
// same hi, lo one apart) would collide; XOR-ing the 4-slot group index with
// lo & 7 spreads them over 8 bank groups and keeps each aligned group of 4
// positions together and in order (16-byte staging and flushing).
__device__ __forceinline__ int swz(int p) { return p ^ (((p >> 6) & 7) << 2); }

// Two channels of a row as the bf16 values the numerics use, in one word.
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}

// Stage the window at tw (C planes of WIN_ROWS f32) into shared memory,
// rows swizzled: in the default form as bf16 channel pairs, NP = (C + 1) / 2
// planes of WIN_ROWS words; in the f32 form as C planes of f32 words.
// 16-byte loads where tw is 16-byte aligned (the forward's table always is),
// else 4-byte ones.  The whole block calls it.  With THREADS, the block's
// size, each thread issues all of its loads before it converts and stores
// any (one trip to L2 per staging, for registers that the input gradient
// has to spare and the forward has not); else a loop over the 16-byte
// groups.
template <int C, bool F32, int THREADS = 0>
__device__ __forceinline__ void stage_window(uint4* stage4, const float* __restrict__ tw) {
  constexpr int NP = stage_planes<C, F32>(), PER = THREADS ? WIN_ROWS / 4 / THREADS : 1;
  static_assert(THREADS == 0 || WIN_ROWS / 4 % THREADS == 0, "the block must divide the window");
  const bool vec = (reinterpret_cast<uintptr_t>(tw) & 15) == 0;
  const int step = THREADS ? THREADS : blockDim.x;
  for (int q0 = threadIdx.x; q0 < WIN_ROWS / 4; q0 += PER * step) {
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      float4 a[PER], b[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const float* ta = tw + (F32 ? np : 2 * np) * WIN_ROWS + 4 * (q0 + i * step);
        const float* tb = ta + WIN_ROWS;
        b[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (vec) {
          a[i] = __ldg(reinterpret_cast<const float4*>(ta));
          if (!F32 && 2 * np + 1 < C) b[i] = __ldg(reinterpret_cast<const float4*>(tb));
        } else {
          a[i] = make_float4(__ldg(ta), __ldg(ta + 1), __ldg(ta + 2), __ldg(ta + 3));
          if (!F32 && 2 * np + 1 < C)
            b[i] = make_float4(__ldg(tb), __ldg(tb + 1), __ldg(tb + 2), __ldg(tb + 3));
        }
      }
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int r = 4 * (q0 + i * step);
        stage4[(np * WIN_ROWS + swz(r)) / 4] =
            F32 ? make_uint4(__float_as_uint(a[i].x), __float_as_uint(a[i].y),
                             __float_as_uint(a[i].z), __float_as_uint(a[i].w))
                : make_uint4(pack_bf16(a[i].x, b[i].x), pack_bf16(a[i].y, b[i].y),
                             pack_bf16(a[i].z, b[i].z), pack_bf16(a[i].w, b[i].w));
      }
    }
  }
}

// Channel c of staged slot s (the swizzled slot of a row): a bf16 half of a
// packed word in the default form, an f32 word in the f32 form.
template <bool F32>
__device__ __forceinline__ float staged_value(const uint32_t* stage, int c, int s) {
  if (F32) return __uint_as_float(stage[c * WIN_ROWS + s]);
  const uint32_t v = stage[(c >> 1) * WIN_ROWS + s];
  return __uint_as_float(c & 1 ? v & 0xffff0000u : v << 16);
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

#define FWD_THREADS 512
#define STAGE_MIN_LIVE 256  // a one-block run with fewer live samples gathers from global

// Per run of one window within the chunk: stage the window once into shared
// memory (`stage_window`), then each sample gathers its 8 corners there, in
// the default form one 4-byte load per corner and channel pair.  A one-block
// run with fewer than STAGE_MIN_LIVE live samples among its first
// FWD_THREADS (a small eval width, where most of a block is padding) skips
// the staging and gathers from global memory instead, as the f32 form does
// throughout with C = 8.  Every block of the chunk is written once; corner
// order and f32 rounding as the plain version.
template <int C, bool F32>
__global__ void __launch_bounds__(FWD_THREADS)
    window_fwd_kernel(const float4* __restrict__ xyz4, const int32_t* __restrict__ wob,
                      const float* __restrict__ table, const float* __restrict__ scales,
                      const int32_t* __restrict__ iconst, float* __restrict__ out, int M_pad,
                      int block, int L, int S, float shift, int smooth) {
  constexpr int NP = (C + 1) / 2, PLANES = stage_planes<C, F32>();
  extern __shared__ uint4 stage4[];  // [PLANES][WIN_ROWS] words, swizzled rows
  const uint32_t* stage = reinterpret_cast<const uint32_t*>(stage4);
  const int l = blockIdx.y, NB = M_pad / block;
  const float scale = scales[l];
  const int side = iconst[l], dense = iconst[L + l], woff = iconst[2 * L + l];
  float* outl = out + (size_t)l * C * M_pad;
  // the chunk's blocks [b0, b0 + n) and their windows, lane t holding block
  // b0 + t's (S <= 32): each warp finds the runs of one window from a ballot
  const int b0 = blockIdx.x * S, n = min(S, NB - b0), lane = threadIdx.x & 31;
  const int wl = lane < n ? wob[(size_t)l * NB + b0 + lane] : -1;
  const int wprev = __shfl_up_sync(0xffffffffu, wl, 1);
  unsigned heads = __ballot_sync(0xffffffffu, lane < n && (lane == 0 || wl != wprev));
  while (heads) {
    const int r0 = __ffs(heads) - 1;
    heads &= heads - 1;
    const int r1 = heads ? __ffs(heads) - 1 : n;
    const int p0 = b0 + r0, p1 = b0 + r1;
    const float* tw = table + (size_t)(woff + __shfl_sync(0xffffffffu, wl, r0)) * C * WIN_ROWS;
    const int m1 = p1 * block;
    int m = p0 * block + threadIdx.x;
    float4 p = m < m1 ? xyz4[m] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    // the barrier also keeps the stage until the previous run is done with it
    const int live = __syncthreads_count(p.w != 0.0f);
    const bool staged = PLANES > 0 && (p1 - p0 > 1 || live >= STAGE_MIN_LIVE);
    if (staged) {
      stage_window<C, F32>(stage4, tw);
      __syncthreads();
    }
    while (m < m1) {
      float acc[2 * NP];
#pragma unroll
      for (int c = 0; c < 2 * NP; ++c) acc[c] = 0.0f;
      if (p.w != 0.0f) {  // a padding slot gathers nothing and writes zeros
        int off[8];
        float w[8];
        corner_geometry(p, scale, side, dense, shift, smooth, off, w);
        if (staged) {
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float wb = operand<F32>(w[k]);
            const int s = swz(off[k]);
            if constexpr (F32) {
#pragma unroll
              for (int c = 0; c < C; ++c)
                acc[c] = __fadd_rn(acc[c], __fmul_rn(wb, staged_value<true>(stage, c, s)));
            } else {
#pragma unroll
              for (int np = 0; np < NP; ++np) {
                const uint32_t v = stage[np * WIN_ROWS + s];
                acc[2 * np] = __fadd_rn(acc[2 * np], __fmul_rn(wb, __uint_as_float(v << 16)));
                acc[2 * np + 1] = __fadd_rn(acc[2 * np + 1],
                                            __fmul_rn(wb, __uint_as_float(v & 0xffff0000u)));
              }
            }
          }
        } else {
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float wb = operand<F32>(w[k]);
#pragma unroll
            for (int c = 0; c < C; ++c)
              acc[c] = __fadd_rn(
                  acc[c], __fmul_rn(wb, operand<F32>(__ldg(tw + c * WIN_ROWS + off[k]))));
          }
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) outl[(size_t)c * M_pad + m] = acc[c];
      m += blockDim.x;
      if (m < m1) p = xyz4[m];
    }
  }
}

// ---------------------------------------------------------------------------
// Table gradient
// ---------------------------------------------------------------------------

#define BWD_THREADS 512
#define ZERO_THREADS 256
#define MAX_LEVEL_WINDOWS 64  // N_TILES: a level has at most one window per tile

// The cell of sample p at a level, by the arithmetic of corner_geometry:
// two samples in one cell share all 8 corner rows.
__device__ __forceinline__ int3 cell_of(const float4 p, float scale, float shift) {
  return make_int3((int)floorf(__fadd_rn(__fmul_rn(p.x, scale), shift)),
                   (int)floorf(__fadd_rn(__fmul_rn(p.y, scale), shift)),
                   (int)floorf(__fadd_rn(__fmul_rn(p.z, scale), shift)));
}

// Consecutive samples along a ray often share a cell at the coarse levels,
// and their adds would then hit the same shared-memory words one after the
// other.  Each run of consecutive lanes in one cell sums its terms into the
// run's first lane (a segmented tree of shuffles: each lane ends with the
// sum of its run from itself on) and the other lanes drop theirs.  Any
// order of an entry's terms is within the reordering bound the results are
// held to.  The whole warp calls it.
template <int CG>
__device__ __forceinline__ void warp_sum_runs(float (&v)[8][CG], const int3 cell) {
  const unsigned lane = threadIdx.x & 31;
  const int px = __shfl_up_sync(0xffffffffu, cell.x, 1);
  const int py = __shfl_up_sync(0xffffffffu, cell.y, 1);
  const int pz = __shfl_up_sync(0xffffffffu, cell.z, 1);
  const bool head = lane == 0 || px != cell.x || py != cell.y || pz != cell.z;
  const unsigned heads = __ballot_sync(0xffffffffu, head);
  if (heads == 0xffffffffu) return;  // every lane in a cell of its own
  const unsigned after = heads & ~((2u << lane) - 1u);  // heads past this lane
  const unsigned end = after ? __ffs(after) - 1 : 32;   // end of this lane's run
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int j = 0; j < CG; ++j) {
        const float o = __shfl_down_sync(0xffffffffu, v[k][j], d);
        if (lane + d < end) v[k][j] = __fadd_rn(v[k][j], o);
      }
  }
  if (!head) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int j = 0; j < CG; ++j) v[k][j] = 0.0f;
  }
}

// Per piece and group of CG channels: zero a CG x 8192 f32 accumulator in
// shared memory, add every live sample's bf16(w * g) (in the f32 form the
// unrounded w * g) into it with shared
// atomics (runs of lanes in one cell summed first, `warp_sum_runs`), then
// flush it: a whole short run stores the window (zeros
// included, so the window needs no fill beforehand); a piece of a long run
// adds its nonzero 16-byte groups into the window with vector atomics.
template <int C, bool F32>
__global__ void __launch_bounds__(BWD_THREADS, 3)
    window_bwd_kernel(const float4* __restrict__ xyz4, const int32_t* __restrict__ wob,
                      const float* __restrict__ g_sorted, const float* __restrict__ scales,
                      const int32_t* __restrict__ iconst, float* __restrict__ gtab, int M_pad,
                      int block, int L, int S, float shift, int smooth) {
  constexpr int CG = C < 2 ? C : 2;
  constexpr int Q = WIN_ROWS / 4;  // 16-byte groups per channel
  extern __shared__ float4 acc4[];  // [CG][WIN_ROWS] f32, swizzled rows
  float* acc = reinterpret_cast<float*>(acc4);
  __shared__ int sw[WALK_SPAN];
  const int l = blockIdx.y, NB = M_pad / block;
  ChunkWalk walk = load_walk(sw, wob + (size_t)l * NB, NB, S);
  const float scale = scales[l];
  const int side = iconst[l], dense = iconst[L + l], woff = iconst[2 * L + l];
  const float* gl = g_sorted + l * C;
  int p0, p1;
  bool store;
  while (walk.next(p0, p1, store)) {
    float* gw = gtab + (size_t)(woff + sw[p0 - walk.lo]) * C * WIN_ROWS;
    for (int c0 = 0; c0 < C; c0 += CG) {
      __syncthreads();  // the last flush has read the accumulator
      for (int i = threadIdx.x; i < CG * Q; i += blockDim.x)
        acc4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      __syncthreads();
      // whole warps per step (a padding or surplus lane adds zeros), so the
      // lanes can combine their terms
      for (int base = p0 * block; base < p1 * block; base += blockDim.x) {
        const int m = base + threadIdx.x;
        const float4 p = m < p1 * block ? xyz4[m] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        int off[8];
        float w[8];
        corner_geometry(p, scale, side, dense, shift, smooth, off, w);
        float v[8][CG];
#pragma unroll
        for (int j = 0; j < CG; ++j) {
          // padding: every contribution is bf16(0 * g) = 0
          const float g = p.w != 0.0f ? gl[(size_t)m * (L * C) + c0 + j] : 0.0f;
#pragma unroll
          for (int k = 0; k < 8; ++k) v[k][j] = operand<F32>(__fmul_rn(w[k], g));
        }
        warp_sum_runs<CG>(v, cell_of(p, scale, shift));
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int s = swz(off[k]);
#pragma unroll
          for (int j = 0; j < CG; ++j)
            if (v[k][j] != 0.0f) atomicAdd(acc + j * WIN_ROWS + s, v[k][j]);
        }
      }
      __syncthreads();
      for (int i = threadIdx.x; i < CG * Q; i += blockDim.x) {
        const int j = i / Q, p = 4 * (i % Q);
        const float4 v = acc4[(j * WIN_ROWS + swz(p)) / 4];
        float4* dst = reinterpret_cast<float4*>(gw + (size_t)(c0 + j) * WIN_ROWS + p);
        if (store)
          *dst = v;
        else if (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f)
          atomicAdd(dst, v);
      }
    }
  }
}

__device__ __forceinline__ int lower_bound_i32(const int32_t* __restrict__ a, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Zeroes each window that no short run stores: a window that no block
// visits, and a window whose run is long (its pieces add into it).  One
// CUDA block per (window, level); a binary search in the nondecreasing
// wob[l] finds the window's run.
__global__ void __launch_bounds__(ZERO_THREADS)
    window_bwd_zero_kernel(const int32_t* __restrict__ wob, const int32_t* __restrict__ iconst,
                           float* __restrict__ gtab, int NB, int L, int S, int C) {
  const int w = blockIdx.x, l = blockIdx.y;
  if (w >= iconst[3 * L + l]) return;
  const int32_t* wl = wob + (size_t)l * NB;
  const int n = lower_bound_i32(wl, NB, w + 1) - lower_bound_i32(wl, NB, w);
  if (n > 0 && n <= 2 * S) return;
  float4* dst = reinterpret_cast<float4*>(gtab + (size_t)(iconst[2 * L + l] + w) * C * WIN_ROWS);
  for (int i = threadIdx.x; i < C * WIN_ROWS / 4; i += blockDim.x)
    dst[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// ---------------------------------------------------------------------------
// Input gradient
// ---------------------------------------------------------------------------

#define DX_THREADS 512
#define DX_MIN_BLOCKS 2  // resident blocks per SM: at most 64 registers a thread
#define DX_MAX_CHUNK_SAMPLES 4096  // S * block, at most (the accumulators' room)

// The derivative weights of sample p's corners at one level, rounded to
// bf16 in the default form (unrounded in the f32 form), as the TPU kernel's `deriv=j` pass and the plain version
// (`_corner_rows(deriv=True)`) form them: dw[j][k] is the f32 product, in
// this order, of the validity, per dimension d the factor of corner bit
// b_d (f or 1 - f, or for d = j: +-df, +-1 when linear) and the scale.  The
// two corners that differ only in bit j get factors df and -df, so their
// dw[j] are exact negatives (each product then only flips its sign, and so
// does the rounding to bf16): dwp[j][i] holds the four corners with bit j
// set, i the other two bits in order, and the kernel negates for the rest.
// That is 35 products per sample and level, not 96.  Also the cell
// coordinates pg, from which the corners' rows follow.
template <bool F32>
__device__ __forceinline__ void dx_level_weights(const float4 p, float scale, float shift,
                                                 int smooth, long long pg[3],
                                                 float dwp[3][4]) {
  const float x[3] = {p.x, p.y, p.z};
  float a[3][2], df[3];  // per dimension: the weight factors of bit 0 and 1, and df
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = __fadd_rn(__fmul_rn(x[d], scale), shift);
    const float g = floorf(pos);
    const float fr = __fsub_rn(pos, g);
    float f = fr;
    df[d] = 1.0f;  // linear: the factor is +-1, a sign flip
    if (smooth) {
      f = __fmul_rn(__fmul_rn(fr, fr), __fsub_rn(3.0f, __fmul_rn(2.0f, fr)));
      df[d] = __fmul_rn(__fmul_rn(6.0f, fr), __fsub_rn(1.0f, fr));
    }
    a[d][0] = __fsub_rn(1.0f, f);
    a[d][1] = f;
    pg[d] = (long long)g;
  }
  const float u0 = __fmul_rn(p.w, df[0]);                                   // j = 0, b0 = 1
  const float v0[2] = {__fmul_rn(p.w, a[0][0]), __fmul_rn(p.w, a[0][1])};  // j = 1, 2
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int lo = i & 1, hi = i >> 1;  // the other two bits, lower dimension first
    // j = 0: bits (b1, b2) = (lo, hi); j = 1: (b0, b2); j = 2: (b0, b1)
    const float w0 = __fmul_rn(__fmul_rn(u0, a[1][lo]), a[2][hi]);
    const float w1 = __fmul_rn(__fmul_rn(v0[lo], df[1]), a[2][hi]);
    const float w2 = __fmul_rn(__fmul_rn(v0[lo], a[1][hi]), df[2]);
    dwp[0][i] = operand<F32>(__fmul_rn(w0, scale));
    dwp[1][i] = operand<F32>(__fmul_rn(w1, scale));
    dwp[2][i] = operand<F32>(__fmul_rn(w2, scale));
  }
}

// Corner k's derivative weight along dimension j from dx_level_weights'
// four: the one with bit j set, negated where bit j is clear.
__device__ __forceinline__ float dx_weight(const float dwp[3][4], int j, int k) {
  const int i = j == 0 ? k >> 1 : j == 1 ? (k & 1) | ((k >> 2) << 1) : k & 3;
  return (k >> j) & 1 ? dwp[j][i] : -dwp[j][i];
}

// Window offset lo * 64 + hi of row r & 8191: a rotation of its 13 bits.
__device__ __forceinline__ uint32_t row_offset(uint32_t r) {
  return ((r & (WIN_LANES - 1)) << 6) | ((r >> 7) & (WIN_HI - 1));
}

// One corner's terms: its 8192-row table values t_c (from the stage, or
// from global memory) times its derivative weights dw[j], added to d[c][j].
// In the default form dw and t are bf16 values, so each product is exact in
// f32 and one FMA rounds once, as the separate multiply and add of the plain
// version do; in the f32 form the product rounds, so it is a separate
// multiply and add.
template <int C, bool F32>
__device__ __forceinline__ void dx_corner_terms(int off, const float dw[3], bool staged,
                                                const uint32_t* stage,
                                                const float* __restrict__ tw,
                                                float (&d)[C][3]) {
  constexpr int NP = (C + 1) / 2;
  float t[2 * NP];
  if (staged) {  // off is the swizzled slot here
    if constexpr (F32) {
#pragma unroll
      for (int c = 0; c < C; ++c) t[c] = staged_value<true>(stage, c, off);
    } else {
#pragma unroll
      for (int np = 0; np < NP; ++np) {
        const uint32_t v = stage[np * WIN_ROWS + off];
        t[2 * np] = __uint_as_float(v << 16);
        t[2 * np + 1] = __uint_as_float(v & 0xffff0000u);
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) t[c] = operand<F32>(__ldg(tw + c * WIN_ROWS + off));
  }
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      d[c][j] = F32 ? __fadd_rn(d[c][j], __fmul_rn(dw[j], t[c])) : __fmaf_rn(dw[j], t[c], d[c][j]);
}

// Input gradient: per tile-sorted sample, gx[j] = sum over (l, c) of
// g[l, c] * d[l, c, j], where d[l, c, j] = sum over corners k of
// bf16(dw[j][k]) * bf16(table value) (unrounded in the f32 form), in corner
// order, in f32 — the value the TPU kernel's `deriv=j` forward pass gives.
// One CUDA block per (chunk of S tile-sorted blocks, group of LG levels): per
// level it walks the chunk's runs of one window as the forward does, stages
// each run's window once (`stage_window`; a one-block run with few live
// samples gathers from global memory, as the f32 form does throughout with
// C = 8), and adds each live sample's terms for that level, in
// channel order, to the sample's three sums, which sit in shared memory
// (one slot per sample and j, only ever touched by one thread at a time)
// until the group's levels are done.  Then the sums go to part[group, j,
// m]; with one group that is gx itself.  Padding slots add nothing and
// write zeros.
template <int C, bool F32>
__global__ void __launch_bounds__(DX_THREADS, DX_MIN_BLOCKS)
    window_dx_kernel(const float4* __restrict__ xyz4, const int32_t* __restrict__ wob,
                     const float* __restrict__ table, const float* __restrict__ g_sorted,
                     const float* __restrict__ scales, const int32_t* __restrict__ iconst,
                     float* __restrict__ part, int M_pad, int block, int L, int S, int LG,
                     float shift, int smooth) {
  constexpr int PLANES = stage_planes<C, F32>();
  extern __shared__ uint4 smem4[];  // [PLANES][WIN_ROWS] words, then [3][S * block] f32
  const uint32_t* stage = reinterpret_cast<const uint32_t*>(smem4);
  float* acc = reinterpret_cast<float*>(smem4 + PLANES * WIN_ROWS / 4);
  const int cap = S * block;
  const int NB = M_pad / block, lane = threadIdx.x & 31;
  const int b0 = blockIdx.x * S, n = min(S, NB - b0);
  const int m0 = b0 * block, len = n * block;
  const int l0 = blockIdx.y * LG, l1 = min(L, l0 + LG);
  for (int i = threadIdx.x; i < len; i += blockDim.x) acc[i] = acc[cap + i] = acc[2 * cap + i] = 0.0f;
  for (int l = l0; l < l1; ++l) {
    const float scale = scales[l];
    const int dense = iconst[L + l], woff = iconst[2 * L + l];
    const unsigned long long side1 = (unsigned long long)iconst[l], side2 = side1 * side1;
    const float* gl = g_sorted + l * C;
    // the chunk's runs of one window, as the forward finds them
    const int wl = lane < n ? wob[(size_t)l * NB + b0 + lane] : -1;
    const int wprev = __shfl_up_sync(0xffffffffu, wl, 1);
    unsigned heads = __ballot_sync(0xffffffffu, lane < n && (lane == 0 || wl != wprev));
    while (heads) {
      const int r0 = __ffs(heads) - 1;
      heads &= heads - 1;
      const int r1 = heads ? __ffs(heads) - 1 : n;
      const float* tw =
          table + (size_t)(woff + __shfl_sync(0xffffffffu, wl, r0)) * C * WIN_ROWS;
      const int pm1 = (b0 + r1) * block;
      int m = (b0 + r0) * block + threadIdx.x;
      float4 p = m < pm1 ? xyz4[m] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      // the barrier also keeps the stage and the sums until the previous run
      // is done with them
      const int live = __syncthreads_count(p.w != 0.0f);
      const bool staged = PLANES > 0 && (r1 - r0 > 1 || live >= STAGE_MIN_LIVE);
      if (staged) {
        stage_window<C, F32, DX_THREADS>(smem4, tw);
        __syncthreads();
      }
      while (m < pm1) {
        if (p.w != 0.0f) {  // a padding slot adds nothing
          long long pg[3];
          float dwp[3][4];
          dx_level_weights<F32>(p, scale, shift, smooth, pg, dwp);
          float d[C][3];
#pragma unroll
          for (int c = 0; c < C; ++c) d[c][0] = d[c][1] = d[c][2] = 0.0f;
          if (dense) {
            const unsigned long long row0 = (unsigned long long)pg[0] +
                                            (unsigned long long)pg[1] * side1 +
                                            (unsigned long long)pg[2] * side2;
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              const long long row = (long long)(row0 + (k & 1) + ((k >> 1) & 1) * side1 +
                                                (k >> 2) * side2);
              const bool in = row >= 0 && row < WIN_ROWS;  // else the corner weighs nothing
              const uint32_t off = row_offset((uint32_t)row);
              const float dw[3] = {in ? dx_weight(dwp, 0, k) : 0.0f,
                                   in ? dx_weight(dwp, 1, k) : 0.0f,
                                   in ? dx_weight(dwp, 2, k) : 0.0f};
              dx_corner_terms<C, F32>(staged ? swz(off) : off, dw, staged, stage, tw, d);
            }
          } else {
            // the hash is an XOR of one part per dimension, and the offset's
            // bit rotation and the stage's swizzle are linear over XOR: each
            // corner's slot is an XOR of three precomputed parts
            uint32_t xp[3][2];
#pragma unroll
            for (int b = 0; b < 2; ++b) {
              xp[0][b] = row_offset((uint32_t)pg[0] + b);
              xp[1][b] = row_offset(((uint32_t)pg[1] + b) * 2654435761u);
              xp[2][b] = row_offset(((uint32_t)pg[2] + b) * 805459861u);
              if (staged) xp[0][b] = swz(xp[0][b]), xp[1][b] = swz(xp[1][b]),
                          xp[2][b] = swz(xp[2][b]);
            }
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              const float dw[3] = {dx_weight(dwp, 0, k), dx_weight(dwp, 1, k),
                                   dx_weight(dwp, 2, k)};
              dx_corner_terms<C, F32>(xp[0][k & 1] ^ xp[1][(k >> 1) & 1] ^ xp[2][k >> 2],
                                      dw, staged, stage, tw, d);
            }
          }
          float* am = acc + (m - m0);
          float s[3] = {am[0], am[cap], am[2 * cap]};
          const float* gm = gl + (size_t)m * (L * C);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float g = __ldg(gm + c);
#pragma unroll
            for (int j = 0; j < 3; ++j) s[j] = __fadd_rn(s[j], __fmul_rn(g, d[c][j]));
          }
          am[0] = s[0];
          am[cap] = s[1];
          am[2 * cap] = s[2];
        }
        m += blockDim.x;
        if (m < pm1) p = xyz4[m];
      }
    }
  }
  __syncthreads();
  float* out = part + (size_t)blockIdx.y * 3 * M_pad + m0;
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    out[i] = acc[i];
    out[(size_t)M_pad + i] = acc[cap + i];
    out[2 * (size_t)M_pad + i] = acc[2 * cap + i];
  }
}

// gx = the level groups' partial sums added in group order: [G, 3 * M_pad]
// -> [3 * M_pad].
__global__ void window_dx_sum_kernel(const float* __restrict__ part, float* __restrict__ gx,
                                     int64_t n, int G) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = part[i];
    for (int g = 1; g < G; ++g) s = __fadd_rn(s, part[g * n + i]);
    gx[i] = s;
  }
}

// Dynamic shared memory above the 48 KB default must be allowed per kernel
// and device; `done` keeps one bit per device, so the attribute is set on
// the first launch only (and not while a CUDA graph captures a later one).
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, int bytes, unsigned long long& done) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && (done >> dev & 1))) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) done |= 1ull << dev;
  return err;
}

template <int C, bool F32>
static int launch_fwd(const float4* x4, const int32_t* wob, const float* table,
                      const float* scales, const int32_t* iconst, float* out, int M_pad,
                      int block, int L, int S, float shift, int smooth, cudaStream_t stream) {
  static unsigned long long done = 0;
  const int smem = stage_planes<C, F32>() * WIN_ROWS * 4;
  const cudaError_t err = allow_smem(window_fwd_kernel<C, F32>, smem, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M_pad / block + S - 1) / S, L);
  window_fwd_kernel<C, F32><<<grid, FWD_THREADS, smem, stream>>>(
      x4, wob, table, scales, iconst, out, M_pad, block, L, S, shift, smooth);
  return 0;
}

template <int C, bool F32>
static int launch_bwd(const float4* x4, const int32_t* wob, const float* g_sorted,
                      const float* scales, const int32_t* iconst, float* gtab, int M_pad,
                      int block, int L, int S, float shift, int smooth, cudaStream_t stream) {
  static unsigned long long done = 0;
  const int smem = (C < 2 ? C : 2) * WIN_ROWS * 4;
  const cudaError_t err = allow_smem(window_bwd_kernel<C, F32>, smem, done);
  if (err != cudaSuccess) return (int)err;
  const int NB = M_pad / block;
  // with no samples (M_pad = 0) every window is unvisited: the zeroing alone
  window_bwd_zero_kernel<<<dim3(MAX_LEVEL_WINDOWS, L), ZERO_THREADS, 0, stream>>>(
      wob, iconst, gtab, NB, L, S, C);
  if (NB > 0)
    window_bwd_kernel<C, F32><<<dim3((NB + S - 1) / S, L), BWD_THREADS, smem, stream>>>(
        x4, wob, g_sorted, scales, iconst, gtab, M_pad, block, L, S, shift, smooth);
  return 0;
}

template <int C, bool F32>
static int launch_dx(const float4* x4, const int32_t* wob, const float* table,
                     const float* g_sorted, const float* scales, const int32_t* iconst,
                     float* part, float* gx, int M_pad, int block, int L, int S, int LG,
                     float shift, int smooth, cudaStream_t stream) {
  static unsigned long long done = 0;
  const int stage_bytes = stage_planes<C, F32>() * WIN_ROWS * 4;
  // the attribute is set once, for the largest chunk the launcher takes
  const cudaError_t err =
      allow_smem(window_dx_kernel<C, F32>, stage_bytes + 3 * DX_MAX_CHUNK_SAMPLES * 4, done);
  if (err != cudaSuccess) return (int)err;
  const int G = (L + LG - 1) / LG;
  const dim3 grid((M_pad / block + S - 1) / S, G);
  window_dx_kernel<C, F32><<<grid, DX_THREADS, stage_bytes + 3 * S * block * 4, stream>>>(
      x4, wob, table, g_sorted, scales, iconst, G > 1 ? part : gx, M_pad, block, L, S, LG, shift,
      smooth);
  if (G > 1) {
    const int64_t n = 3 * (int64_t)M_pad;
    const int threads = 256;
    const int blocks = (int)std::min<int64_t>((n + threads - 1) / threads, 4096);
    window_dx_sum_kernel<<<blocks, threads, 0, stream>>>(part, gx, n, G);
  }
  return 0;
}

#define DISPATCH_LAUNCH(LAUNCH, F32, ...)            \
  switch (C) {                                       \
    case 1: rc = LAUNCH<1, F32>(__VA_ARGS__); break; \
    case 2: rc = LAUNCH<2, F32>(__VA_ARGS__); break; \
    case 4: rc = LAUNCH<4, F32>(__VA_ARGS__); break; \
    case 8: rc = LAUNCH<8, F32>(__VA_ARGS__); break; \
    default: return (int)cudaErrorInvalidValue;      \
  }

template <bool F32>
static int encode_fwd(const float* xyz4, const int32_t* wob, const float* table,
                      const float* scales, const int32_t* iconst, float* out, int M_pad,
                      int block, int L, int C, int S, float shift, int smooth,
                      cudaStream_t stream) {
  if (S < 1 || S > MAX_CHUNK || block <= 0 || M_pad % block) return (int)cudaErrorInvalidValue;
  int rc = 0;
  if (M_pad > 0 && L > 0) {
    DISPATCH_LAUNCH(launch_fwd, F32, reinterpret_cast<const float4*>(xyz4), wob, table, scales,
                    iconst, out, M_pad, block, L, S, shift, smooth, stream)
  }
  return rc ? rc : (int)cudaGetLastError();
}

template <bool F32>
static int encode_bwd(const float* xyz4, const int32_t* wob, const float* g_sorted,
                      const float* scales, const int32_t* iconst, float* gtab, int M_pad,
                      int block, int L, int C, int S, float shift, int smooth,
                      cudaStream_t stream) {
  if (S < 1 || S > MAX_CHUNK || block <= 0 || M_pad % block) return (int)cudaErrorInvalidValue;
  int rc = 0;
  if (L > 0) {
    DISPATCH_LAUNCH(launch_bwd, F32, reinterpret_cast<const float4*>(xyz4), wob, g_sorted,
                    scales, iconst, gtab, M_pad, block, L, S, shift, smooth, stream)
  }
  return rc ? rc : (int)cudaGetLastError();
}

template <bool F32>
static int encode_dx(const float* xyz4, const int32_t* wob, const float* table,
                     const float* g_sorted, const float* scales, const int32_t* iconst,
                     float* part, float* gx, int M_pad, int block, int L, int C, int S, int LG,
                     float shift, int smooth, cudaStream_t stream) {
  if (S < 1 || S > 32 || LG < 1 || block <= 0 || M_pad % block ||
      (int64_t)S * block > DX_MAX_CHUNK_SAMPLES)
    return (int)cudaErrorInvalidValue;
  int rc = 0;
  if (M_pad > 0 && L > 0) {
    DISPATCH_LAUNCH(launch_dx, F32, reinterpret_cast<const float4*>(xyz4), wob, table, g_sorted,
                    scales, iconst, part, gx, M_pad, block, L, S, LG, shift, smooth, stream)
  }
  return rc ? rc : (int)cudaGetLastError();
}

// xyz4 [M_pad, 4] f32 (x01, y01, z01, valid), tile-sorted in blocks of `block`;
// wob [L, M_pad / block] int32 window of each block within its level, each
// row nondecreasing; table [n_windows, C, 128, 64] f32, 16-byte aligned;
// scales [L] f32; iconst [4, L] int32 (side, dense, window offset, windows);
// S blocks per chunk, 1..MAX_CHUNK; out [L * C, M_pad] f32, every entry
// written.  Each `_f32` launcher runs the f32 form of its kernel.
extern "C" int tngp_window_encode_fwd(const float* xyz4, const int32_t* wob,
                                      const float* table, const float* scales,
                                      const int32_t* iconst, float* out,
                                      int M_pad, int block, int L, int C, int S,
                                      float shift, int smooth,
                                      cudaStream_t stream) {
  return encode_fwd<false>(xyz4, wob, table, scales, iconst, out, M_pad, block, L, C, S, shift,
                           smooth, stream);
}

extern "C" int tngp_window_encode_fwd_f32(const float* xyz4, const int32_t* wob,
                                          const float* table, const float* scales,
                                          const int32_t* iconst, float* out, int M_pad,
                                          int block, int L, int C, int S, float shift,
                                          int smooth, cudaStream_t stream) {
  return encode_fwd<true>(xyz4, wob, table, scales, iconst, out, M_pad, block, L, C, S, shift,
                          smooth, stream);
}

// As above, with g_sorted [M_pad, L * C] f32 and gtab [n_windows, C, 128, 64]
// f32, 16-byte aligned, every entry written (no fill needed on entry).
extern "C" int tngp_window_encode_bwd(const float* xyz4, const int32_t* wob,
                                      const float* g_sorted,
                                      const float* scales,
                                      const int32_t* iconst, float* gtab,
                                      int M_pad, int block, int L, int C, int S,
                                      float shift, int smooth,
                                      cudaStream_t stream) {
  return encode_bwd<false>(xyz4, wob, g_sorted, scales, iconst, gtab, M_pad, block, L, C, S,
                           shift, smooth, stream);
}

extern "C" int tngp_window_encode_bwd_f32(const float* xyz4, const int32_t* wob,
                                          const float* g_sorted, const float* scales,
                                          const int32_t* iconst, float* gtab, int M_pad,
                                          int block, int L, int C, int S, float shift,
                                          int smooth, cudaStream_t stream) {
  return encode_bwd<true>(xyz4, wob, g_sorted, scales, iconst, gtab, M_pad, block, L, C, S,
                          shift, smooth, stream);
}

// As the forward, with g_sorted [M_pad, L * C] f32 (the sorted cotangent
// rows, any alignment; the table too), LG levels per CUDA block (1..L), S
// blocks per chunk with S * block <= DX_MAX_CHUNK_SAMPLES, part [G, 3, M_pad]
// f32 scratch for G = ceil(L / LG) > 1 groups (unused for one), and gx
// [3, M_pad] f32, every entry written.
extern "C" int tngp_window_encode_dx(const float* xyz4, const int32_t* wob,
                                     const float* table, const float* g_sorted,
                                     const float* scales, const int32_t* iconst, float* part,
                                     float* gx, int M_pad, int block, int L, int C, int S,
                                     int LG, float shift, int smooth, cudaStream_t stream) {
  return encode_dx<false>(xyz4, wob, table, g_sorted, scales, iconst, part, gx, M_pad, block, L,
                          C, S, LG, shift, smooth, stream);
}

extern "C" int tngp_window_encode_dx_f32(const float* xyz4, const int32_t* wob,
                                         const float* table, const float* g_sorted,
                                         const float* scales, const int32_t* iconst,
                                         float* part, float* gx, int M_pad, int block, int L,
                                         int C, int S, int LG, float shift, int smooth,
                                         cudaStream_t stream) {
  return encode_dx<true>(xyz4, wob, table, g_sorted, scales, iconst, part, gx, M_pad, block, L,
                         C, S, LG, shift, smooth, stream);
}
