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
// MXU, and the backward accumulates across consecutive blocks of one window
// because its grid runs in order.  A GPU gathers and adds atomically, so the
// kernels here address each corner's row directly: the forward and the
// backward take one thread per (sample, level), samples on threadIdx.x so the
// forward's [L*C, M_pad] output rows are written coalesced; the input
// gradient takes one thread per sample that loops over the levels and keeps
// its three sums in registers (one launch, no atomics, deterministic).  The
// samples arrive sorted into tile-pure blocks, so a warp's corners fall in
// one 64 KB window per level and stay in L1/L2.
//
// All three compute the corner rows and weights with one device function
// (`corner_geometry`), so a sample lands in the same cells in every pass.
// Positions use explicit round-to-nearest intrinsics so that nvcc does not
// contract x * scale + shift into an FMA, which would move samples across
// cell boundaries relative to the plain versions.
//
// Numerics as the TPU's default bf16 MXU pass.  Forward
// (window_encode_ref with emulate_bf16=True): each corner's table value and
// weight round to bf16, the product is formed in f32 (exact for two bf16
// factors) and the 8 corners sum in f32.  Backward: the product w * g is
// formed in f32 and rounded to bf16 ONCE (the TPU kernel rounds the product
// before its exact one-hot matmul), then summed in f32.  Input gradient: the
// forward's numerics with the derivative weights, then f32 products with the
// cotangents summed in (level, channel) order.  Padding slots carry validity
// 0 as the first factor of w and so add nothing.
//
// Backward layout: the cotangents arrive as g_sorted [M_pad, L*C] row-major
// (the scatter-add sort of the [M, L*C] cotangent rows), so a thread reads
// its level's C values as one contiguous C*4-byte piece.  The output
// [n_windows, C, 128, 64] must be zero on entry (the wrapper zero-fills it),
// which also gives windows that no block visits their zero gradient.  Sums
// land through atomicAdd in an order that changes from run to run: each
// table entry matches an ordered sum to f32 reordering error.
//
// Bound on the H100: bytes, all three.  Forward: 16 B in and 4*L*C B out per
// sample plus one read of each table window the samples visit.  Backward:
// 16 B + 4*L*C B in per sample plus one write of the whole gradient table
// (the zero-fill is that write; the atomics touch only the visited rows and
// add no second pass over the table).  Input gradient: 16 B + 4*L*C B in and
// 12 B out per sample plus one read of each visited window.  In practice the
// backward is limited by atomic contention on the coarse levels (a few
// thousand rows take every sample's 8 adds); the blocks are tile-pure, so a
// block-private accumulation of one 64 KB window per level in shared memory
// before one pass of global atomics is the redesign that removes it.  The
// input gradient's loads of the cotangent rows are strided across a warp
// (one 4*L*C-byte row per thread); staging a block's rows through shared
// memory is the first step to making it fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define WIN_ROWS 8192
#define WIN_LANES 128
#define WIN_HI 64

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Offsets (within one channel of the window, lo * 64 + hi) and f32 weights
// (validity folded in first) of the 8 corners of sample p at one level, and
// with DERIV also each weight's derivative along x01_j, dw[j][k], as the TPU
// kernel's `deriv=j` pass builds it (`_level_corner_geometry`): the validity
// times, in dimension order, ±1 (linear) or ±(6 f)(1 - f) of the raw fraction
// f (smoothstep) for dimension j and f or 1 - f for the others, times scale.
//
// A corner row of a dense level outside [0, WIN_ROWS) contributes nothing:
// its weights are 0 and its offset points at the valid row row & 8191.  The
// TPU kernel selects rows by one-hot matches of hi = row >> 7 against
// [0, 64), so such a row matches none; samples outside the unit cube (D-NeRF
// encodes x + dx) reach them.  Cell coordinates are 64-bit, so no product
// overflows before the range test.
template <bool DERIV>
__device__ __forceinline__ void corner_geometry(const float4 p, float scale,
                                                int side, int dense,
                                                float shift, int smooth,
                                                int off[8], float w[8],
                                                float dw[3][8]) {
  const float x[3] = {p.x, p.y, p.z};
  long long pg[3];
  float f[3], df[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = __fadd_rn(__fmul_rn(x[d], scale), shift);
    const float g = floorf(pos);
    const float fr = __fsub_rn(pos, g);
    if (smooth) {
      f[d] = __fmul_rn(__fmul_rn(fr, fr), __fsub_rn(3.0f, __fmul_rn(2.0f, fr)));
      df[d] = __fmul_rn(__fmul_rn(6.0f, fr), __fsub_rn(1.0f, fr));
    } else {
      f[d] = fr;
      df[d] = 1.0f;
    }
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
    if constexpr (DERIV) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        float v = p.w;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const bool bit = (k >> d) & 1;
          if (d == j)
            v = smooth ? __fmul_rn(v, bit ? df[d] : -df[d]) : (bit ? v : -v);
          else
            v = __fmul_rn(v, bit ? f[d] : __fsub_rn(1.0f, f[d]));
        }
        dw[j][k] = in_range ? __fmul_rn(v, scale) : 0.0f;
      }
    }
    off[k] = (r & (WIN_LANES - 1)) * WIN_HI + (r >> 7);
  }
}

template <int C>
__global__ void window_fwd_kernel(const float4* __restrict__ xyz4,
                                  const int32_t* __restrict__ wob,
                                  const float* __restrict__ table,
                                  const float* __restrict__ scales,
                                  const int32_t* __restrict__ iconst,
                                  float* __restrict__ out, int M_pad, int block,
                                  int L, float shift, int smooth) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  const int l = blockIdx.y;
  if (m >= M_pad) return;
  const int NB = M_pad / block;
  const int win = iconst[2 * L + l] + wob[(size_t)l * NB + m / block];
  const float* tw = table + (size_t)win * C * WIN_ROWS;
  int off[8];
  float w[8];
  corner_geometry<false>(xyz4[m], scales[l], iconst[l], iconst[L + l], shift, smooth, off, w,
                         nullptr);

  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float wb = bf16_round(w[k]);
#pragma unroll
    for (int c = 0; c < C; ++c)
      acc[c] = __fadd_rn(acc[c], __fmul_rn(wb, bf16_round(tw[c * WIN_ROWS + off[k]])));
  }
#pragma unroll
  for (int c = 0; c < C; ++c) out[((size_t)l * C + c) * M_pad + m] = acc[c];
}

template <int C>
__global__ void window_bwd_kernel(const float4* __restrict__ xyz4,
                                  const int32_t* __restrict__ wob,
                                  const float* __restrict__ g_sorted,
                                  const float* __restrict__ scales,
                                  const int32_t* __restrict__ iconst,
                                  float* __restrict__ gtab, int M_pad, int block,
                                  int L, float shift, int smooth) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  const int l = blockIdx.y;
  if (m >= M_pad) return;
  const float4 p = xyz4[m];
  if (p.w == 0.0f) return;  // padding slot: every contribution is bf16(0 * g) = 0
  const int NB = M_pad / block;
  const int win = iconst[2 * L + l] + wob[(size_t)l * NB + m / block];
  float* gw = gtab + (size_t)win * C * WIN_ROWS;
  int off[8];
  float w[8];
  corner_geometry<false>(p, scales[l], iconst[l], iconst[L + l], shift, smooth, off, w, nullptr);

  float g[C];
#pragma unroll
  for (int c = 0; c < C; ++c) g[c] = g_sorted[(size_t)m * (L * C) + l * C + c];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float v = bf16_round(__fmul_rn(w[k], g[c]));
      if (v != 0.0f) atomicAdd(gw + c * WIN_ROWS + off[k], v);
    }
  }
}

// Input gradient: per tile-sorted sample, gx[j] = sum over (l, c) of
// g[l, c] * d[l, c, j], where d[l, c, j] = sum over corners k of
// bf16(dw[j][k]) * bf16(table value), in corner order, in f32 — the value the
// TPU kernel's `deriv=j` forward pass gives — and the (l, c) terms are added
// in that order.  One thread per sample loops over the levels: no atomics,
// one write of gx [3, M_pad].
template <int C>
__global__ void window_dx_kernel(const float4* __restrict__ xyz4,
                                 const int32_t* __restrict__ wob,
                                 const float* __restrict__ table,
                                 const float* __restrict__ g_sorted,
                                 const float* __restrict__ scales,
                                 const int32_t* __restrict__ iconst,
                                 float* __restrict__ gx, int M_pad, int block,
                                 int L, float shift, int smooth) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M_pad) return;
  const float4 p = xyz4[m];
  float acc[3] = {0.0f, 0.0f, 0.0f};
  if (p.w != 0.0f) {  // padding slots: every derivative weight is 0
    const int NB = M_pad / block;
    for (int l = 0; l < L; ++l) {
      const int win = iconst[2 * L + l] + wob[(size_t)l * NB + m / block];
      const float* tw = table + (size_t)win * C * WIN_ROWS;
      int off[8];
      float w[8], dw[3][8];
      corner_geometry<true>(p, scales[l], iconst[l], iconst[L + l], shift, smooth, off, w, dw);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float t[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) t[k] = bf16_round(tw[c * WIN_ROWS + off[k]]);
        const float g = g_sorted[(size_t)m * (L * C) + l * C + c];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          float d = 0.0f;
#pragma unroll
          for (int k = 0; k < 8; ++k) d = __fadd_rn(d, __fmul_rn(bf16_round(dw[j][k]), t[k]));
          acc[j] = __fadd_rn(acc[j], __fmul_rn(g, d));
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) gx[(size_t)j * M_pad + m] = acc[j];
}

#define DISPATCH_C(KERNEL, ...)                                              \
  switch (C) {                                                               \
    case 1: KERNEL<1><<<grid, threads, 0, stream>>>(__VA_ARGS__); break;     \
    case 2: KERNEL<2><<<grid, threads, 0, stream>>>(__VA_ARGS__); break;     \
    case 4: KERNEL<4><<<grid, threads, 0, stream>>>(__VA_ARGS__); break;     \
    case 8: KERNEL<8><<<grid, threads, 0, stream>>>(__VA_ARGS__); break;     \
    default: return (int)cudaErrorInvalidValue;                              \
  }

// xyz4 [M_pad, 4] f32 (x01, y01, z01, valid), tile-sorted in blocks of `block`;
// wob [L, M_pad / block] int32 window of each block within its level;
// table [n_windows, C, 128, 64] f32; scales [L] f32; iconst [3, L] int32
// (side, dense, window offset); out [L * C, M_pad] f32.
extern "C" int tngp_window_encode_fwd(const float* xyz4, const int32_t* wob,
                                      const float* table, const float* scales,
                                      const int32_t* iconst, float* out,
                                      int M_pad, int block, int L, int C,
                                      float shift, int smooth,
                                      cudaStream_t stream) {
  const int threads = 256;
  dim3 grid((M_pad + threads - 1) / threads, L);
  const float4* x4 = reinterpret_cast<const float4*>(xyz4);
  if (M_pad > 0 && L > 0) {
    DISPATCH_C(window_fwd_kernel, x4, wob, table, scales, iconst, out, M_pad,
               block, L, shift, smooth)
  }
  return (int)cudaGetLastError();
}

// As above, with g_sorted [M_pad, L * C] f32 and gtab [n_windows, C, 128, 64]
// f32, which must be zero on entry.
extern "C" int tngp_window_encode_bwd(const float* xyz4, const int32_t* wob,
                                      const float* g_sorted,
                                      const float* scales,
                                      const int32_t* iconst, float* gtab,
                                      int M_pad, int block, int L, int C,
                                      float shift, int smooth,
                                      cudaStream_t stream) {
  const int threads = 256;
  dim3 grid((M_pad + threads - 1) / threads, L);
  const float4* x4 = reinterpret_cast<const float4*>(xyz4);
  if (M_pad > 0 && L > 0) {
    DISPATCH_C(window_bwd_kernel, x4, wob, g_sorted, scales, iconst, gtab,
               M_pad, block, L, shift, smooth)
  }
  return (int)cudaGetLastError();
}

// As the forward, with g_sorted [M_pad, L * C] f32 (the sorted cotangent
// rows) and gx [3, M_pad] f32, every entry written.
extern "C" int tngp_window_encode_dx(const float* xyz4, const int32_t* wob,
                                     const float* table, const float* g_sorted,
                                     const float* scales, const int32_t* iconst,
                                     float* gx, int M_pad, int block, int L,
                                     int C, float shift, int smooth,
                                     cudaStream_t stream) {
  const int threads = 128;
  dim3 grid((M_pad + threads - 1) / threads);
  const float4* x4 = reinterpret_cast<const float4*>(xyz4);
  if (M_pad > 0 && L > 0) {
    DISPATCH_C(window_dx_kernel, x4, wob, table, g_sorted, scales, iconst, gx,
               M_pad, block, L, shift, smooth)
  }
  return (int)cudaGetLastError();
}
