// Window encoder, forward and backward, over tile-sorted samples.
//
// Forward: per sample and level, the 8-corner trilinear (or smoothstep)
// interpolation of the window-layout table, with the window that the
// sample's tile-sorted block maps to at that level.  Backward: the table
// gradient in the same layout — per sample, level, corner and channel, the
// contribution w * g added into the corner's row.
//
// Replaces the TPU kernels tngp/kernels/window_encoder.py `_make_fwd_kernel`
// (launched by `_fwd_pallas`) and `_make_bwd_kernel` (launched by
// `_bwd_pallas`), reached through `window_encode_binned` and its VJP.  The
// TPU kernels cannot gather or scatter in VMEM, so they select rows with
// one-hot matrix products on the MXU, and the backward accumulates across
// consecutive blocks of one window because its grid runs in order.  A GPU
// gathers and adds atomically, so both kernels here address each corner's
// row directly: one thread per (sample, level), samples on threadIdx.x so
// the forward's [L*C, M_pad] output rows are written coalesced.  The samples
// arrive sorted into tile-pure blocks, so a warp's corners fall in one 64 KB
// window per level and stay in L1/L2.
//
// Both kernels compute the corner rows and weights with one device function
// (`corner_geometry`), so a sample lands in the same cells in both passes.
// Positions use explicit round-to-nearest intrinsics so that nvcc does not
// contract x * scale + shift into an FMA, which would move samples across
// cell boundaries relative to the plain versions.
//
// Numerics as the TPU's default bf16 MXU pass.  Forward
// (window_encode_ref with emulate_bf16=True): each corner's table value and
// weight round to bf16, the product is formed in f32 (exact for two bf16
// factors) and the 8 corners sum in f32.  Backward: the product w * g is
// formed in f32 and rounded to bf16 ONCE (the TPU kernel rounds the product
// before its exact one-hot matmul), then summed in f32.  Padding slots carry
// validity 0 as the first factor of w and so add nothing.
//
// Backward layout: the cotangents arrive as g_sorted [M_pad, L*C] row-major
// (the scatter-add sort of the [M, L*C] cotangent rows), so a thread reads
// its level's C values as one contiguous C*4-byte piece.  The output
// [n_windows, C, 128, 64] must be zero on entry (the wrapper zero-fills it),
// which also gives windows that no block visits their zero gradient.  Sums
// land through atomicAdd in an order that changes from run to run: each
// table entry matches an ordered sum to f32 reordering error.
//
// Bound on the H100: bytes, both ways.  Forward: 16 B in and 4*L*C B out per
// sample plus one read of each table window the samples visit.  Backward:
// 16 B + 4*L*C B in per sample plus one write of the whole gradient table
// (the zero-fill is that write; the atomics touch only the visited rows and
// add no second pass over the table).  In practice the backward is limited by atomic contention
// on the coarse levels (a few thousand rows take every sample's 8 adds); the
// blocks are tile-pure, so a block-private accumulation of one 64 KB window
// per level in shared memory before one pass of global atomics is the
// redesign that removes it.

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
// (validity folded in first) of the 8 corners of sample p at one level.
__device__ __forceinline__ void corner_geometry(const float4 p, float scale,
                                                int side, int dense,
                                                float shift, int smooth,
                                                int off[8], float w[8]) {
  const float x[3] = {p.x, p.y, p.z};
  int pg[3];
  float f[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = __fadd_rn(__fmul_rn(x[d], scale), shift);
    const float g = floorf(pos);
    float fr = __fsub_rn(pos, g);
    if (smooth) fr = __fmul_rn(__fmul_rn(fr, fr), __fsub_rn(3.0f, __fmul_rn(2.0f, fr)));
    f[d] = fr;
    pg[d] = (int)g;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int c0 = pg[0] + (k & 1);
    const int c1 = pg[1] + ((k >> 1) & 1);
    const int c2 = pg[2] + ((k >> 2) & 1);
    int row;
    if (dense) {
      row = c0 + c1 * side + c2 * side * side;
      row = min(max(row, 0), WIN_ROWS - 1);  // in range for x01 in [0, 1]
    } else {
      const uint32_t h = (uint32_t)c0 ^ ((uint32_t)c1 * 2654435761u) ^
                         ((uint32_t)c2 * 805459861u);
      row = (int)(h & (WIN_ROWS - 1));
    }
    float wk = p.w;  // validity: padding slots weigh 0
#pragma unroll
    for (int d = 0; d < 3; ++d)
      wk = __fmul_rn(wk, ((k >> d) & 1) ? f[d] : __fsub_rn(1.0f, f[d]));
    w[k] = wk;
    off[k] = (row & (WIN_LANES - 1)) * WIN_HI + (row >> 7);
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
  corner_geometry(xyz4[m], scales[l], iconst[l], iconst[L + l], shift, smooth, off, w);

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
  corner_geometry(p, scales[l], iconst[l], iconst[L + l], shift, smooth, off, w);

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
