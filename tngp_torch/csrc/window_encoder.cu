// Window-encoder forward: per sample and level, the 8-corner trilinear (or
// smoothstep) interpolation of the window-layout table, with the window that
// the sample's tile-sorted block maps to at that level.
//
// Replaces the TPU kernel tngp/kernels/window_encoder.py `_make_fwd_kernel`
// (launched by `_fwd_pallas`, reached through `window_encode_binned`).  The
// TPU kernel cannot gather from VMEM, so it selects rows with one-hot matrix
// products on the MXU.  A GPU gathers well, so this kernel reads each corner's
// row directly: one thread per (sample, level), samples on threadIdx.x so the
// [L*C, M_pad] output rows are written coalesced.  The samples arrive sorted
// into tile-pure blocks, so a warp's corners fall in one 64 KB window per
// level and stay in L1/L2.
//
// Numerics as the TPU's default bf16 MXU pass (window_encode_ref with
// emulate_bf16=True): each corner's table value and interpolation weight round
// to bf16, the product is formed in f32 (exact for two bf16 factors) and the
// 8 corners sum in f32.  Positions use explicit round-to-nearest intrinsics so
// that nvcc does not contract x * scale + shift into an FMA, which would move
// samples across cell boundaries relative to the plain version.
//
// Bound on the H100: bytes.  Compulsory traffic is 16 B in and 4*L*C B out per
// sample plus one read of each table window the samples visit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define WIN_ROWS 8192
#define WIN_LANES 128
#define WIN_HI 64

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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
  const float4 p = xyz4[m];
  const float scale = scales[l];
  const int side = iconst[l];
  const int dense = iconst[L + l];
  const int win = iconst[2 * L + l] + wob[(size_t)l * NB + m / block];
  const float* tw = table + (size_t)win * C * WIN_ROWS;

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

  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
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
    float w = p.w;  // validity: padding slots weigh 0
#pragma unroll
    for (int d = 0; d < 3; ++d)
      w = __fmul_rn(w, ((k >> d) & 1) ? f[d] : __fsub_rn(1.0f, f[d]));
    const float wb = bf16_round(w);
    const int off = (row & (WIN_LANES - 1)) * WIN_HI + (row >> 7);
#pragma unroll
    for (int c = 0; c < C; ++c)
      acc[c] = __fadd_rn(acc[c], __fmul_rn(wb, bf16_round(tw[c * WIN_ROWS + off])));
  }
#pragma unroll
  for (int c = 0; c < C; ++c) out[((size_t)l * C + c) * M_pad + m] = acc[c];
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
    switch (C) {
      case 1:
        window_fwd_kernel<1><<<grid, threads, 0, stream>>>(
            x4, wob, table, scales, iconst, out, M_pad, block, L, shift, smooth);
        break;
      case 2:
        window_fwd_kernel<2><<<grid, threads, 0, stream>>>(
            x4, wob, table, scales, iconst, out, M_pad, block, L, shift, smooth);
        break;
      case 4:
        window_fwd_kernel<4><<<grid, threads, 0, stream>>>(
            x4, wob, table, scales, iconst, out, M_pad, block, L, shift, smooth);
        break;
      case 8:
        window_fwd_kernel<8><<<grid, threads, 0, stream>>>(
            x4, wob, table, scales, iconst, out, M_pad, block, L, shift, smooth);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
