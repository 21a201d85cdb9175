// The chunked ray march of the training render and the frame renderer,
// `march_rays_chunked` (tngp_torch/ops/march.py), as three kernels in one
// call with nothing in torch between them.
//
// It replaces no Pallas kernel: the JAX package writes this march in XLA
// (tngp/ops/march.py `march_rays_chunked`), and its plain port,
// `march_rays_chunked_plain` (tngp_torch/kernels/march.py), follows that one
// op at a time.  That form is static-shaped: its fine stage probes the G
// rungs of all CB chunk slots of the chunk budget however few chunks are
// live (2,359,296 x 16 probes in an 800x800 frame's 65,536-ray first pass),
// compacts them with a cumsum and a scatter, and finds each ray's totals and
// last sample by two branch-free binary searches of bit_length(CB) steps:
// ~500 launches a call.  Here each ray walks its own ladder, so the work
// follows its live chunks:
//   1. `march_coarse_kernel`, a warp a ray: the lanes take 32 chunks at a
//      time, probe each chunk's t-midpoint against the dilated grid, and the
//      ballot is the live mask; the first `cap` live chunks are kept and the
//      (cap+1)-th is the cut (its t_lo, t_cut).  Writes the ray's noisy
//      origin t0, its mask words, live count L, cap flag and t_cut, and per
//      block the sum of L and the first live (ray, chunk);
//   2. `march_count_kernel`: each block sums the block sums before it and
//      all of them (the scan over rays: a few hundred numbers a block), then
//      each warp walks its rays in order with the global rank R of their
//      first live chunk: a ray keeps K = clamp(CB - R, 0, L) chunks, the
//      lanes probe its (chunk, rung) pairs against the bitfield and the
//      ballots count its valid rungs V.  Writes V, the chunk-budget cut flag
//      and per block the sum of V;
//   3. `march_write_kernel`: the same scan over V gives each ray's sample
//      base; the ray's first taken = clamp(m_eff - base, 0, V) valid rungs,
//      probed again, go to sel[base ...], and the last of them gives
//      resume_t; ray_mask and resume_t a ray; then every thread of the grid
//      writes its share of sel_valid over M_budget and of the padded tail of
//      sel, and block 0 the two counts.
// No memset, no host read, no atomics.  For the same inputs every output
// equals the plain version's on the card bit for bit
// (tests/test_torch_march_kernel_gpu.py).
//
// Float arithmetic follows the plain version's f32 expressions as torch's
// CUDA kernels evaluate them, op by op: each product and sum rounded alone
// (__fmul_rn / __fadd_rn / __fsub_rn; nvcc would contract them into FMAs);
// a tensor divided by a Python scalar as a product with the scalar's float
// reciprocal (torch's div_true on the card; the host computes the
// reciprocals, `kernels/march.py` `_float_consts`); `scalar / tensor` as
// reciprocal(tensor) * scalar (torch's __rtruediv__); clamp, maximum and
// minimum passing NaN on; expf, logf, exp2f, ceilf and floorf as torch's
// kernels call them (no fast math).
//
// Bound on the H100 (3.35 TB/s): bytes.  The call writes sel (8 B) and
// sel_valid (1 B) over M_budget and reads and writes ~40 B a ray (rays,
// t_start, fars, mask words and counts, t0, resume_t, ray_mask); the
// bitfield and the dilated grid are L2-resident.  An 800x800 frame's first
// pass (N = 65,536, M_budget = 6,291,456) moves ~59 MB, 0.018 ms; a TensoRF
// training step (N = 16,384, M_budget = 524,288) ~5.4 MB, 0.0016 ms.  The
// design reads each ray's inputs three times and probes its kept rungs
// twice (count, then write), from L1 and L2; PERF.md has its times.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define WARPS 8  // warps a block (kernels/march.py WARPS)
#define THREADS (WARPS * 32)
#define FULL 0xffffffffu
#define MAX_CHUNKS 2048  // NCr the shared chunk lists take (kernels/march.py)

struct Params {
  const float* o;
  const float* d;
  int64_t os0, os1, ds0, ds1;
  const float* t_start;
  const float* fars;
  const float* noise;  // null: no noise
  const uint8_t* bitfield;
  const uint8_t* grid;  // the dilated cell grid, [H^3] bool
  int N, S, S_lad, G, NCr, W, H, cascades, cap, rpw, nb, use_gamma;
  int64_t CB, M;
  float dt_min, dt_max, gamma, a, b, lg, inv_dtmin, inv_lg, bound, inv2b, thr;
  // scratch
  uint32_t* mask;  // [N, W] live chunks after the cap
  int32_t* Ls;     // [N] live chunks after the cap
  int32_t* Vs;     // [N] valid rungs in the kept chunks
  int32_t* flags;  // [N] bit 0: cap cut; bit 1: chunk-budget cut
  float* tcut;     // [N] t_lo of the cut chunk
  int32_t* blockL;
  int32_t* blockV;
  int32_t* blockFirst;
  // outputs
  int64_t* sel;
  uint8_t* sel_valid;
  int64_t* scal;  // m_eff, num_points
  uint8_t* ray_mask;
  float* t0;
  float* resume_t;
};

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }

// torch.clamp / clamp_min / maximum / minimum on the card: NaN passes on
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float clamp_lo(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }
__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// `_to_index`: nan_to_num (NaN -> 0), clamp to [0, H-1], truncate
__device__ __forceinline__ int to_index(float x, int H) {
  if (isnan(x)) x = 0.0f;
  return (int)fminf(fmaxf(x, 0.0f), (float)(H - 1));
}

// `_float_exponent`
__device__ __forceinline__ int fexp(float x) { return ((__float_as_int(x) >> 23) & 0xFF) - 126; }

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The ladder of one ray (`_t_ladder`'s per-ray terms): t at rung j is
// t0 + j dt_min, or with dt_gamma > 0 the three pieces after n1 and n2.
struct Ray {
  float o[3], d[3], far, t0, n1, n2, tA, tB;
};

__device__ __forceinline__ void ladder_terms(const Params& p, Ray& r) {
  r.n1 = r.n2 = r.tA = r.tB = 0.0f;
  if (!p.use_gamma) return;
  r.n1 = ceilf(fmul(clamp_lo(fsub(p.a, r.t0), 0.0f), p.inv_dtmin));
  r.tA = fadd(r.t0, fmul(r.n1, p.dt_min));
  const float q = fmul(__frcp_rn(r.tA), p.b);
  r.n2 = ceilf(fmul(clamp_lo(logf(clamp_lo(q, 1.0f)), 0.0f), p.inv_lg));
  r.tB = fmul(r.tA, expf(fmul(r.n2, p.lg)));
}

__device__ __forceinline__ float ladder_t(const Params& p, const Ray& r, int j) {
  const float k = (float)j;
  const float t1 = fadd(r.t0, fmul(k, p.dt_min));
  if (!p.use_gamma || k < r.n1) return t1;
  if (k < fadd(r.n1, r.n2)) return fmul(r.tA, expf(fmul(fsub(k, r.n1), p.lg)));
  return fadd(r.tB, fmul(fsub(fsub(k, r.n1), r.n2), p.dt_max));
}

// `_dts`
__device__ __forceinline__ float dt_at(const Params& p, float t) {
  return p.use_gamma ? clampf(fmul(t, p.gamma), p.dt_min, p.dt_max) : p.dt_min;
}

// A ray's inputs; t0 from `t0` (kernels 2 and 3) or, with t0 null, the
// noisy start from t_start (`_noisy_start`, kernel 1).
__device__ __forceinline__ Ray load_ray(const Params& p, int n, const float* t0) {
  Ray r;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r.o[k] = p.o[n * p.os0 + k * p.os1];
    r.d[k] = p.d[n * p.ds0 + k * p.ds1];
  }
  r.far = p.fars[n];
  if (t0) {
    r.t0 = t0[n];
  } else {
    r.t0 = p.t_start[n];
    if (p.noise)
      r.t0 = fadd(r.t0, fmul(clampf(fmul(r.t0, p.gamma), p.dt_min, p.dt_max), p.noise[n]));
  }
  ladder_terms(p, r);
  return r;
}

// The coarse probe of chunk c: its t-midpoint's cell of the dilated grid,
// live if occupied or wider than the dilation, and before far.
__device__ __forceinline__ bool chunk_live(const Params& p, const Ray& r, int c, float& t_lo) {
  t_lo = ladder_t(p, r, c * p.G);
  const float t_hi = ladder_t(p, r, c * p.G + p.G - 1);
  const float tc = fmul(fadd(t_lo, t_hi), 0.5f);
  const float half = fmul(fsub(t_hi, t_lo), 0.5f);
  int ix[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float q = clampf(fadd(r.o[k], fmul(tc, r.d[k])), -p.bound, p.bound);
    ix[k] = to_index(floorf(fmul(fmul(fadd(q, p.bound), p.inv2b), (float)p.H)), p.H);
  }
  const int cell = (ix[0] * p.H + ix[1]) * p.H + ix[2];
  return (p.grid[cell] != 0 || half > p.thr) && t_lo < r.far;
}

// The fine probe of rung j (`_probe`): its cell at its mip level, occupied
// in the bitfield, and before far.
__device__ __forceinline__ bool rung_valid(const Params& p, const Ray& r, int j) {
  const float t = ladder_t(p, r, j);
  float x[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) x[k] = clampf(fadd(r.o[k], fmul(t, r.d[k])), -p.bound, p.bound);
  int lvl = 0;
  if (p.cascades > 1) {
    const float mx = nan_max(fabsf(x[0]), nan_max(fabsf(x[1]), fabsf(x[2])));
    const int e_pos = mx > 0.0f ? fexp(clamp_lo(mx, 1e-30f)) : -100;
    const float mdt = fmul(fmul(dt_at(p, t), (float)p.H), 0.5f);
    const int e_dt = mdt > 0.0f ? fexp(clamp_lo(mdt, 1e-30f)) : -100;
    lvl = min(max(max(e_pos, e_dt), 0), p.cascades - 1);
  }
  const float inv = __frcp_rn(fminf(exp2f((float)lvl), p.bound));
  int ix[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    ix[k] = to_index(fmul(fmul(fadd(fmul(x[k], inv), 1.0f), 0.5f), (float)p.H), p.H);
  const int64_t cell =
      (int64_t)lvl * p.H * p.H * p.H + (int64_t)((ix[0] * p.H + ix[1]) * p.H + ix[2]);
  return ((p.bitfield[cell >> 3] >> (cell & 7)) & 1) && t < r.far;
}

// The first K live chunks of a ray's mask words into `lst` (the warp's own).
__device__ __forceinline__ void live_list(const Params& p, int n, int K, short* lst, int lane) {
  const uint32_t* mw = p.mask + (int64_t)n * p.W;
  int cnt = 0;
  for (int w = 0; w < p.W && cnt < K; ++w) {
    const uint32_t word = mw[w];
    if ((word >> lane) & 1u) {
      const int pos = cnt + __popc(word & lanes_below(lane));
      if (pos < K) lst[pos] = (short)(w * 32 + lane);
    }
    cnt += __popc(word);
  }
  __syncwarp();
}

// Every thread: the sum of blk[0, blockIdx.x) and of blk[0, nb), and the
// least of first[0, nb) (first null: not taken).
__device__ __forceinline__ void block_sums(const int32_t* blk, const int32_t* first, int nb,
                                           int& before, int& total, int& least) {
  __shared__ int s[3][WARPS];
  int b = 0, t = 0, f = INT_MAX;
  for (int i = threadIdx.x; i < nb; i += THREADS) {
    const int v = blk[i];
    t += v;
    if (i < (int)blockIdx.x) b += v;
    if (first) f = min(f, first[i]);
  }
  b = warp_sum(b);
  t = warp_sum(t);
#pragma unroll
  for (int o = 16; o; o >>= 1) f = min(f, __shfl_xor_sync(FULL, f, o));
  if ((threadIdx.x & 31) == 0) {
    s[0][threadIdx.x >> 5] = b;
    s[1][threadIdx.x >> 5] = t;
    s[2][threadIdx.x >> 5] = f;
  }
  __syncthreads();
  before = total = 0;
  least = INT_MAX;
  for (int w = 0; w < WARPS; ++w) {
    before += s[0][w];
    total += s[1][w];
    least = min(least, s[2][w]);
  }
}

// Every thread: the warp's offset among the block's warps of `v` (the
// warp's own sum, the same on all its lanes), and the block's sum.
__device__ __forceinline__ int warp_offset(int v, int& block_total) {
  __shared__ int s[WARPS];
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) s[warp] = v;
  __syncthreads();
  int off = 0;
  block_total = 0;
  for (int w = 0; w < WARPS; ++w) {
    if (w < warp) off += s[w];
    block_total += s[w];
  }
  return off;
}

__global__ void __launch_bounds__(THREADS) march_coarse_kernel(Params p) {
  __shared__ int s_sum[WARPS], s_first[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = (blockIdx.x * WARPS + warp) * p.rpw;
  const int n1 = min(n0 + p.rpw, p.N);
  int sumL = 0, first = INT_MAX;
  for (int n = n0; n < n1; ++n) {
    const Ray r = load_ray(p, n, nullptr);
    if (lane == 0) p.t0[n] = r.t0;
    uint32_t* mw = p.mask + (int64_t)n * p.W;
    int cnt = 0;
    bool cut = false;
    float tcut = 0.0f;
    for (int w = 0; w < p.W; ++w) {
      uint32_t word = 0;
      if (!cut) {
        const int c = w * 32 + lane;
        float t_lo = 0.0f;
        const bool live = c < p.NCr && chunk_live(p, r, c, t_lo);
        word = __ballot_sync(FULL, live);
        if (p.cap >= 0) {  // keep the first `cap`; the next one is the cut
          const int rank = cnt + __popc(word & lanes_below(lane));
          const uint32_t cb = __ballot_sync(FULL, live && rank == p.cap);
          word = __ballot_sync(FULL, live && rank < p.cap);
          if (cb) {
            cut = true;
            tcut = __shfl_sync(FULL, t_lo, __ffs(cb) - 1);
          }
        }
      }
      if (lane == 0) mw[w] = word;
      if (first == INT_MAX && word) first = n * p.NCr + w * 32 + __ffs(word) - 1;
      cnt += __popc(word);
    }
    if (lane == 0) {
      p.Ls[n] = cnt;
      p.flags[n] = cut ? 1 : 0;
      p.tcut[n] = tcut;
    }
    sumL += cnt;
  }
  if (lane == 0) {
    s_sum[warp] = sumL;
    s_first[warp] = first;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0, f = INT_MAX;
    for (int w = 0; w < WARPS; ++w) {
      s += s_sum[w];
      f = min(f, s_first[w]);
    }
    p.blockL[blockIdx.x] = s;
    p.blockFirst[blockIdx.x] = f;
  }
}

__global__ void __launch_bounds__(THREADS) march_count_kernel(Params p) {
  extern __shared__ short s_list[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int before, n_live, unused;
  block_sums(p.blockL, nullptr, p.nb, before, n_live, unused);
  const int n0 = (blockIdx.x * WARPS + warp) * p.rpw;
  const int n1 = min(n0 + p.rpw, p.N);
  int ws = 0;
  for (int n = n0 + lane; n < n1; n += 32) ws += p.Ls[n];
  int block_total;
  int64_t R = before + warp_offset(warp_sum(ws), block_total);
  short* lst = s_list + warp * p.NCr;
  int sumV = 0;
  for (int n = n0; n < n1; ++n) {
    const int L = p.Ls[n];
    const int K = (int)max64(0, min64(L, p.CB - R));
    int V = 0;
    if (K > 0) {
      const Ray r = load_ray(p, n, p.t0);
      live_list(p, n, K, lst, lane);
      const int pairs = K * p.G;
      for (int q0 = 0; q0 < pairs; q0 += 32) {
        const int q = q0 + lane;
        bool v = false;
        if (q < pairs) {
          const int i = q / p.G;
          v = rung_valid(p, r, lst[i] * p.G + (q - i * p.G));
        }
        V += __popc(__ballot_sync(FULL, v));
      }
      __syncwarp();
    }
    if (lane == 0) {
      p.Vs[n] = V;
      if (R + L >= p.CB && (int64_t)n_live > p.CB) p.flags[n] |= 2;
    }
    R += L;
    sumV += V;
  }
  __syncthreads();
  int blockV;
  warp_offset(sumV, blockV);
  if (threadIdx.x == 0) p.blockV[blockIdx.x] = blockV;
}

__global__ void __launch_bounds__(THREADS) march_write_kernel(Params p) {
  extern __shared__ short s_list[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int before, total, first;
  block_sums(p.blockV, p.blockFirst, p.nb, before, total, first);
  const int64_t m_eff = min64(total, p.M);
  const int n0 = (blockIdx.x * WARPS + warp) * p.rpw;
  const int n1 = min(n0 + p.rpw, p.N);
  int ws = 0;
  for (int n = n0 + lane; n < n1; n += 32) ws += p.Vs[n];
  int block_total;
  int64_t base = before + warp_offset(warp_sum(ws), block_total);
  short* lst = s_list + warp * p.NCr;
  for (int n = n0; n < n1; ++n) {
    const int V = p.Vs[n];
    const int fl = p.flags[n];
    const int taken = (int)min64(V, max64(0, m_eff - base));
    const Ray r = load_ray(p, n, p.t0);
    int last = 0;
    if (taken > 0) {
      // the first `taken` valid rungs lie in the kept chunks, the first of
      // the ray's live ones
      const int L = p.Ls[n];
      live_list(p, n, L, lst, lane);
      const int pairs = L * p.G;
      int cnt = 0;
      for (int q0 = 0; q0 < pairs && cnt < taken; q0 += 32) {
        const int q = q0 + lane;
        bool v = false;
        int j = 0;
        if (q < pairs) {
          const int i = q / p.G;
          j = lst[i] * p.G + (q - i * p.G);
          v = rung_valid(p, r, j);
        }
        const unsigned bal = __ballot_sync(FULL, v);
        const int rank = cnt + __popc(bal & lanes_below(lane));
        if (v && rank < taken) p.sel[base + rank] = (int64_t)n * p.S + j;
        const unsigned hit = __ballot_sync(FULL, v && rank == taken - 1);
        if (hit) last = __shfl_sync(FULL, j, __ffs(hit) - 1);
        cnt += __popc(bal);
      }
      __syncwarp();
    }
    if (lane == 0) {
      const bool cut = fl != 0;
      float t_after = r.t0;
      if (taken > 0) {
        const float ts = ladder_t(p, r, last);
        t_after = fadd(ts, dt_at(p, ts));
      }
      const float tl = ladder_t(p, r, p.S_lad - 1);
      const float t_end = fadd(tl, dt_at(p, tl));
      float res = nan_min((taken < V || cut) ? t_after : t_end, r.far);
      if ((fl & 1) && V == 0 && !(fl & 2)) res = nan_min(p.tcut[n], r.far);
      p.resume_t[n] = res;
      p.ray_mask[n] = (base + V <= m_eff) && !cut;
    }
    base += V;
  }
  // the padded tail repeats the first kept chunk's first rung (the last
  // ray's last chunk's when none is live), and sel_valid marks the prefix
  int64_t fill;
  if (first != INT_MAX) {
    const int fr = first / p.NCr;
    fill = (int64_t)fr * p.S + (int64_t)(first - fr * p.NCr) * p.G;
  } else {
    fill = (int64_t)(p.N - 1) * p.S + (int64_t)(p.NCr - 1) * p.G;
  }
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < p.M;
       i += (int64_t)gridDim.x * THREADS) {
    const bool ok = i < m_eff;
    p.sel_valid[i] = ok;
    if (!ok) p.sel[i] = fill;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    p.scal[0] = m_eff;
    p.scal[1] = total;
  }
}

// iconst (host): N, S, S_lad, G, NCr, H, cascades, cap (-1: none), CB, M,
// rays a warp, blocks, use_gamma, and the element strides of o and d;
// fconst (host): dt_min, dt_max, dt_gamma, dt_min / dt_gamma,
// dt_max / dt_gamma, log(1 + dt_gamma), 1 / dt_min, 1 / log(1 + dt_gamma),
// bound, 1 / (2 bound), dilate * cell + 1e-6.  scratch: N (W + 4) + 3 blocks
// int32, W = ceil(NCr / 32).  noise may be null.
extern "C" int tngp_march_chunked(const float* o, const float* d, const float* t_start,
                                  const float* fars, const float* noise, const uint8_t* bitfield,
                                  const uint8_t* grid, const int64_t* iconst,
                                  const float* fconst, int32_t* scratch, int64_t* sel,
                                  uint8_t* sel_valid, int64_t* scal, uint8_t* ray_mask,
                                  float* t0, float* resume_t, cudaStream_t stream) {
  Params p;
  p.o = o;
  p.d = d;
  p.t_start = t_start;
  p.fars = fars;
  p.noise = noise;
  p.bitfield = bitfield;
  p.grid = grid;
  p.N = (int)iconst[0];
  p.S = (int)iconst[1];
  p.S_lad = (int)iconst[2];
  p.G = (int)iconst[3];
  p.NCr = (int)iconst[4];
  p.H = (int)iconst[5];
  p.cascades = (int)iconst[6];
  p.cap = (int)iconst[7];
  p.CB = iconst[8];
  p.M = iconst[9];
  p.rpw = (int)iconst[10];
  p.nb = (int)iconst[11];
  p.use_gamma = (int)iconst[12];
  p.os0 = iconst[13];
  p.os1 = iconst[14];
  p.ds0 = iconst[15];
  p.ds1 = iconst[16];
  p.dt_min = fconst[0];
  p.dt_max = fconst[1];
  p.gamma = fconst[2];
  p.a = fconst[3];
  p.b = fconst[4];
  p.lg = fconst[5];
  p.inv_dtmin = fconst[6];
  p.inv_lg = fconst[7];
  p.bound = fconst[8];
  p.inv2b = fconst[9];
  p.thr = fconst[10];
  if (p.N < 1 || p.G < 1 || p.NCr < 1 || p.NCr > MAX_CHUNKS || p.M < 1 || p.rpw < 1 ||
      p.nb < 1 || (int64_t)p.nb * WARPS * p.rpw < p.N || (int64_t)p.N * p.S > INT_MAX)
    return (int)cudaErrorInvalidValue;
  p.W = (p.NCr + 31) / 32;
  int32_t* s = scratch;
  p.mask = (uint32_t*)s;
  s += (int64_t)p.N * p.W;
  p.Ls = s;
  s += p.N;
  p.Vs = s;
  s += p.N;
  p.flags = s;
  s += p.N;
  p.tcut = (float*)s;
  s += p.N;
  p.blockL = s;
  s += p.nb;
  p.blockV = s;
  s += p.nb;
  p.blockFirst = s;
  p.sel = sel;
  p.sel_valid = sel_valid;
  p.scal = scal;
  p.ray_mask = ray_mask;
  p.t0 = t0;
  p.resume_t = resume_t;
  const size_t smem = (size_t)WARPS * p.NCr * sizeof(short);
  march_coarse_kernel<<<p.nb, THREADS, 0, stream>>>(p);
  march_count_kernel<<<p.nb, THREADS, smem, stream>>>(p);
  march_write_kernel<<<p.nb, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}
