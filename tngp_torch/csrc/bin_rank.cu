// Bin ranks: for each block of 512 tile keys, every key's stable rank among
// the keys of its tile in that block, and the block's 64-bin tile histogram.
//
// Replaces the TPU kernel tngp/kernels/window_encoder.py
// `_make_bin_rank_kernel` (launched by `_bin_ranks_pallas`, reached through
// `bin_dest_pallas`).  The TPU kernel forms the ranks as a one-hot [64, 512]
// matrix times a lower-triangular constant on the MXU.  Here one thread block
// of 512 threads takes one key block: `__match_any_sync` finds the lanes of a
// warp that share a key, the popcount of the lower lanes among them is the
// rank inside the warp, and a per-warp 64-bin histogram in shared memory
// gives the count of earlier warps.  All integer, so the ranks and the
// histogram equal the TPU's exactly.  Keys outside [0, 64) are padding: rank
// -1, not counted.
//
// Bound on the H100: bytes (4 B in and 4 B out per key, 256 B of histogram
// per block); the work per key is a handful of integer operations.

#include <cuda_runtime.h>
#include <stdint.h>

#define RANK_BS 512
#define N_TILES 64
#define N_WARPS (RANK_BS / 32)

__global__ void __launch_bounds__(RANK_BS)
    bin_rank_kernel(const int32_t* __restrict__ keys, int32_t* __restrict__ rank,
                    int32_t* __restrict__ tot) {
  __shared__ int hist[N_WARPS][N_TILES];
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const size_t base = (size_t)blockIdx.x * RANK_BS;
  for (int i = t; i < N_WARPS * N_TILES; i += RANK_BS) (&hist[0][0])[i] = 0;
  __syncthreads();

  const int key = keys[base + t];
  const bool valid = key >= 0 && key < N_TILES;
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  const int within = __popc(peers & ((1u << lane) - 1u));
  if (valid && lane == __ffs(peers) - 1) hist[warp][key] = __popc(peers);
  __syncthreads();

  int r = -1;
  if (valid) {
    r = within;
    for (int w = 0; w < warp; ++w) r += hist[w][key];
  }
  rank[base + t] = r;
  if (t < N_TILES) {
    int s = 0;
    for (int w = 0; w < N_WARPS; ++w) s += hist[w][t];
    tot[(size_t)blockIdx.x * N_TILES + t] = s;
  }
}

// keys: [n_blocks * 512] int32 -> rank [n_blocks * 512], tot [n_blocks, 64]
extern "C" int tngp_bin_ranks(const int32_t* keys, int32_t* rank, int32_t* tot,
                              int n_blocks, cudaStream_t stream) {
  if (n_blocks > 0) {
    bin_rank_kernel<<<n_blocks, RANK_BS, 0, stream>>>(keys, rank, tot);
  }
  return (int)cudaGetLastError();
}
