// Scatter-add: out[idx[j], c] += vals[j, c] in f32.
//
// Replaces the TPU kernel tngp/kernels/scatter.py `_scatter_kernel` /
// `_scatter_kernel_acc` (launched by `_one_chunk` / `_one_chunk_acc` via
// `scatter_add`).  The TPU kernel walks the indices in one sequential loop
// with the whole accumulator resident in VMEM, which makes it deterministic.
// Blocks run in parallel and in no order on the H100, so this kernel gives
// each (j, c) element one thread and adds with atomicAdd into the zeroed
// output the caller allocates.
//
// Bound on the H100: bytes.  It reads idx (8 B) and vals (4 B per channel)
// once per element and writes each output row once; an add is one operation.
// With unique indices (the encoder's payload sort) every address receives one
// add, so the result is exact.  With nondecreasing indices (the compositor's
// per-ray reduction) the adds into one row land in an order that can change
// from run to run: the sum matches an ordered sum to f32 reordering error.
// A deterministic segmented reduce for sorted indices is later work.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void scatter_add_f32_kernel(const int64_t* __restrict__ idx,
                                       const float* __restrict__ vals,
                                       float* __restrict__ out, int64_t n,
                                       int C, int64_t num_rows) {
  int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n * C) return;
  int64_t j = e / C;
  int c = (int)(e - j * C);
  int64_t r = idx[j];
  // an out-of-range update is dropped, as an out-of-range JAX scatter is
  if (r < 0 || r >= num_rows) return;
  atomicAdd(out + r * C + c, vals[e]);
}

extern "C" int tngp_scatter_add_f32(const int64_t* idx, const float* vals,
                                    float* out, int64_t n, int C,
                                    int64_t num_rows, cudaStream_t stream) {
  const int threads = 256;
  int64_t total = n * (int64_t)C;
  if (total > 0) {
    int64_t blocks = (total + threads - 1) / threads;
    scatter_add_f32_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
        idx, vals, out, n, C, num_rows);
  }
  return (int)cudaGetLastError();
}

// Set-scatter: out[c] = init, then out[idx[j]] = vals[j] for every j with
// 0 <= idx[j] < num_cells, the LAST write (largest j) winning a cell.
//
// Replaces the TPU kernel tngp/kernels/scatter.py `_scatter_set_kernel`
// (launched by `scatter_set_flat`).  The TPU kernel keeps the whole
// lane-packed [rows, 128] target in VMEM and walks the indices in one
// sequential loop, so a later write overwrites an earlier one.  A sequential
// loop wastes the H100, and no block here can hold the 8 MB target, so the
// last-write rule becomes a reduction with the same result in any launch
// order:
//   A. winner[c] = -1 for every cell (a memset of 0xFF bytes);
//   B. one thread per j: atomicMax(&winner[idx[j]], j), indices out of
//      range (the -1 skips, and caller errors) dropped;
//   C. one thread per cell: out[c] = winner[c] >= 0 ? vals[winner[c]] : init.
// The result is exact and deterministic: C reads only after B's last atomic
// (stream order), and the maximum of the j's is the same in any order.
// `winner` is int32 scratch the caller allocates, so j < 2^31 (the wrapper
// checks M).
//
// Bound on the H100: bytes.  The function needs idx (8 B per write), the
// winning values (4 B per written cell) and the output (4 B per cell).  The
// three passes move more: winner is written by A, hit by B's atomics and
// read by C, 12 B per cell and 4 B per write on top.

__global__ void scatter_set_winner_kernel(const int64_t* __restrict__ idx,
                                          int* __restrict__ winner, int n,
                                          int64_t num_cells) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  int64_t c = idx[j];
  if (c < 0 || c >= num_cells) return;
  atomicMax(winner + c, j);
}

__global__ void scatter_set_gather_kernel(const int* __restrict__ winner,
                                          const float* __restrict__ vals,
                                          float* __restrict__ out,
                                          int64_t num_cells, float init) {
  int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= num_cells) return;
  int w = winner[c];
  out[c] = w >= 0 ? vals[w] : init;
}

extern "C" int tngp_scatter_set_f32(const int64_t* idx, const float* vals,
                                    int* winner, float* out, int n,
                                    int64_t num_cells, float init,
                                    cudaStream_t stream) {
  const int threads = 256;
  if (num_cells <= 0) return (int)cudaGetLastError();
  cudaError_t err = cudaMemsetAsync(winner, 0xFF, num_cells * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    unsigned blocks = (unsigned)((n + threads - 1) / threads);
    scatter_set_winner_kernel<<<blocks, threads, 0, stream>>>(idx, winner, n,
                                                              num_cells);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  int64_t cblocks = (num_cells + threads - 1) / threads;
  scatter_set_gather_kernel<<<(unsigned)cblocks, threads, 0, stream>>>(
      winner, vals, out, num_cells, init);
  return (int)cudaGetLastError();
}
