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
