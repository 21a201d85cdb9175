// Int-mul probe: out[i] = (x[i] * P1) ^ (x[i] * P2) with 32-bit wrapping
// products, P1 = 2654435761 and P2 = 805459861, the primes of the window
// encoder's spatial hash.
//
// Replaces the TPU kernel scripts/check_device_parity.py `int_mul_probe`
// (the inline Pallas kernel launched by its `pallas_call`), a device check
// that the chip's int32 multiply wraps mod 2^32 as the hash needs.  Here the
// products are formed in uint32_t, whose overflow C++ defines as mod 2^32
// (signed overflow is undefined), and the bits are handed back as int32.
//
// Bound on the H100: bytes (4 B in and 4 B out per element, three integer
// operations); at the probe's 8,192 elements it is launch latency.  One
// thread per element.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void int_mul_probe_kernel(const int32_t* __restrict__ x,
                                     int32_t* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t u = (uint32_t)x[i];
  out[i] = (int32_t)((u * 2654435761u) ^ (u * 805459861u));
}

extern "C" int tngp_int_mul_probe(const int32_t* x, int32_t* out, int64_t n,
                                  cudaStream_t stream) {
  const int threads = 256;
  if (n > 0) {
    const int64_t blocks = (n + threads - 1) / threads;
    int_mul_probe_kernel<<<(unsigned)blocks, threads, 0, stream>>>(x, out, n);
  }
  return (int)cudaGetLastError();
}
