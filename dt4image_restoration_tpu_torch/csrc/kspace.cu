// K2: masked k-space data consistency, one thread per complex element.
//
// Replaces the TPU kernel kspace_consistency_pallas
// (dt4image_restoration_tpu/ops/pallas/kspace.py). For every complex
// k-space value of slice b:
//
//     out = mask ? (mu[b] * z + y0) * (1 / (1 + mu[b])) : z
//
// on the real and imaginary parts. z, y0 and out are complex64 stored as
// interleaved (real, imag) float pairs, read and written as one float2.
//
// Bound on the H100: memory traffic. Each element moves 25 bytes (z, y0 and
// out at 8 bytes, the mask at 1) for 6 flops, far below the card's
// flops-per-byte balance. The design keeps to one pass with coalesced
// 8-byte accesses and no de-interleaving copies; the multiplies and adds use
// the _rn intrinsics so nvcc does not contract them into FMAs, and the
// result equals the plain PyTorch version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void kspace_consistency_kernel(const float2* __restrict__ z,
                                          const float2* __restrict__ y0,
                                          const uint8_t* __restrict__ mask,
                                          const float* __restrict__ mu,
                                          float2* __restrict__ out,
                                          long long n, long long per_slice) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float2 zv = z[i];
  if (mask[i]) {
    float m = mu[i / per_slice];
    float inv = 1.0f / __fadd_rn(1.0f, m);
    float2 yv = y0[i];
    zv.x = __fmul_rn(__fadd_rn(__fmul_rn(m, zv.x), yv.x), inv);
    zv.y = __fmul_rn(__fadd_rn(__fmul_rn(m, zv.y), yv.y), inv);
  }
  out[i] = zv;
}

extern "C" int kspace_consistency_launch(const void* z, const void* y0,
                                         const void* mask, const void* mu,
                                         void* out, long long n,
                                         long long per_slice,
                                         void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  kspace_consistency_kernel<<<(unsigned)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
      (const float2*)z, (const float2*)y0, (const uint8_t*)mask,
      (const float*)mu, (float2*)out, n, per_slice);
  return (int)cudaGetLastError();
}
