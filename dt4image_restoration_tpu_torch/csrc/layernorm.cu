// K5: row LayerNorm over the last axis, one warp per row.
//
// Replaces the TPU kernel layernorm_pallas
// (dt4image_restoration_tpu/ops/pallas/layernorm.py). For every row x of
// E float32 values:
//
//     mean = sum(x) / E
//     var  = sum((x - mean)^2) / E                 two passes, centred
//     out  = (x - mean) * rsqrt(var + eps) * scale + bias
//
// A warp loads its row once into registers as float4 (E / 4 vectors spread
// over the 32 lanes, at most MAX_VEC per lane), takes the sum and the
// centred sum of squares with butterfly shuffles, and writes the affine
// result as float4. The variance is never taken as E[x^2] - E[x]^2, which
// cancels badly when |mean| >> std.
//
// Grid. A block takes `rows / SMs` rows (1 to MAX_ROWS), so that a call
// of at least as many rows as the card has SMs spreads over all of them:
// the search's 288 rows run as 144 blocks of 2 warps, the evaluation's
// 1,134 as 142 blocks of 8. The last block may be partial; every row index
// is checked, so any row count works.
//
// Launch: a plain launch. With programmatic dependent launch the per-op
// forward's CUDA graph ran no faster on the H100 (PERF.md section 6).
//
// Bound on the H100: memory traffic. A row moves 8 E bytes for about 8 E
// flops; the design reads and writes each value once, with 16-byte
// accesses coalesced across the warp. At the search's 288 rows of 128 the
// call moves 0.3 MB, so in practice the launch latency bounds it.
#include <cuda_runtime.h>

#define MAX_ROWS 8   // rows (warps) of a block, at most
#define MAX_VEC 8  // float4 vectors per lane: E <= 32 * 4 * MAX_VEC = 1024
#define MAX_DEVICES 64             // devices with launch state kept

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(MAX_ROWS * 32)
layernorm_kernel(const float4* __restrict__ x,
                 const float4* __restrict__ scale,
                 const float4* __restrict__ bias, float4* __restrict__ out,
                 long long rows, int E, float eps) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * (blockDim.x / 32)
      + threadIdx.x / 32;
  if (row >= rows) return;
  const int nvec = E / 4;
  const float4* xr = x + row * nvec;
  float4 vals[MAX_VEC];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < MAX_VEC; ++j) {
    const int i = lane + 32 * j;
    if (i < nvec) {
      vals[j] = xr[i];
      sum += (vals[j].x + vals[j].y) + (vals[j].z + vals[j].w);
    }
  }
  const float mean = warp_sum(sum) / (float)E;
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < MAX_VEC; ++j) {
    const int i = lane + 32 * j;
    if (i < nvec) {
      vals[j].x -= mean; vals[j].y -= mean;
      vals[j].z -= mean; vals[j].w -= mean;
      sq += (vals[j].x * vals[j].x + vals[j].y * vals[j].y)
          + (vals[j].z * vals[j].z + vals[j].w * vals[j].w);
    }
  }
  const float inv = rsqrtf(warp_sum(sq) / (float)E + eps);
  float4* orow = out + row * nvec;
#pragma unroll
  for (int j = 0; j < MAX_VEC; ++j) {
    const int i = lane + 32 * j;
    if (i < nvec) {
      const float4 s = scale[i], b = bias[i];
      float4 o;
      o.x = vals[j].x * inv * s.x + b.x;
      o.y = vals[j].y * inv * s.y + b.y;
      o.z = vals[j].z * inv * s.z + b.z;
      o.w = vals[j].w * inv * s.w + b.w;
      orow[i] = o;
    }
  }
}

extern "C" int layernorm_launch(const void* x, const void* scale,
                                const void* bias, void* out, long long rows,
                                int E, float eps, void* stream) {
  static int sms[MAX_DEVICES] = {};   // SM count of each device, once read
  if (rows <= 0) return 0;
  if (E < 4 || E % 4 || E > 32 * 4 * MAX_VEC)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    int n = 0;
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    sms[dev] = n;
  }
  const long long per_sm = rows / sms[dev];
  const int per_block = per_sm < 1 ? 1 : per_sm > MAX_ROWS ? MAX_ROWS
                                                          : (int)per_sm;
  layernorm_kernel<<<(unsigned)((rows + per_block - 1) / per_block),
                     per_block * 32, 0, (cudaStream_t)stream>>>(
      (const float4*)x, (const float4*)scale, (const float4*)bias,
      (float4*)out, rows, E, eps);
  return (int)cudaGetLastError();
}
