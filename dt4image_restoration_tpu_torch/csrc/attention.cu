// K4: causal softmax attention over short sequences, one thread block per
// (batch, head) pair and one warp per query row.
//
// Replaces the TPU kernel fused_causal_attention
// (dt4image_restoration_tpu/ops/pallas/attention.py). For every (b, h) of
// q, k, v (B, H, T, D) float32:
//
//     s   = q k^T * (1 / sqrt(D))
//     s   = where(col <= row, s, -1e30)          causal mask, as the TPU kernel
//     p   = exp(s - max(s)) / sum(exp(s - max(s)))
//     out = p v
//
// The block stages the pair's Q, K and V (T <= 32 rows of D <= 64 floats,
// 25 KB at most) in shared memory; K rows are padded to D + 1 floats so
// that the 32 lanes of a warp, each reading a different key row at the same
// column, hit 32 different banks. Warp w takes query rows w, w + 8, ...:
// lane j computes the score against key j (j <= row), the row max and sum
// are warp shuffles, and for the output lane d sums p_j v[j][d] over the
// keys with p_j broadcast by a shuffle. Scores never leave registers.
//
// Bound on the H100: memory traffic. A pair moves 16 T D bytes (q, k, v in,
// out) for about 2 T^2 D flops, a few flops per byte at T = 18; at the
// search's 16 trees x 4 heads the whole call moves 0.6 MB, so in practice
// the launch latency bounds it. The design keeps to one launch that reads
// each input once and writes the output once.
#include <cuda_runtime.h>
#include <math.h>

#define MAX_T 32
#define MAX_D 64
#define WARPS 8

__global__ void __launch_bounds__(WARPS * 32)
causal_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        float* __restrict__ out, int T, int D,
                        float scale) {
  __shared__ float qs[MAX_T * MAX_D];
  __shared__ float ks[MAX_T * (MAX_D + 1)];
  __shared__ float vs[MAX_T * MAX_D];
  const long long base = (long long)blockIdx.x * T * D;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  for (int i = tid; i < T * D; i += WARPS * 32) {
    const int r = i / D, c = i % D;
    qs[i] = q[base + i];
    ks[r * (D + 1) + c] = k[base + i];
    vs[i] = v[base + i];
  }
  __syncthreads();

  for (int row = warp; row < T; row += WARPS) {
    const float* qr = qs + row * D;
    float s = -1e30f;
    if (lane <= row) {
      const float* kr = ks + lane * (D + 1);
      float acc = 0.f;
      for (int c = 0; c < D; ++c) acc = fmaf(qr[c], kr[c], acc);
      s = acc * scale;
    }
    float m = s;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    // Lanes past T hold no key; lanes past the row hold masked keys,
    // whose exp(-1e30 - m) is 0 as in the TPU kernel.
    float p = lane < T ? expf(s - m) : 0.f;
    float sum = p;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    p = p / sum;
    for (int c0 = 0; c0 < D; c0 += 32) {
      const int c = c0 + lane;
      float acc = 0.f;
      for (int j = 0; j < T; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        if (c < D) acc = fmaf(pj, vs[j * D + c], acc);
      }
      if (c < D) out[base + row * D + c] = acc;
    }
  }
}

extern "C" int causal_attention_launch(const void* q, const void* k,
                                       const void* v, void* out, int pairs,
                                       int T, int D, void* stream) {
  if (pairs <= 0) return 0;
  if (T < 1 || T > MAX_T || D < 1 || D > MAX_D)
    return (int)cudaErrorInvalidValue;
  causal_attention_kernel<<<pairs, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, T, D,
      (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}
