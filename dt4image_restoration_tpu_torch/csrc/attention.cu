// K4: causal softmax attention over short sequences: one thread block per
// (batch, head) pair and tile of query rows, one warp per query row.
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
// Layout. q, k and v are strided views, as the per-op forward cuts them
// from its fused QKV projection (B, T, 3E): the last stride is 1 and the
// B, H and T strides, the same for the three, are arguments. The output is
// written as (B, T, H, D), so the caller's merge of the heads back into
// (B, T, E) is a view and not a copy.
//
// Grid. The tiles of a pair split its T rows evenly, at most WARPS rows
// each (T = 18: three tiles of 6 rows), so that the search's 16 x 4 pairs
// give 192 blocks for the H100's 132 SMs. A block stages its query rows
// and the keys and values they see (rows 0 .. its last row, the mask being
// causal) in dynamic shared memory with cp.async: 16-byte copies when
// every address and stride allows them, else 4-byte copies. Rows are
// padded to DP floats, a multiple of 4 that is 4 mod 8, so that the
// float4 reads of 8 lanes, each on its own key row, hit distinct banks.
//
// Warp w of a block takes query row r0 + w. Lane j owns keys j, j + 32 and
// j + 64 (T <= 96): it computes their scores from float4 reads, three
// independent chains; the row max and sum reduce over its three registers
// and then a butterfly. The warp puts its probabilities in shared memory,
// and lane c sums p_j v[j][c] and p_j v[j][c + 32] over the visible keys
// into four partial sums, so that no chain runs the length of the row.
//
// Launch: a plain launch. With programmatic dependent launch the per-op
// forward's CUDA graph ran no faster on the H100 (PERF.md section 6).
//
// Bound on the H100: memory traffic. A pair moves 16 T D bytes (q, k, v in,
// out) for about 2 T^2 D flops, a few flops per byte at T = 18; the
// search's whole call moves 0.6 MB, so in practice launch latency bounds
// it. The design reads each input about once per tile and writes the output
// once, in one launch.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_T 96
#define MAX_D 64
#define WARPS 8                    // query rows of a tile, at most
#define KEYS_PER_LANE (MAX_T / 32)
#define MAX_DP (MAX_D + 4)
#define MAX_SMEM ((WARPS + 2 * MAX_T) * MAX_DP * 4)
#define MAX_DEVICES 64             // devices with launch state kept

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src) : "memory");
}

// Shared-memory row stride: D rounded up to 8, plus 4.
__host__ __device__ __forceinline__ int padded(int D) {
  return ((D + 7) & ~7) + 4;
}

__global__ void __launch_bounds__(WARPS * 32)
causal_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        float* __restrict__ out, int H, int T, int D,
                        int tiles, long long sb, long long sh, long long st,
                        float scale, int vec) {
  extern __shared__ float4 smem4[];
  __shared__ float ps[WARPS][MAX_T];   // a warp's softmax row
  const int rows = blockDim.x / 32;
  const int pair = blockIdx.x / tiles;
  const int r0 = (blockIdx.x % tiles) * rows;
  const int b = pair / H, h = pair % H;
  const int nq = min(rows, T - r0);   // query rows of this block
  const int nk = r0 + nq;             // keys they see
  const int dp = padded(D), d4 = (D + 3) / 4;
  float* qs = (float*)smem4;
  float* ks = qs + rows * dp;
  float* vs = ks + nk * dp;
  const long long base = (long long)b * sb + (long long)h * sh;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  // Staging: rows [0, nq) of q from r0, then rows [0, nk) of k and of v.
  const int n_rows = nq + 2 * nk;
  if (vec) {
    for (int i = tid; i < n_rows * d4; i += blockDim.x) {
      const int r = i / d4, c = (i % d4) * 4;
      if (r < nq)
        cp_async16(qs + r * dp + c, q + base + (r0 + r) * st + c);
      else if (r < nq + nk)
        cp_async16(ks + (r - nq) * dp + c, k + base + (r - nq) * st + c);
      else
        cp_async16(vs + (r - nq - nk) * dp + c,
                   v + base + (r - nq - nk) * st + c);
    }
  } else {
    // Columns D .. 4 d4 of q and k rows are read by the float4 dot
    // products below: zero them.
    for (int i = tid; i < n_rows * 4 * d4; i += blockDim.x) {
      const int r = i / (4 * d4), c = i % (4 * d4);
      float* dst;
      const float* src;
      if (r < nq) {
        dst = qs + r * dp + c;
        src = q + base + (r0 + r) * st + c;
      } else if (r < nq + nk) {
        dst = ks + (r - nq) * dp + c;
        src = k + base + (r - nq) * st + c;
      } else {
        dst = vs + (r - nq - nk) * dp + c;
        src = v + base + (r - nq - nk) * st + c;
      }
      if (c < D)
        cp_async4(dst, src);
      else
        *dst = 0.f;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  if (warp >= nq) return;

  const int row = r0 + warp;
  const float4* qr = (const float4*)(qs + warp * dp);
  // Scores: the three keys of a lane as three independent chains over
  // the float4 columns. A key past the row reads the row's key (a staged
  // row; a broadcast) and is masked below.
  float s[KEYS_PER_LANE] = {0.f, 0.f, 0.f};
  for (int c = 0; c < d4; ++c) {
    const float4 a = qr[c];
#pragma unroll
    for (int i = 0; i < KEYS_PER_LANE; ++i) {
      if (32 * i <= row) {
        const float4 bk =
            ((const float4*)(ks + min(lane + 32 * i, row) * dp))[c];
        s[i] = fmaf(a.x, bk.x, s[i]);
        s[i] = fmaf(a.y, bk.y, s[i]);
        s[i] = fmaf(a.z, bk.z, s[i]);
        s[i] = fmaf(a.w, bk.w, s[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < KEYS_PER_LANE; ++i)
    s[i] = lane + 32 * i <= row ? s[i] * scale : -1e30f;
  float m = fmaxf(fmaxf(s[0], s[1]), s[2]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  // Masked keys, and keys past T, weigh 0: exp(-1e30 - m) is 0 in the TPU
  // kernel too.
  float p[KEYS_PER_LANE];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < KEYS_PER_LANE; ++i) {
    p[i] = lane + 32 * i <= row ? expf(s[i] - m) : 0.f;
    sum += p[i];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
  float* pw = ps[warp];
#pragma unroll
  for (int i = 0; i < KEYS_PER_LANE; ++i) pw[lane + 32 * i] = p[i] / sum;
  __syncwarp();

  // out[c] = sum_j p_j v[j][c] for the columns c = lane and lane + 32, the
  // keys taken four at a time into four partial sums.
  float a0[4] = {0.f, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f};
  int j = 0;
  for (; j + 4 <= row + 1; j += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float pj = pw[j + u];
      const float* vr = vs + (j + u) * dp;
      if (lane < D) a0[u] = fmaf(pj, vr[lane], a0[u]);
      if (lane + 32 < D) a1[u] = fmaf(pj, vr[lane + 32], a1[u]);
    }
  }
  for (; j <= row; ++j) {
    const float pj = pw[j];
    const float* vr = vs + j * dp;
    if (lane < D) a0[0] = fmaf(pj, vr[lane], a0[0]);
    if (lane + 32 < D) a1[0] = fmaf(pj, vr[lane + 32], a1[0]);
  }
  float* orow = out + (((long long)b * T + row) * H + h) * D;
  if (lane < D) orow[lane] = (a0[0] + a0[1]) + (a0[2] + a0[3]);
  if (lane + 32 < D) orow[lane + 32] = (a1[0] + a1[1]) + (a1[2] + a1[3]);
}

// q, k, v: (B, H, T, D) views sharing the strides (sb, sh, st, 1); out: a
// contiguous (B, T, H, D) buffer.
extern "C" int causal_attention_launch(const void* q, const void* k,
                                       const void* v, void* out, int B,
                                       int H, int T, int D, long long sb,
                                       long long sh, long long st,
                                       void* stream) {
  // Whether the kernel may take MAX_SMEM bytes of dynamic shared memory on
  // each device (the opt-in past 48 KB is made once per device).
  static bool smem_raised[MAX_DEVICES] = {};
  if (B < 0 || H < 0 || T < 1 || T > MAX_T || D < 1 || D > MAX_D)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!smem_raised[dev]) {
    e = cudaFuncSetAttribute(causal_attention_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_raised[dev] = true;
  }
  // The stride of a dimension of size 1 is never used to address; zero it
  // so it does not decide the copy width.
  if (B == 1) sb = 0;
  if (H == 1) sh = 0;
  if (T == 1) st = 0;
  const int vec = ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0
      && D % 4 == 0 && sb % 4 == 0 && sh % 4 == 0 && st % 4 == 0;
  const int tiles = (T + WARPS - 1) / WARPS;
  const int rows = (T + tiles - 1) / tiles;
  const size_t smem = (size_t)(rows + 2 * T) * padded(D) * sizeof(float);
  causal_attention_kernel<<<(unsigned)((long long)B * H * tiles), rows * 32,
                            smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, H, T,
      D, tiles, sb, sh, st, (float)(1.0 / sqrt((double)D)), vec);
  return (int)cudaGetLastError();
}
