// K3: the Decision Transformer's whole block stack plus the final LayerNorm
// in one launch, one thread block per sequence.
//
// Replaces the TPU kernel fused_dt_decode
// (dt4image_restoration_tpu/ops/pallas/transformer.py). Per block, on the
// (T, E) token activations of one sequence:
//
//     h = LN1(x); qkv = h Wqkv + bqkv
//     att = causal softmax(q k^T / sqrt(D)) v      per head, D = E / heads
//     x = x + att Wo + bo
//     h = LN2(x); h = GELU(h Wfc + bfc)            exact erf GELU
//     x = h Wproj + bproj                          no residual (reference)
//
// then out = LNf(x). LayerNorm eps is 1e-5.
//
// Every activation of a sequence (T <= 32 tokens of E floats, the 3E-wide
// qkv and the 4E-wide MLP hidden share one buffer, and the H x T x T
// scores) stays in shared memory for the whole stack; the weights (about
// 3.9 MB in float32 at E 128, 5 blocks) are read from device memory, where
// the 50 MB L2 keeps them for all the blocks of a launch. Attention is
// causal within each sequence; the TPU kernel's block-diagonal score matrix
// over the flattened batch was an MXU device and is not copied.
//
// Bound on the H100: at the policy's batch of 63 sequences of 12 or 18
// tokens the stack is about 2 GFLOP against 5 MB of compulsory traffic, so
// arithmetic bounds it in principle; in practice one block per sequence
// fills fewer than half of the 132 SMs and the run is latency bound. Each
// linear layer gives one thread per output column, which reads each weight
// once (coalesced across the warp) and keeps the T row sums in registers.
#include <cuda_runtime.h>
#include <math.h>

#define THREADS 256
#define LN_EPS 1e-5f
#define MAX_T 32
#define MAX_SMEM 232448

struct DTWeights {
  const float *ln1_s, *ln1_b, *qkv_w, *qkv_b, *o_w, *o_b, *ln2_s, *ln2_b,
      *fc_w, *fc_b, *proj_w, *proj_b, *lnf_s, *lnf_b;
};

enum { STORE = 0, ADD = 1, GELU = 2 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Row LayerNorm of T rows of E values, one warp per row.
__device__ void layernorm(const float* in, float* out, int T, int E,
                          const float* __restrict__ s,
                          const float* __restrict__ b) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  for (int t = warp; t < T; t += nwarps) {
    const float* row = in + t * E;
    float sum = 0.f;
    for (int i = lane; i < E; i += 32) sum += row[i];
    const float mean = warp_sum(sum) / E;
    float var = 0.f;
    for (int i = lane; i < E; i += 32) {
      const float c = row[i] - mean;
      var += c * c;
    }
    const float r = 1.0f / sqrtf(warp_sum(var) / E + LN_EPS);
    for (int i = lane; i < E; i += 32)
      out[t * E + i] = (row[i] - mean) * r * s[i] + b[i];
  }
}

// out (T, N) [=|+=] act(in (T, K) @ W (K, N) + bias), W row-major in
// device memory. One thread per output column j.
template <int MT>
__device__ void linear(const float* in, int T, int K,
                       const float* __restrict__ W,
                       const float* __restrict__ bias, int N, float* out,
                       int mode) {
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    float acc[MT];
#pragma unroll
    for (int t = 0; t < MT; ++t) acc[t] = 0.f;
    for (int k = 0; k < K; k += 4) {
      const float w0 = __ldg(W + (size_t)(k + 0) * N + j);
      const float w1 = __ldg(W + (size_t)(k + 1) * N + j);
      const float w2 = __ldg(W + (size_t)(k + 2) * N + j);
      const float w3 = __ldg(W + (size_t)(k + 3) * N + j);
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        if (t < T) {
          const float4 v = *reinterpret_cast<const float4*>(in + t * K + k);
          acc[t] = fmaf(v.x, w0, acc[t]);
          acc[t] = fmaf(v.y, w1, acc[t]);
          acc[t] = fmaf(v.z, w2, acc[t]);
          acc[t] = fmaf(v.w, w3, acc[t]);
        }
      }
    }
    const float bj = bias[j];
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      if (t < T) {
        float v = acc[t] + bj;
        if (mode == GELU) v = v * 0.5f * (1.0f + erff(v * 0.70710678118654752f));
        if (mode == ADD)
          out[t * N + j] += v;
        else
          out[t * N + j] = v;
      }
    }
  }
}

// Causal multi-head attention of one sequence: qkv (T, 3E) -> out (T, E).
__device__ void attention(const float* qkv, float* out, float* sc, int T,
                          int E, int H) {
  const int D = E / H;
  const float scale = 1.0f / sqrtf((float)D);
  const int E3 = 3 * E;
  for (int idx = threadIdx.x; idx < H * T * T; idx += blockDim.x) {
    const int h = idx / (T * T), r = idx % (T * T);
    const int i = r / T, j = r % T;
    float s = -INFINITY;
    if (j <= i) {
      const float* q = qkv + i * E3 + h * D;
      const float* k = qkv + j * E3 + E + h * D;
      float a = 0.f;
      for (int d = 0; d < D; ++d) a = fmaf(q[d], k[d], a);
      s = a * scale;
    }
    sc[idx] = s;
  }
  __syncthreads();
  for (int row = threadIdx.x; row < H * T; row += blockDim.x) {
    float* p = sc + row * T;
    const int i = row % T;
    float m = -INFINITY;
    for (int j = 0; j <= i; ++j) m = fmaxf(m, p[j]);
    float sum = 0.f;
    for (int j = 0; j <= i; ++j) {
      const float e = expf(p[j] - m);
      p[j] = e;
      sum += e;
    }
    for (int j = 0; j < T; ++j) p[j] = j <= i ? p[j] / sum : 0.f;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < T * E; idx += blockDim.x) {
    const int i = idx / E, e = idx % E, h = e / D;
    const float* p = sc + (h * T + i) * T;
    float a = 0.f;
    for (int j = 0; j <= i; ++j) a = fmaf(p[j], qkv[j * E3 + 2 * E + e], a);
    out[idx] = a;
  }
  __syncthreads();
}

template <int MT>
__global__ void __launch_bounds__(THREADS)
dt_decode_kernel(const float* __restrict__ tokens, float* __restrict__ out,
                 int T, int E, int H, int n_blocks, DTWeights w) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // (T, E) residual stream
  float* hs = xs + T * E;                       // (T, E) normed / attention
  float* big = hs + T * E;                      // (T, 4E) qkv or MLP hidden
  float* sc = big + 4 * T * E;                  // (H, T, T) scores
  const size_t seq = (size_t)blockIdx.x * T * E;
  for (int i = threadIdx.x; i < T * E; i += blockDim.x) xs[i] = tokens[seq + i];
  __syncthreads();
  const int E2 = E * E;
  for (int blk = 0; blk < n_blocks; ++blk) {
    layernorm(xs, hs, T, E, w.ln1_s + blk * E, w.ln1_b + blk * E);
    __syncthreads();
    linear<MT>(hs, T, E, w.qkv_w + (size_t)blk * 3 * E2, w.qkv_b + blk * 3 * E,
               3 * E, big, STORE);
    __syncthreads();
    attention(big, hs, sc, T, E, H);
    linear<MT>(hs, T, E, w.o_w + (size_t)blk * E2, w.o_b + blk * E, E, xs,
               ADD);
    __syncthreads();
    layernorm(xs, hs, T, E, w.ln2_s + blk * E, w.ln2_b + blk * E);
    __syncthreads();
    linear<MT>(hs, T, E, w.fc_w + (size_t)blk * 4 * E2, w.fc_b + blk * 4 * E,
               4 * E, big, GELU);
    __syncthreads();
    linear<MT>(big, T, 4 * E, w.proj_w + (size_t)blk * 4 * E2,
               w.proj_b + blk * E, E, xs, STORE);
    __syncthreads();
  }
  layernorm(xs, out + seq, T, E, w.lnf_s, w.lnf_b);
}

template <int MT>
static int launch(const float* tokens, float* out, int batch, int T, int E,
                  int H, int n_blocks, const DTWeights& w, size_t smem,
                  cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      dt_decode_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dt_decode_kernel<MT><<<batch, THREADS, smem, stream>>>(tokens, out, T, E, H,
                                                         n_blocks, w);
  return (int)cudaGetLastError();
}

extern "C" int dt_decode_launch(
    const void* tokens, void* out, int batch, int T, int E, int H,
    int n_blocks, const void* ln1_s, const void* ln1_b, const void* qkv_w,
    const void* qkv_b, const void* o_w, const void* o_b, const void* ln2_s,
    const void* ln2_b, const void* fc_w, const void* fc_b,
    const void* proj_w, const void* proj_b, const void* lnf_s,
    const void* lnf_b, void* stream) {
  if (T < 1 || T > MAX_T || E % 4 != 0 || H < 1 || E % H != 0 ||
      n_blocks < 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const size_t smem = ((size_t)6 * T * E + (size_t)H * T * T) * sizeof(float);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  DTWeights w = {(const float*)ln1_s, (const float*)ln1_b,
                 (const float*)qkv_w, (const float*)qkv_b,
                 (const float*)o_w,   (const float*)o_b,
                 (const float*)ln2_s, (const float*)ln2_b,
                 (const float*)fc_w,  (const float*)fc_b,
                 (const float*)proj_w, (const float*)proj_b,
                 (const float*)lnf_s, (const float*)lnf_b};
  const float* tk = (const float*)tokens;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (T <= 12) return launch<12>(tk, o, batch, T, E, H, n_blocks, w, smem, s);
  if (T <= 18) return launch<18>(tk, o, batch, T, E, H, n_blocks, w, smem, s);
  return launch<MAX_T>(tk, o, batch, T, E, H, n_blocks, w, smem, s);
}
