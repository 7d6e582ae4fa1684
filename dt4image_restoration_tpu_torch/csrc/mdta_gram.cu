// K7: Restormer's transposed-attention map, the softmax of the normalised
// channel Gram of q and k, in two passes over a split of the pixels.
//
// Replaces no TPU kernel: the JAX package has no Restormer. The plain path
// (ops/kernels/mdta_gram.py:mdta_gram_plain) is F.normalize of q and k
// along the pixels, a batched matmul whose inner dimension is every pixel
// of the image (16,384 at 128^2) and whose output is only c x c (c = 48 or
// 96), and a softmax: it reads q and k several times, and its (sample,
// head) batch, 63 pairs at the first level, leaves most SMs idle. For one
// (sample b, head h), with q, k the c x P channel rows of that head:
//
//     G   = q k^T                                   c x c, over P pixels
//     nq  = |q_i|, nk = |k_j|                        row norms
//     A   = softmax_j(tau_h * G_ij / (max(nq_i, 1e-12) * max(nk_j, 1e-12)))
//
// Input: qkv, the output of the block's depthwise conv, channels-last
// (B, P, 3C) in bfloat16 or float32, so q is channels [h c, h c + c) and k
// channels [C + h c, C + h c + c) of each pixel's row, read in place; tau
// (heads,) float32. Output: A (B, heads, c, c) float32.
//
// Pass 1 (mdta_gram_partial), grid (S, heads, B): CTA s takes pixels
// [s ppc, (s + 1) ppc) of its (b, h) in chunks of TP pixels (TP_F32 under
// float32), copied with 16-byte loads into shared memory as
// [pixel][channel] rows, zero past the end. Under bfloat16 the Gram's
// products run on the tensor cores as 16 x 16 x 16 WMMA tiles with float32
// sums (q read as a column-major A, k as a row-major B, both straight from
// the staged rows); the (c / 16)^2 output tiles are dealt round-robin to
// the four warps. Under float32 each thread sums its own entries of G in
// float32 on the SIMT pipe (the float32 configuration keeps full
// precision: no TF32). The squared norms of q's and k's rows are summed in
// float32 from the same staged rows. The CTA writes its partial G and the
// 2c squared norms to a workspace row (B, heads, S, c^2 + 2c) that the
// wrapper allocates.
//
// Pass 2 (mdta_gram_softmax), grid (heads, B): sums the S partials of its
// (b, h) in order s = 0 .. S-1 (deterministic: no atomics, so a CUDA-graph
// replay equals the eager call bit for bit), takes the norms, and writes
// the softmax of each row, one warp a row, with float32 exp.
//
// Bound on the H100: memory traffic. q and k are read once (2 c bytes a
// pixel and head in bfloat16) for 2 c^2 flops a pixel: 48 flops a byte at
// c = 48, far below the 295 that the tensor cores need; the split S makes
// about 8 CTAs an SM at every level, so that 63 (sample, head) pairs fill
// the card. The partials cost (c^2 + 2c) floats a CTA, a few percent of
// the bytes of q and k at the shapes Restormer runs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace wmma = nvcuda::wmma;

#define THREADS 128       // pass 1: four warps
#define TP 64             // pixels a chunk under bfloat16; ppc's multiple
#define TP_F32 32         // under float32 (48 KB of static shared memory)
#define PAD 8             // shared row padding, elements
#define SOFTMAX_THREADS 256

template <typename T>
struct Vec;   // 16 bytes of T
template <>
struct Vec<__nv_bfloat16> { static constexpr int N = 8; };
template <>
struct Vec<float> { static constexpr int N = 4; };

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(float x) { return x; }

// Stage one chunk of q and k rows of (b, h) into shared memory: rows
// [p0, p0 + R) of pixels below `p_end`, zero past it.
template <typename T, int C, int R>
__device__ __forceinline__ void stage(const T* __restrict__ q,
                                      const T* __restrict__ k, long long ld,
                                      int p0, int p_end, T* sq, T* sk) {
  constexpr int VN = Vec<T>::N;
  constexpr int VR = C / VN;           // vectors a row
  constexpr int LDS = C + PAD;         // shared row stride, elements
  for (int v = threadIdx.x; v < 2 * R * VR; v += THREADS) {
    const int which = v / (R * VR);    // 0: q, 1: k
    const int r = (v / VR) % R;
    const int col = (v % VR) * VN;
    const int p = p0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (p < p_end) {
      const T* src = (which ? k : q) + (long long)p * ld + col;
      val = *reinterpret_cast<const uint4*>(src);
    }
    *reinterpret_cast<uint4*>((which ? sk : sq) + r * LDS + col) = val;
  }
}

// Sum of squares of the R staged rows' columns: thread t owns columns t,
// t + THREADS of the 2C (q then k).
template <typename T, int C, int R>
__device__ __forceinline__ void add_squares(const T* sq, const T* sk,
                                            float* nrm) {
  constexpr int LDS = C + PAD;
  constexpr int NC = (2 * C + THREADS - 1) / THREADS;
#pragma unroll
  for (int u = 0; u < NC; ++u) {
    const int col = threadIdx.x + u * THREADS;
    if (col < 2 * C) {
      const T* base = col < C ? sq + col : sk + (col - C);
      float s = 0.f;
#pragma unroll 8
      for (int r = 0; r < R; ++r) {
        const float x = to_float(base[r * LDS]);
        s += x * x;
      }
      nrm[u] += s;
    }
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS)
mdta_gram_partial_bf16(const __nv_bfloat16* __restrict__ qkv,
                       float* __restrict__ ws, int P, int heads, int S,
                       int ppc) {
  constexpr int CT = C / 16;                  // tiles a side
  constexpr int TILES = CT * CT;
  constexpr int MAXT = (TILES + 3) / 4;       // tiles a warp, at most
  constexpr int LDS = C + PAD;
  constexpr int NC = (2 * C + THREADS - 1) / THREADS;
  __shared__ __align__(32) __nv_bfloat16 sq[TP * LDS];
  __shared__ __align__(32) __nv_bfloat16 sk[TP * LDS];

  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int C3 = 3 * C * heads;               // the row: 3 C channels
  const __nv_bfloat16* q = qkv + (long long)b * P * C3 + h * C;
  const __nv_bfloat16* k = q + C * heads;
  const int p_begin = s * ppc;
  const int p_end = min(P, p_begin + ppc);
  const int warp = threadIdx.x / 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAXT];
#pragma unroll
  for (int u = 0; u < MAXT; ++u) wmma::fill_fragment(acc[u], 0.f);
  float nrm[NC];
#pragma unroll
  for (int u = 0; u < NC; ++u) nrm[u] = 0.f;

  for (int p0 = p_begin; p0 < p_end; p0 += TP) {
    stage<__nv_bfloat16, C, TP>(q, k, C3, p0, p_end, sq, sk);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < MAXT; ++u) {
      const int t = warp + 4 * u;
      if (t < TILES) {                        // uniform over the warp
        const int ti = t / CT, tj = t % CT;
#pragma unroll
        for (int kk = 0; kk < TP; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> bm;
          wmma::load_matrix_sync(a, sq + kk * LDS + ti * 16, LDS);
          wmma::load_matrix_sync(bm, sk + kk * LDS + tj * 16, LDS);
          wmma::mma_sync(acc[u], a, bm, acc[u]);
        }
      }
    }
    add_squares<__nv_bfloat16, C, TP>(sq, sk, nrm);
    __syncthreads();
  }

  float* out = ws + (((long long)b * heads + h) * S + s) * (C * C + 2 * C);
#pragma unroll
  for (int u = 0; u < MAXT; ++u) {
    const int t = warp + 4 * u;
    if (t < TILES) {
      const int ti = t / CT, tj = t % CT;
      wmma::store_matrix_sync(out + ti * 16 * C + tj * 16, acc[u], C,
                              wmma::mem_row_major);
    }
  }
#pragma unroll
  for (int u = 0; u < NC; ++u) {
    const int col = threadIdx.x + u * THREADS;
    if (col < 2 * C) out[C * C + col] = nrm[u];
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS)
mdta_gram_partial_f32(const float* __restrict__ qkv, float* __restrict__ ws,
                      int P, int heads, int S, int ppc) {
  constexpr int LDS = C + PAD;
  constexpr int NE = (C * C + THREADS - 1) / THREADS;   // entries a thread
  constexpr int NC = (2 * C + THREADS - 1) / THREADS;
  __shared__ __align__(16) float sq[TP_F32 * LDS];
  __shared__ __align__(16) float sk[TP_F32 * LDS];

  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int C3 = 3 * C * heads;
  const float* q = qkv + (long long)b * P * C3 + h * C;
  const float* k = q + C * heads;
  const int p_begin = s * ppc;
  const int p_end = min(P, p_begin + ppc);

  float acc[NE];
#pragma unroll
  for (int u = 0; u < NE; ++u) acc[u] = 0.f;
  float nrm[NC];
#pragma unroll
  for (int u = 0; u < NC; ++u) nrm[u] = 0.f;

  for (int p0 = p_begin; p0 < p_end; p0 += TP_F32) {
    stage<float, C, TP_F32>(q, k, C3, p0, p_end, sq, sk);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < NE; ++u) {
      const int e = threadIdx.x + u * THREADS;
      if (e < C * C) {
        const int i = e / C, j = e % C;
        float g = acc[u];
        for (int r = 0; r < TP_F32; ++r)
          g += sq[r * LDS + i] * sk[r * LDS + j];
        acc[u] = g;
      }
    }
    add_squares<float, C, TP_F32>(sq, sk, nrm);
    __syncthreads();
  }

  float* out = ws + (((long long)b * heads + h) * S + s) * (C * C + 2 * C);
#pragma unroll
  for (int u = 0; u < NE; ++u) {
    const int e = threadIdx.x + u * THREADS;
    if (e < C * C) out[e] = acc[u];
  }
#pragma unroll
  for (int u = 0; u < NC; ++u) {
    const int col = threadIdx.x + u * THREADS;
    if (col < 2 * C) out[C * C + col] = nrm[u];
  }
}

// Pass 2: one CTA a (b, h); the S partials summed in order, then one warp
// a row of the softmax.
template <int C>
__global__ void __launch_bounds__(SOFTMAX_THREADS)
mdta_gram_softmax(const float* __restrict__ ws, const float* __restrict__ tau,
                  float* __restrict__ attn, int heads, int S) {
  constexpr int J = (C + 31) / 32;            // entries a lane, a row
  __shared__ float g[C * (C + 1)];
  __shared__ float inv_q[C], inv_k[C];
  const int h = blockIdx.x, b = blockIdx.y;
  const long long row = (long long)C * C + 2 * C;
  const float* part = ws + ((long long)b * heads + h) * S * row;

  for (int e = threadIdx.x; e < C * C; e += SOFTMAX_THREADS) {
    float sum = 0.f;
    for (int s = 0; s < S; ++s) sum += part[s * row + e];
    g[(e / C) * (C + 1) + e % C] = sum;
  }
  for (int col = threadIdx.x; col < 2 * C; col += SOFTMAX_THREADS) {
    float sum = 0.f;
    for (int s = 0; s < S; ++s) sum += part[s * row + C * C + col];
    const float n = fmaxf(sqrtf(sum), 1e-12f);
    if (col < C) inv_q[col] = 1.f / n;
    else inv_k[col - C] = 1.f / n;
  }
  __syncthreads();

  const float neg_inf = __int_as_float(0xff800000);
  const float t = tau[h];
  const int lane = threadIdx.x % 32;
  float* out = attn + ((long long)b * heads + h) * C * C;
  for (int i = threadIdx.x / 32; i < C; i += SOFTMAX_THREADS / 32) {
    float v[J];
    float m = neg_inf;
#pragma unroll
    for (int u = 0; u < J; ++u) {
      const int j = lane + 32 * u;
      v[u] = j < C ? t * (g[i * (C + 1) + j] * inv_q[i] * inv_k[j])
                   : neg_inf;
      m = fmaxf(m, v[u]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < J; ++u) {
      const int j = lane + 32 * u;
      v[u] = j < C ? expf(v[u] - m) : 0.f;
      sum += v[u];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
#pragma unroll
    for (int u = 0; u < J; ++u) {
      const int j = lane + 32 * u;
      if (j < C) out[i * C + j] = v[u] / sum;
    }
  }
}

template <int C>
static cudaError_t launch(const void* qkv, const float* tau, float* ws,
                          float* attn, int bf16, int B, int P, int heads,
                          int S, int ppc, cudaStream_t stream) {
  const dim3 grid1(S, heads, B);
  if (bf16)
    mdta_gram_partial_bf16<C><<<grid1, THREADS, 0, stream>>>(
        (const __nv_bfloat16*)qkv, ws, P, heads, S, ppc);
  else
    mdta_gram_partial_f32<C><<<grid1, THREADS, 0, stream>>>(
        (const float*)qkv, ws, P, heads, S, ppc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  mdta_gram_softmax<C><<<dim3(heads, B), SOFTMAX_THREADS, 0, stream>>>(
      ws, tau, attn, heads, S);
  return cudaGetLastError();
}

// qkv (B, P, 3 heads c) channels-last, bfloat16 (bf16 = 1) or float32;
// tau (heads,) float32; ws (B, heads, S, c^2 + 2c) float32; attn (B,
// heads, c, c) float32. S and ppc (pixels a CTA, a multiple of TP) come
// from the wrapper, with S * ppc >= P.
extern "C" int mdta_gram_launch(const void* qkv, const void* tau, void* ws,
                                void* attn, int bf16, int B, int P, int c,
                                int heads, int S, int ppc, void* stream) {
  if (B <= 0 || P <= 0) return 0;
  if (heads <= 0 || S <= 0 || ppc <= 0 || ppc % TP
      || (long long)S * ppc < P)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* t = (const float*)tau;
  float* w = (float*)ws;
  float* a = (float*)attn;
  switch (c) {
    case 48: return (int)launch<48>(qkv, t, w, a, bf16, B, P, heads, S, ppc, st);
    case 96: return (int)launch<96>(qkv, t, w, a, bf16, B, P, heads, S, ppc, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
