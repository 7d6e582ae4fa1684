// K8: Restormer's BiasFree LayerNorm over the channels of each pixel, one
// pass over the rows.
//
// Replaces no TPU kernel: the JAX package has no Restormer. For every row x
// of C values (one pixel of a contiguous (B, H, W, C) tensor) and the
// float32 scale w (C,):
//
//     mean = sum(x) / C
//     var  = sum((x - mean)^2) / C                 about the mean
//     y    = x / sqrt(var + eps) * w               x itself not centred
//
// The statistics and the product are float32 and y is rounded once to the
// input's dtype (bfloat16 or float32). The plain path
// (ops/kernels/biasfree_layernorm.py:biasfree_layernorm_plain) computes the
// same in float32. PyTorch's native_layer_norm, which the port ran before,
// gives one block to each row: Restormer's rows are short (48 to 384
// channels) and many (63 x 128^2 = 1.03 M at its first level), so a block
// spent most of its time on a 96- to 768-byte reduction, and the mean's
// share had to be added back by a second, elementwise pass.
//
// Layout. The rows of a call are one contiguous chunk. A row belongs to a
// group of G neighbouring lanes of a warp (G a power of two); lane p of the
// group holds V 16-byte vectors of the row, vectors p, p + G, ..., p + (V -
// 1) G, so each of its V loads has the group's lanes on neighbouring
// addresses (G x 16 bytes of a row at a time, the warp's 32 / G rows
// side by side). The row stays in registers between the two reductions
// (its mean, then the sum of squares about it), each a butterfly of
// shuffles inside the group, and y is written from the same registers with
// the same 16-byte pattern: every value is read once and written once.
//
// Widths. The four published widths have their own instantiations, V = 3
// vectors a lane: G = C / 24 under bfloat16 (2, 4, 8, 16 lanes a row) and
// G = C / 12 under float32 (4, 8, 16, 32). Any other multiple of 8 up to
// MAX_C runs one generic instantiation a dtype (16 lanes of 3 vectors under
// bfloat16, 32 under float32) that masks the vectors past the row's end.
//
// Grid. Each thread keeps its lanes' share of w in registers and walks the
// rows: a CTA takes THREADS / G rows at a time, and the grid is as many
// CTAs as the card holds at once (the occupancy of the instantiation times
// the SMs), each striding over the rows. No shared memory, no atomics, no
// allocation: a launch on the caller's stream captures into a CUDA graph
// and replays bit for bit.
//
// Bound on the H100: memory traffic. Per value about five float32 flops
// against 2 x sizeof(T) bytes (4 bytes in bfloat16), so the least time is
// the bytes of x and y over the bandwidth: 3.55 ms for the 88 LayerNorms
// of a B=63 Restormer forward on 128^2 slices.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

#define THREADS 256
#define MAX_C 384          // widest row: Restormer's latent level
#define MAX_DEVICES 64     // devices whose SM count is kept

template <typename T>
struct Vec;   // values a 16-byte vector holds
template <>
struct Vec<__nv_bfloat16> { static constexpr int N = 8; };
template <>
struct Vec<float> { static constexpr int N = 4; };

__device__ __forceinline__ void to_floats(const uint4& r, float* f,
                                          __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void to_floats(const uint4& r, float* f, float) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ uint4 from_floats(const float* f, __nv_bfloat16) {
  uint4 r;
  unsigned* u = reinterpret_cast<unsigned*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    u[i] = *reinterpret_cast<const unsigned*>(&h);
  }
  return r;
}

__device__ __forceinline__ uint4 from_floats(const float* f, float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

// Sum over the G lanes of a group (the lanes named in `mask`).
template <int G>
__device__ __forceinline__ float group_sum(float v, unsigned mask) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o);
  return v;
}

// EXACT: the row is exactly G x V vectors (a published width); otherwise
// vectors at or past C / N are masked.
template <typename T, int G, int V, bool EXACT>
__global__ void __launch_bounds__(THREADS)
biasfree_layernorm_kernel(const T* __restrict__ x,
                          const float* __restrict__ w, T* __restrict__ y,
                          long long rows, int C, float eps) {
  constexpr int N = Vec<T>::N;
  constexpr int RPC = THREADS / G;           // rows a CTA takes at a time
  const int part = threadIdx.x % G;
  const int lane = threadIdx.x % 32;
  const unsigned mask =
      G == 32 ? 0xffffffffu : ((1u << (G % 32)) - 1u) << (lane & ~(G - 1));
  const int nvec = EXACT ? G * V : C / N;

  float scale[V][N];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int i = j * G + part;
#pragma unroll
    for (int e = 0; e < N; e += 4) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      if (EXACT || i < nvec)
        s = *reinterpret_cast<const float4*>(w + i * N + e);
      scale[j][e] = s.x;
      scale[j][e + 1] = s.y;
      scale[j][e + 2] = s.z;
      scale[j][e + 3] = s.w;
    }
  }

  const long long stride = (long long)gridDim.x * RPC;
  for (long long row = (long long)blockIdx.x * RPC + threadIdx.x / G;
       row < rows; row += stride) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * C);
    uint4 raw[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int i = j * G + part;
      raw[j] = (EXACT || i < nvec) ? xr[i] : make_uint4(0u, 0u, 0u, 0u);
    }
    float v[V][N];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      to_floats(raw[j], v[j], T());
#pragma unroll
      for (int e = 0; e < N; ++e) sum += v[j][e];   // masked vectors are 0
    }
    const float mean = group_sum<G>(sum, mask) / (float)C;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (EXACT || j * G + part < nvec) {
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float d = v[j][e] - mean;
          sq += d * d;
        }
      }
    }
    const float rstd = 1.f / sqrtf(group_sum<G>(sq, mask) / (float)C
                                 + eps);
    uint4* yr = reinterpret_cast<uint4*>(y + row * C);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int i = j * G + part;
      if (EXACT || i < nvec) {
        float o[N];
#pragma unroll
        for (int e = 0; e < N; ++e) o[e] = v[j][e] * rstd * scale[j][e];
        yr[i] = from_floats(o, T());
      }
    }
  }
}

static cudaError_t sm_count(int* out) {
  static int sms[MAX_DEVICES] = {};   // SM count of each device, once read
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    int n = 0;
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    sms[dev] = n;
  }
  *out = sms[dev];
  return cudaSuccess;
}

template <typename T, int G, int V, bool EXACT>
static cudaError_t launch(const void* x, const float* w, void* y,
                          long long rows, int C, float eps,
                          cudaStream_t st) {
  constexpr int RPC = THREADS / G;
  static std::atomic<int> ctas_per_sm{0};   // this instantiation's occupancy
  const auto kernel = biasfree_layernorm_kernel<T, G, V, EXACT>;
  int occ = ctas_per_sm.load(std::memory_order_relaxed);
  if (occ == 0) {
    cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, THREADS, 0);
    if (e != cudaSuccess) return e;
    occ = occ < 1 ? 1 : occ;
    ctas_per_sm.store(occ, std::memory_order_relaxed);
  }
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  const long long tiles = (rows + RPC - 1) / RPC;
  const long long full = (long long)sms * occ;
  kernel<<<(unsigned)(tiles < full ? tiles : full), THREADS, 0, st>>>(
      (const T*)x, w, (T*)y, rows, C, eps);
  return cudaGetLastError();
}

// x, y: `rows` contiguous rows of C values, bfloat16 (bf16 != 0) or float32,
// 16-byte aligned; w: C float32 values, 16-byte aligned. C is a multiple of
// 8 up to MAX_C.
extern "C" int biasfree_layernorm_launch(const void* x, const void* w,
                                         void* y, int bf16, long long rows,
                                         int C, float eps, void* stream) {
  if (rows <= 0) return 0;
  if (C <= 0 || C % 8 || C > MAX_C) return (int)cudaErrorInvalidValue;
  const float* s = (const float*)w;
  const cudaStream_t st = (cudaStream_t)stream;
  typedef __nv_bfloat16 bf;
  if (bf16) {
    switch (C) {
      case 48: return (int)launch<bf, 2, 3, true>(x, s, y, rows, C, eps, st);
      case 96: return (int)launch<bf, 4, 3, true>(x, s, y, rows, C, eps, st);
      case 192: return (int)launch<bf, 8, 3, true>(x, s, y, rows, C, eps, st);
      case 384: return (int)launch<bf, 16, 3, true>(x, s, y, rows, C, eps, st);
      default: return (int)launch<bf, 16, 3, false>(x, s, y, rows, C, eps, st);
    }
  }
  switch (C) {
    case 48: return (int)launch<float, 4, 3, true>(x, s, y, rows, C, eps, st);
    case 96: return (int)launch<float, 8, 3, true>(x, s, y, rows, C, eps, st);
    case 192: return (int)launch<float, 16, 3, true>(x, s, y, rows, C, eps, st);
    case 384: return (int)launch<float, 32, 3, true>(x, s, y, rows, C, eps, st);
    default: return (int)launch<float, 32, 3, false>(x, s, y, rows, C, eps, st);
  }
}
