// K1: a whole U-Net ConvBlock, L x [3x3 SAME conv + bias + LeakyReLU], in
// one kernel whose inter-layer activations never leave shared memory.
//
// Replaces the TPU kernel fused_conv_block
// (dt4image_restoration_tpu/ops/pallas/conv_block.py:134). It computes the
// same function but none of the TPU layout: no space-to-depth packing, no
// 128-lane channel pad, no full-width row tiles.
//
// Bound on the H100: tensor-core operations under 3xTF32. Each layer is an
// implicit GEMM, M = region pixels, N = F, K = 9 taps x input channels, run
// as mma.sync m16n8k8 TF32 products. One TF32 product keeps 10 mantissa
// bits, about 1e-3 error over up4's 864 terms, so every operand is split
// into hi + lo, both TF32, and each product is taken three times (lo*hi,
// hi*lo, hi*hi; lo*lo dropped), which is float32-accurate. The least time
// is 3x the flops over the 495 TFLOP/s TF32 peak. What the design does
// about it:
//  * The weights come pre-split and pre-swizzled by the wrapper
//    (ops/kernels/conv_block.py:pack_conv_block): per layer, input channels
//    padded to a multiple of 8 and cut into groups of 8; per group and tap,
//    F/8 fragments of 32 lanes x {b0 hi, b1 hi, b0 lo, b1 lo}, the B
//    operand of one product. A lane reads its fragment with one 16-byte
//    load, and a warp's loads hit every bank once.
//  * Activations are split as they are loaded, in three instructions
//    (split()).
//  * Each warp owns MT m16 tiles of pixels x all F outputs, so a B fragment
//    feeds MT tiles and an A fragment 3 F/8 products. How many of its tiles
//    a warp holds is chosen by a warp-uniform branch, so no mma.sync sits
//    in divergent code.
//  * Activation planes in shared memory have a channel stride of 8 mod 32
//    floats, so the 8 pixels x 4 channels of an A fragment fall in 32
//    different banks.
//  * Layer 0's input channels and their weights are staged CK at a time
//    with cp.async, double-buffered: chunk k + 1 loads while chunk k runs.
//    A later layer's weights load while the layer before writes its
//    outputs.
//
// Tiling: one thread block computes a TILE x TILE output tile of one image.
// Layer l (0-based) is computed on the tile grown by a halo of L-1-l pixels,
// so the last layer needs nothing outside the block (the halo is
// recomputed by the neighbouring tiles, about 1.4x the useful work at
// TILE 16, L 3). Layer 0 reads a window grown by L pixels, zero outside the
// image. After every intermediate layer the pixels that lie outside the
// image are set to zero, which gives the next layer SAME-padding semantics.
//
// Layout: x is NCHW float32 (B, Cin, H, W); y is NCHW (B, F, H, W); biases
// are [L][F].
#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 16
#define CK 16              // layer-0 input channels per staged chunk
#define STAGES 2           // staged chunks in flight
#define WARPS 16
#define MT 2               // m16 tiles of pixels per warp
#define THREADS (WARPS * 32)
#define MAX_LAYERS 4
#define MAX_SMEM 232448

// Every layer's region (at most TILE + 2 (MAX_LAYERS - 1) pixels square) fits
// in MT m16 tiles per warp, so each layer is one pass of the warps.
static_assert((TILE + 2 * (MAX_LAYERS - 1)) * (TILE + 2 * (MAX_LAYERS - 1))
                  <= MT * WARPS * 16,
              "a layer's region must fit MT m16 tiles per warp");
// A row of layer 0's input window (TILE + 2L pixels) fits one warp's lanes.
static_assert(TILE + 2 * MAX_LAYERS <= 32, "a window row must fit a warp");

struct Dims {
  int cin, h, w, layers, tiles_x;
  float slope;
};

// Side of the square region a layer works on, for a halo of `halo` pixels.
__host__ __device__ static inline int region(int halo) {
  return TILE + 2 * halo;
}

// Channel stride of an s x s activation plane: at least s*s and 8 mod 32
// floats, so lanes (g, t) reading pixel g of channel t hit bank 8t + g.
__host__ __device__ static inline int plane(int s) {
  const int n = s * s;
  return n + (40 - n % 32) % 32;
}

// Floats of the weight buffer: STAGES chunks of layer 0's CK / 8 channel
// groups, or a later layer's F / 8 groups, whichever is more; a group's
// fragments are 9 taps x F/8 x 32 lanes x 4 floats.
__host__ __device__ static inline int weight_floats(int nt) {
  return 9 * nt * 128 * (STAGES * CK / 8 > nt ? STAGES * CK / 8 : nt);
}

static size_t smem_floats(int f, int layers) {
  const size_t w = weight_floats(f / 8);
  const size_t in = (size_t)STAGES * CK * plane(region(layers));
  const size_t mid = (size_t)f * plane(region(layers - 1));
  const size_t mid1 = layers > 2 ? mid : 0;
  return w + (layers > 1 ? mid : 0) + (in > mid1 ? in : mid1);
}

// Asynchronous copies to shared memory: 16 bytes, or 4 bytes of which the
// first `bytes` are read and the rest zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most `N` committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// d += a b on one m16n8k8 tile, TF32 operands, float32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v = hi + lo. hi is v rounded to TF32, to nearest with ties away from
// zero: for finite v what cvt.rna.tf32.f32 gives, in two integer
// instructions instead of its four (which also handle NaN and infinity).
// lo = v - hi is exact; the tensor core reads its top 19 bits, so its own
// rounding is a truncation, |error| <= 2^-21 |v| in all.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// One 8-channel group over the 9 taps, for the first N of the warp's MT
// m16 tiles. `a` points at channel t of the group in an activation plane of
// stride cs and side si; off[i][r] is the plane offset of row g + 8r of tile
// i; `wf` at this lane's fragment of tap 0, n-tile 0.
template <int NT, int N>
__device__ __forceinline__ void group_taps(const float* a, int cs, int si,
                                           const int (&off)[MT][2],
                                           const float4* wf,
                                           float (&acc)[MT][NT][4]) {
  // One row of the 3x3 window per iteration: unrolling all nine taps needs
  // more than the 128 registers a thread has at 512 threads.
#pragma unroll 3
  for (int tap = 0; tap < 9; ++tap) {
    const float* at = a + (tap / 3) * si + tap % 3;
    uint32_t hi[N][4], lo[N][4];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float v[4] = {at[off[i][0]], at[off[i][1]],
                          at[4 * cs + off[i][0]], at[4 * cs + off[i][1]]};
#pragma unroll
      for (int k = 0; k < 4; ++k) split(v[k], hi[i][k], lo[i][k]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float4 f = wf[(tap * NT + j) * 32];
      const uint32_t bh0 = __float_as_uint(f.x), bh1 = __float_as_uint(f.y);
      const uint32_t bl0 = __float_as_uint(f.z), bl1 = __float_as_uint(f.w);
      // Small terms first, each product over the warp's tiles in turn, so
      // that no product waits on the one just before it.
#pragma unroll
      for (int i = 0; i < N; ++i) mma(acc[i][j], lo[i], bh0, bh1);
#pragma unroll
      for (int i = 0; i < N; ++i) mma(acc[i][j], hi[i], bl0, bl1);
#pragma unroll
      for (int i = 0; i < N; ++i) mma(acc[i][j], hi[i], bh0, bh1);
    }
  }
}

// group_taps for the warp's n valid tiles (1 <= n <= MT), chosen by a
// warp-uniform branch so that no mma.sync sits in divergent code.
template <int NT, int N = MT>
__device__ __forceinline__ void group_taps_n(int n, const float* a, int cs,
                                             int si, const int (&off)[MT][2],
                                             const float4* wf,
                                             float (&acc)[MT][NT][4]) {
  if constexpr (N > 1) {
    if (n < N) {
      group_taps_n<NT, N - 1>(n, a, cs, si, off, wf, acc);
      return;
    }
  }
  group_taps<NT, N>(a, cs, si, off, wf, acc);
}

template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
conv_block_kernel(const float* __restrict__ x, const float* __restrict__ wts,
                  const float* __restrict__ bias, float* __restrict__ y,
                  Dims d) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int F = NT * 8;
  constexpr int FRAG = 9 * NT * 128;
  const int L = d.layers, H = d.h, W = d.w, Cin = d.cin;
  const int cinp = (Cin + 7) & ~7;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y;
  const int oy0 = (blockIdx.x / d.tiles_x) * TILE;
  const int ox0 = (blockIdx.x % d.tiles_x) * TILE;

  // Shared memory: the weight fragments (two stages of a layer-0 chunk's,
  // or a whole later layer's), then two ping-pong intermediates of F
  // channels. Layer 0's input chunks use the second intermediate's room
  // (extended if need be), which layer 1 is the first to write.
  const int s0 = region(L), cs0 = plane(s0);
  const int cs1 = plane(region(L - 1));
  float* sw = smem;
  float* sbuf0 = sw + weight_floats(NT);
  float* sbuf1 = sbuf0 + (L > 1 ? F * cs1 : 0);
  float* s_in = sbuf1;

  // Start the copies of layer 0's input channels [c0, c0 + CK) (the
  // window grown by L pixels, zero outside the image and past Cin) and of
  // their weight fragments into stage `st`, as one commit group.
  auto stage_chunk = [&](int c0, int st) {
    const int nc = min(CK, cinp - c0);
    const float* wsrc = wts + (size_t)(c0 / 8) * FRAG;
    float* wdst = sw + st * (CK / 8) * FRAG;
    for (int i = tid; i < nc / 8 * FRAG / 4; i += THREADS)
      cp_async16(wdst + 4 * i, wsrc + 4 * i);
    float* idst = s_in + st * CK * cs0;
    for (int row = warp; row < nc * s0; row += WARPS) {
      const int cc = row / s0, iy = row - cc * s0;
      const int gy = oy0 - L + iy, gx = ox0 - L + lane;
      if (lane < s0) {
        const bool in = c0 + cc < Cin && gy >= 0 && gy < H && gx >= 0
            && gx < W;
        const float* gsrc =
            in ? x + (((size_t)b * Cin + c0 + cc) * H + gy) * W + gx : x;
        cp_async4(idst + cc * cs0 + iy * s0 + lane, gsrc, in ? 4 : 0);
      }
    }
    cp_async_commit();
  };
  stage_chunk(0, 0);

  const float* src = nullptr;  // a later layer's input plane and its stride
  int src_cs = 0;
  const float* wl = wts;
  for (int l = 0; l < L; ++l) {
    const int halo = L - 1 - l;
    const int so = region(halo);  // output region side
    const int si = so + 2;        // input region side
    const int npix = so * so;
    const int nm = (npix + 15) / 16;
    const int kin = (l == 0) ? cinp : F;
    const bool last = (l == L - 1);

    // This warp's m16 tiles are warp + i WARPS, the first n of them valid.
    const int n = min(MT, max(0, (nm - warp + WARPS - 1) / WARPS));
    int off[MT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = (warp + i * WARPS) * 16 + g + 8 * r;
        const int pp = p < npix ? p : 0;
        off[i][r] = (pp / so) * si + (pp % so);
      }
    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

    if (l == 0) {
      // Double-buffered: chunk k + 1 is in flight while chunk k runs.
      for (int c0 = 0, k = 0; c0 < kin; c0 += CK, ++k) {
        if (c0 + CK < kin) {
          stage_chunk(c0 + CK, (k + 1) % STAGES);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();  // chunk k is in shared memory for every warp
        const int st = k % STAGES;
        if (n > 0) {
          for (int grp = 0; grp < min(CK, kin - c0) / 8; ++grp)
            group_taps_n<NT>(
                n, s_in + st * CK * cs0 + (grp * 8 + t) * cs0, cs0, si, off,
                reinterpret_cast<const float4*>(
                    sw + (st * (CK / 8) + grp) * FRAG) + lane,
                acc);
        }
        __syncthreads();  // stage k % STAGES may be overwritten
      }
    } else {
      cp_async_wait<0>();
      __syncthreads();  // this layer's weights are in shared memory
      if (n > 0) {
        for (int grp = 0; grp < NT; ++grp)
          group_taps_n<NT>(n, src + (grp * 8 + t) * src_cs, src_cs, si, off,
                           reinterpret_cast<const float4*>(sw + grp * FRAG)
                               + lane,
                           acc);
      }
      __syncthreads();  // every warp is done with sw
    }
    // The next layer's weights load while this layer's outputs are written.
    wl += (size_t)kin / 8 * FRAG;
    if (!last) {
      for (int i = tid; i < NT * FRAG / 4; i += THREADS)
        cp_async16(sw + 4 * i, wl + 4 * i);
      cp_async_commit();
    }

    // Bias, LeakyReLU; the last layer to y, the others to shared memory
    // with the pixels outside the image zeroed.
    const int cs_out = plane(so);
    const float* bl = bias + l * F;
    float* dst = (l % 2 == 0) ? sbuf0 : sbuf1;
    const int gy0 = oy0 - halo, gx0 = ox0 - halo;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i >= n) break;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = (warp + i * WARPS) * 16 + g + 8 * r;
        if (p >= npix) continue;
        const int gy = gy0 + p / so, gx = gx0 + p % so;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int co = j * 8 + 2 * t + e;
            float v = acc[i][j][2 * r + e] + bl[co];
            v = v >= 0.f ? v : d.slope * v;
            if (last) {
              if (inside) y[(((size_t)b * F + co) * H + gy) * W + gx] = v;
            } else {
              dst[co * cs_out + p] = inside ? v : 0.f;
            }
          }
      }
    }
    __syncthreads();  // dst is complete before the next layer reads it
    src = dst;
    src_cs = cs_out;
  }
}

template <int NT>
static int launch(const float* x, const float* w, const float* b, float* y,
                  int batch, size_t smem, const Dims& d, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      conv_block_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles_y = (d.h + TILE - 1) / TILE;
  dim3 grid(d.tiles_x * tiles_y, batch);
  conv_block_kernel<NT><<<grid, THREADS, smem, stream>>>(x, w, b, y, d);
  return (int)cudaGetLastError();
}

// `w` is the pre-split fragment buffer (PackedConvBlock.tc_weights).
extern "C" int conv_block_launch(const void* x, const void* w, const void* b,
                                 void* y, int batch, int cin, int h, int w_,
                                 int f, int layers, float slope,
                                 void* stream) {
  if (f % 8 != 0 || f <= 0 || f > 32 || layers < 1 || layers > MAX_LAYERS
      || cin < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  size_t smem = smem_floats(f, layers) * sizeof(float);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (batch == 0 || h == 0 || w_ == 0) return 0;
  Dims d;
  d.cin = cin;
  d.h = h;
  d.w = w_;
  d.layers = layers;
  d.tiles_x = (w_ + TILE - 1) / TILE;
  d.slope = slope;
  const float* xf = (const float*)x;
  const float* wf = (const float*)w;
  const float* bf = (const float*)b;
  float* yf = (float*)y;
  cudaStream_t s = (cudaStream_t)stream;
  switch (f / 8) {
    case 1: return launch<1>(xf, wf, bf, yf, batch, smem, d, s);
    case 2: return launch<2>(xf, wf, bf, yf, batch, smem, d, s);
    case 3: return launch<3>(xf, wf, bf, yf, batch, smem, d, s);
    default: return launch<4>(xf, wf, bf, yf, batch, smem, d, s);
  }
}
