// K1 in bfloat16: a whole U-Net ConvBlock, L x [3x3 SAME conv + bias +
// LeakyReLU], in one kernel whose inter-layer activations never leave
// shared memory, on bfloat16 operands.
//
// Replaces the TPU kernel fused_conv_block
// (dt4image_restoration_tpu/ops/pallas/conv_block.py:134) called with
// bfloat16 operands. It computes what that kernel computes for them:
// bfloat16 input, weights and biases; every product summed in float32; the
// bias added and LeakyReLU applied in float32; the result rounded to
// nearest-even bfloat16 after every layer and at the output.
//
// Bound on the H100: tensor-core operations. Each layer is an implicit GEMM,
// M = region pixels, N = F, K = 9 taps x input channels, run as mma.sync
// m16n8k16 bfloat16 products with float32 accumulators: one product a
// term, none of the float32 kernel's 3xTF32 split. The least time is the
// flops over the 989 TFLOP/s dense bfloat16 rate. What the design does:
//  * The tiling is the float32 K1's (csrc/conv_block.cu): a TILE x TILE
//    output tile of one image per block, layer l computed on the tile
//    grown by a halo of L-1-l pixels, so the last layer needs nothing
//    outside the block; after every intermediate layer the pixels outside
//    the image are zeroed (SAME padding for the next layer).
//  * Activations live in shared memory as channel pairs: one 32-bit word
//    holds channels 2c and 2c+1 of a pixel, which is how an m16n8k16 A
//    fragment packs them, so a lane loads each of its four A registers
//    with one 32-bit load. A pair plane's stride is 8 mod 32 words, so the
//    8 pixels x 4 pairs of a fragment fall in 32 different banks.
//  * Input channels are padded to a multiple of 16 (one k16 step); Cin = 2
//    at inc is one step of which 14 channels are zero. Layer 0's input is
//    staged CK channels at a time, read from device memory as pairs and
//    packed by the threads (bfloat16 pixels are 2 bytes, too narrow for
//    cp.async to interleave).
//  * The weights come packed by the wrapper
//    (ops/kernels/conv_block_bf16.py:fragments) in m16n8k16 B-fragment
//    order: per 16-channel group, tap and n-tile of 8 outputs, lane 4g + t
//    holds two words, channels (2t, 2t+1) and (2t+8, 2t+9) to output g.
//    A lane reads them with one 8-byte load from the read-only cache.
//  * Bias and LeakyReLU in float32; the two neighbouring output channels a
//    lane holds are rounded together (__floats2bfloat162_rn) into one pair
//    word.
//
// Layout: x is NCHW bfloat16 (B, Cin, H, W); y is NCHW bfloat16
// (B, F, H, W); biases are bfloat16 [L][F].
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 16
#define CK 32              // layer-0 input channels per staged chunk
#define WARPS 16
#define MT 2               // m16 tiles of pixels per warp
#define THREADS (WARPS * 32)
#define MAX_LAYERS 4
#define MAX_SMEM 232448

static_assert((TILE + 2 * (MAX_LAYERS - 1)) * (TILE + 2 * (MAX_LAYERS - 1))
                  <= MT * WARPS * 16,
              "a layer's region must fit MT m16 tiles per warp");
static_assert(TILE + 2 * MAX_LAYERS <= 32, "a window row must fit a warp");

struct Dims {
  int cin, h, w, layers, tiles_x;
  float slope;
};

__host__ __device__ static inline int region(int halo) {
  return TILE + 2 * halo;
}

// Words (channel pairs) of one pair plane of an s x s region: at least s*s
// and 8 mod 32, so lanes (g, t) reading pixel g of pair t hit bank 8t + g.
__host__ __device__ static inline int plane(int s) {
  const int n = s * s;
  return n + (40 - n % 32) % 32;
}

// Shared-memory words: two ping-pong intermediates of F rounded up to 16
// channels, and layer 0's staged input chunk in the second one's room.
static size_t smem_words(int f, int layers) {
  const size_t fk = (size_t)((f + 15) & ~15);
  const size_t in = (size_t)(CK / 2) * plane(region(layers));
  const size_t mid = fk / 2 * plane(region(layers - 1));
  const size_t mid1 = layers > 2 ? mid : 0;
  return (layers > 1 ? mid : 0) + (in > mid1 ? in : mid1);
}

// d += a b on one m16n8k16 tile, bfloat16 operands, float32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 16-channel group over the 9 taps, for the first N of the warp's MT
// m16 tiles. `a` points at pair t of the group in a pair plane of stride cs
// and side si; off[i][r] is the plane offset of row g + 8r of tile i; `wf`
// at this lane's fragment of tap 0, n-tile 0.
template <int NT, int N>
__device__ __forceinline__ void group_taps(const uint32_t* a, int cs, int si,
                                           const int (&off)[MT][2],
                                           const uint2* __restrict__ wf,
                                           float (&acc)[MT][NT][4]) {
#pragma unroll 3
  for (int tap = 0; tap < 9; ++tap) {
    const uint32_t* at = a + (tap / 3) * si + tap % 3;
    uint32_t af[N][4];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      af[i][0] = at[off[i][0]];
      af[i][1] = at[off[i][1]];
      af[i][2] = at[4 * cs + off[i][0]];
      af[i][3] = at[4 * cs + off[i][1]];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const uint2 b = __ldg(wf + (tap * NT + j) * 32);
#pragma unroll
      for (int i = 0; i < N; ++i) mma(acc[i][j], af[i], b.x, b.y);
    }
  }
}

// group_taps for the warp's n valid tiles (1 <= n <= MT), chosen by a
// warp-uniform branch so that no mma.sync sits in divergent code.
template <int NT, int N = MT>
__device__ __forceinline__ void group_taps_n(int n, const uint32_t* a,
                                             int cs, int si,
                                             const int (&off)[MT][2],
                                             const uint2* __restrict__ wf,
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
conv_block_bf16_kernel(const unsigned short* __restrict__ x,
                       const uint32_t* __restrict__ wts,
                       const __nv_bfloat16* __restrict__ bias,
                       __nv_bfloat16* __restrict__ y, Dims d) {
  extern __shared__ uint4 smem4[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem4);
  constexpr int F = NT * 8;
  constexpr int FK = (F + 15) & ~15;   // a later layer's K, in channels
  constexpr int GROUP = 9 * NT * 64;   // words of one 16-channel group
  const int L = d.layers, H = d.h, W = d.w, Cin = d.cin;
  const int cinp = (Cin + 15) & ~15;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y;
  const int oy0 = (blockIdx.x / d.tiles_x) * TILE;
  const int ox0 = (blockIdx.x % d.tiles_x) * TILE;
  const size_t hw = (size_t)H * W;

  const int s0 = region(L), cs0 = plane(s0);
  const int cs1 = plane(region(L - 1));
  uint32_t* sbuf0 = smem;
  uint32_t* sbuf1 = sbuf0 + (L > 1 ? FK / 2 * cs1 : 0);
  uint32_t* s_in = sbuf1;

  // Layer 0's input channels [c0, c0 + nc) as pair planes over the window
  // grown by L pixels: zero outside the image and past Cin.
  auto stage_chunk = [&](int c0, int nc) {
    for (int row = warp; row < nc / 2 * s0; row += WARPS) {
      const int pc = row / s0, iy = row - pc * s0;
      const int gy = oy0 - L + iy, gx = ox0 - L + lane;
      if (lane < s0) {
        uint32_t v = 0;
        const int c = c0 + 2 * pc;
        if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
          const unsigned short* p =
              x + ((size_t)b * Cin + c) * hw + (size_t)gy * W + gx;
          if (c < Cin) v = __ldg(p);
          if (c + 1 < Cin) v |= (uint32_t)__ldg(p + hw) << 16;
        }
        s_in[pc * cs0 + iy * s0 + lane] = v;
      }
    }
  };

  const uint32_t* src = nullptr;  // a later layer's input planes and stride
  int src_cs = 0;
  const uint32_t* wl = wts;
  for (int l = 0; l < L; ++l) {
    const int halo = L - 1 - l;
    const int so = region(halo);  // output region side
    const int si = so + 2;        // input region side
    const int npix = so * so;
    const int nm = (npix + 15) / 16;
    const int kin = (l == 0) ? cinp : FK;
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
      for (int c0 = 0; c0 < kin; c0 += CK) {
        const int nc = min(CK, kin - c0);
        stage_chunk(c0, nc);
        __syncthreads();  // the chunk is in shared memory for every warp
        if (n > 0) {
          for (int grp = 0; grp < nc / 16; ++grp)
            group_taps_n<NT>(
                n, s_in + (grp * 8 + t) * cs0, cs0, si, off,
                reinterpret_cast<const uint2*>(
                    wl + (size_t)(c0 / 16 + grp) * GROUP) + lane,
                acc);
        }
        __syncthreads();  // the chunk may be overwritten
      }
    } else if (n > 0) {
      for (int grp = 0; grp < FK / 16; ++grp)
        group_taps_n<NT>(n, src + (grp * 8 + t) * src_cs, src_cs, si, off,
                         reinterpret_cast<const uint2*>(
                             wl + (size_t)grp * GROUP) + lane,
                         acc);
    }
    wl += (size_t)(kin / 16) * GROUP;

    // Bias and LeakyReLU in float32, then bfloat16: the last layer to y,
    // the others to shared memory with the pixels outside the image zeroed.
    const int cs_out = plane(so);
    const __nv_bfloat16* bl = bias + l * F;
    uint32_t* dst = (l % 2 == 0) ? sbuf0 : sbuf1;
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
        for (int j = 0; j < NT; ++j) {
          const int co = j * 8 + 2 * t;
          float v0 = acc[i][j][2 * r] + __bfloat162float(bl[co]);
          float v1 = acc[i][j][2 * r + 1] + __bfloat162float(bl[co + 1]);
          v0 = v0 >= 0.f ? v0 : d.slope * v0;
          v1 = v1 >= 0.f ? v1 : d.slope * v1;
          const __nv_bfloat162 h2 = __floats2bfloat162_rn(v0, v1);
          if (last) {
            if (inside) {
              const size_t o = ((size_t)b * F + co) * hw
                  + (size_t)gy * W + gx;
              y[o] = h2.x;
              y[o + hw] = h2.y;
            }
          } else {
            dst[(j * 4 + t) * cs_out + p] =
                inside ? *reinterpret_cast<const uint32_t*>(&h2) : 0u;
          }
        }
      }
    }
    // F not a multiple of 16: the pad pairs a later layer's k16 steps read
    // are zeroed each time (the second intermediate shares its room with
    // layer 0's staged input).
    if (!last && FK != F) {
      for (int i = tid; i < (FK - F) / 2 * npix; i += THREADS)
        dst[(F / 2 + i / npix) * cs_out + i % npix] = 0u;
    }
    __syncthreads();  // dst is complete before the next layer reads it
    src = dst;
    src_cs = cs_out;
  }
}

template <int NT>
static int launch(const void* x, const void* w, const void* b, void* y,
                  int batch, size_t smem, const Dims& d,
                  cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      conv_block_bf16_kernel<NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles_y = (d.h + TILE - 1) / TILE;
  dim3 grid(d.tiles_x * tiles_y, batch);
  conv_block_bf16_kernel<NT><<<grid, THREADS, smem, stream>>>(
      (const unsigned short*)x, (const uint32_t*)w,
      (const __nv_bfloat16*)b, (__nv_bfloat16*)y, d);
  return (int)cudaGetLastError();
}

// `w` is the packed fragment buffer (PackedConvBlock.tc_weights, bfloat16).
extern "C" int conv_block_bf16_launch(const void* x, const void* w,
                                      const void* b, void* y, int batch,
                                      int cin, int h, int w_, int f,
                                      int layers, float slope,
                                      void* stream) {
  if (f % 8 != 0 || f <= 0 || f > 32 || layers < 1 || layers > MAX_LAYERS
      || cin < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_words(f, layers) * sizeof(uint32_t);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (batch == 0 || h == 0 || w_ == 0) return 0;
  Dims d;
  d.cin = cin;
  d.h = h;
  d.w = w_;
  d.layers = layers;
  d.tiles_x = (w_ + TILE - 1) / TILE;
  d.slope = slope;
  cudaStream_t s = (cudaStream_t)stream;
  switch (f / 8) {
    case 1: return launch<1>(x, w, b, y, batch, smem, d, s);
    case 2: return launch<2>(x, w, b, y, batch, smem, d, s);
    case 3: return launch<3>(x, w, b, y, batch, smem, d, s);
    default: return launch<4>(x, w, b, y, batch, smem, d, s);
  }
}
