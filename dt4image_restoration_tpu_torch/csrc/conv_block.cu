// K1: a whole U-Net ConvBlock, L x [3x3 SAME conv + bias + LeakyReLU], in
// one kernel whose inter-layer activations never leave shared memory.
//
// Replaces the TPU kernel fused_conv_block
// (dt4image_restoration_tpu/ops/pallas/conv_block.py). It computes the same
// function but none of the TPU layout: no space-to-depth packing, no
// 128-lane channel pad, no full-width row tiles.
//
// Layout: x is NCHW float32 (B, Cin, H, W); y is NCHW (B, F, H, W). The
// weights of all layers are one flat buffer, layer 0 as [Cin][3][3][F] and
// every later layer as [F][3][3][F]; biases are [L][F].
//
// Tiling: one thread block computes a TILE x TILE output tile of one image.
// Layer l (0-based) is computed on the tile grown by a halo of L-1-l pixels,
// so the last layer needs nothing outside the block (the halo is
// recomputed by the neighbouring tiles). Layer 0 reads a window grown by L
// pixels, zero outside the image; its input channels are streamed through
// shared memory CK at a time, with the matching weight slice. After every
// intermediate layer the pixels that lie outside the image are set to zero,
// which gives the next layer SAME-padding semantics.
//
// Work split: each thread computes PX pixels x CO output channels of a
// layer, reading each input value from shared memory once per tap and each
// weight as two broadcast float4 loads shared by its PX pixels.
//
// Bound on the H100: arithmetic. At the U-Net's 128x128 blocks the chain is
// 0.6 (inc) and 1.5 (up4) GFLOP per image against a few MB of traffic; the
// fusion removes the two intermediate round trips through device memory.
// This first version runs on the float32 CUDA cores (67 TFLOP/s peak), not
// the tensor cores, and recomputes the halos (about 1.5x the flops at
// TILE 16, L 3).
#include <cuda_runtime.h>

#define TILE 16
#define PX 4
#define CO 8
#define CK 16
#define THREADS 512
#define MAX_SMEM 232448

struct Dims {
  int cin, h, w, f, layers, tiles_x;
  float slope;
};

// Side of the square region a layer works on, for a halo of `halo` pixels.
__host__ __device__ static inline int region(int halo) {
  return TILE + 2 * halo;
}

static size_t smem_floats(int f, int layers) {
  int s0 = region(layers);
  int s1 = region(layers - 1);
  size_t w = (size_t)9 * f * (CK > f ? CK : f);
  size_t in = (size_t)CK * s0 * s0;
  size_t mid = layers > 1 ? (size_t)2 * f * s1 * s1 : 0;
  return w + in + mid;
}

__global__ void __launch_bounds__(THREADS)
conv_block_kernel(const float* __restrict__ x, const float* __restrict__ wts,
                  const float* __restrict__ bias, float* __restrict__ y,
                  Dims d) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int L = d.layers, F = d.f, H = d.h, W = d.w, Cin = d.cin;
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int oy0 = (blockIdx.x / d.tiles_x) * TILE;
  const int ox0 = (blockIdx.x % d.tiles_x) * TILE;

  // Shared memory: the weight slice, the layer-0 input chunk, then two
  // ping-pong intermediates of F channels each.
  const int s0 = region(L);
  const int s1 = region(L - 1);
  float* sw = smem;
  float* s_in = sw + 9 * F * (CK > F ? CK : F);
  float* sbuf0 = s_in + CK * s0 * s0;
  float* sbuf1 = sbuf0 + F * s1 * s1;

  const float* src = s_in;
  for (int l = 0; l < L; ++l) {
    const int halo = L - 1 - l;
    const int so = region(halo);  // output region side
    const int si = so + 2;           // input region side
    const int kin = (l == 0) ? Cin : F;
    const int chunk = (l == 0) ? CK : F;
    const float* wl = (l == 0) ? wts
        : wts + (size_t)Cin * 9 * F + (size_t)(l - 1) * 9 * F * F;
    const float* bl = bias + l * F;
    const bool last = (l == L - 1);
    float* dst = (l % 2 == 0) ? sbuf0 : sbuf1;
    const int npix = so * so;
    const int npg = (npix + PX - 1) / PX;
    const int nitems = npg * (F / CO);
    const int gy0 = oy0 - halo, gx0 = ox0 - halo;

    for (int base = 0; base < nitems; base += THREADS) {
      const int item = base + tid;
      const bool active = item < nitems;
      const int pg = active ? item % npg : 0;
      const int cg = active ? item / npg : 0;
      int off[PX];
      bool pv[PX];
#pragma unroll
      for (int k = 0; k < PX; ++k) {
        const int p = pg + k * npg;
        pv[k] = active && p < npix;
        const int pp = pv[k] ? p : 0;
        off[k] = (pp / so) * si + (pp % so);
      }
      float acc[PX][CO];
#pragma unroll
      for (int k = 0; k < PX; ++k)
#pragma unroll
        for (int c = 0; c < CO; ++c) acc[k][c] = 0.f;

      for (int c0 = 0; c0 < kin; c0 += chunk) {
        const int nc = min(chunk, kin - c0);
        __syncthreads();  // earlier readers of sw / s_in are done
        const float* wsrc = wl + (size_t)c0 * 9 * F;
        for (int i = tid; i < nc * 9 * F; i += THREADS) sw[i] = wsrc[i];
        if (l == 0) {
          const int area = si * si;
          for (int i = tid; i < nc * area; i += THREADS) {
            const int cc = i / area;
            const int p = i - cc * area;
            const int iy = p / si, ix = p - iy * si;
            const int gy = oy0 - L + iy, gx = ox0 - L + ix;
            float v = 0.f;
            if (gy >= 0 && gy < H && gx >= 0 && gx < W)
              v = x[(((size_t)b * Cin + c0 + cc) * H + gy) * W + gx];
            s_in[i] = v;
          }
        }
        __syncthreads();
        if (active) {
          for (int cc = 0; cc < nc; ++cc) {
            const float* sc = src + (size_t)cc * si * si;
            const float* wc = sw + cc * 9 * F + cg * CO;
#pragma unroll
            for (int tap = 0; tap < 9; ++tap) {
              const int dy = tap / 3, dx = tap % 3;
              const float4 w0 = *reinterpret_cast<const float4*>(wc + tap * F);
              const float4 w1 =
                  *reinterpret_cast<const float4*>(wc + tap * F + 4);
#pragma unroll
              for (int k = 0; k < PX; ++k) {
                const float v = sc[off[k] + dy * si + dx];
                acc[k][0] = fmaf(v, w0.x, acc[k][0]);
                acc[k][1] = fmaf(v, w0.y, acc[k][1]);
                acc[k][2] = fmaf(v, w0.z, acc[k][2]);
                acc[k][3] = fmaf(v, w0.w, acc[k][3]);
                acc[k][4] = fmaf(v, w1.x, acc[k][4]);
                acc[k][5] = fmaf(v, w1.y, acc[k][5]);
                acc[k][6] = fmaf(v, w1.z, acc[k][6]);
                acc[k][7] = fmaf(v, w1.w, acc[k][7]);
              }
            }
          }
        }
      }

      if (active) {
#pragma unroll
        for (int k = 0; k < PX; ++k) {
          if (!pv[k]) continue;
          const int p = pg + k * npg;
          const int gy = gy0 + p / so, gx = gx0 + p % so;
          const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
          for (int c = 0; c < CO; ++c) {
            const int co = cg * CO + c;
            float v = acc[k][c] + bl[co];
            v = v >= 0.f ? v : d.slope * v;
            if (last) {
              if (inside) y[(((size_t)b * F + co) * H + gy) * W + gx] = v;
            } else {
              dst[co * npix + p] = inside ? v : 0.f;
            }
          }
        }
      }
    }
    __syncthreads();  // dst is complete before the next layer reads it
    src = dst;
  }
}

extern "C" int conv_block_launch(const void* x, const void* w, const void* b,
                                 void* y, int batch, int cin, int h, int w_,
                                 int f, int layers, float slope,
                                 void* stream) {
  if (f % CO != 0 || f <= 0 || layers < 1 || cin < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  size_t smem = smem_floats(f, layers) * sizeof(float);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (batch == 0 || h == 0 || w_ == 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      conv_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  Dims d;
  d.cin = cin;
  d.h = h;
  d.w = w_;
  d.f = f;
  d.layers = layers;
  d.tiles_x = (w_ + TILE - 1) / TILE;
  d.slope = slope;
  const int tiles_y = (h + TILE - 1) / TILE;
  dim3 grid(d.tiles_x * tiles_y, batch);
  conv_block_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)b, (float*)y, d);
  return (int)cudaGetLastError();
}
