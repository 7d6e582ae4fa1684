// K6: the U-Net decoder's 2x bilinear upsampling (align_corners=True),
// pad-to-match and [skip, up] concat, written in one pass.
//
// Replaces no TPU kernel: the JAX package upsamples with two XLA matmuls
// (dt4image_restoration_tpu/ops/image.py:bilinear_upsample_2x). On the H100
// the port first ran F.interpolate, which launches PyTorch's NCHW
// upsample_bilinear2d_out_frame (one thread per output pixel, looping over
// every batch and channel inside the thread, so a 16x16 output runs on 256
// threads however large the batch), and then torch.cat, which read the
// upsampled tensor back and wrote it again. For skip (B, Cs, Hs, Ws) and a
// (B, Ca, Ha, Wa) this kernel writes
//
//     out = cat([skip, pad(upsample_2x(a), skip)], dim=1)
//         (B, Cs + Ca, Hs, Ws), NCHW
//
// with the upsampled image (2 Ha, 2 Wa) placed at (top, left) =
// (dy // 2, dx // 2) inside a zero border, dy = Hs - 2 Ha, dx = Ws - 2 Wa
// (floor division, taken by the caller; a negative difference crops, as
// F.pad does).
//
// Bound on the H100: memory traffic. Per output element it reads one skip
// element or a quarter of an input element and does ~10 flops. The work is
// split by output rows: block x is one (batch, channel) plane, and each
// thread writes VEC consecutive elements of one row, so the parallelism
// grows with batch x channels x rows. Skip rows are a copy; upsampled rows
// blend two source rows, whose re-reads (each input element serves about
// four outputs) hit L1 through the read-only path. Where Ws is a multiple
// of VEC and both row bases are aligned, every thread loads and stores one
// 16-byte (float32) or 8-byte (bfloat16) vector; otherwise it moves its
// elements one by one.
//
// Arithmetic: PyTorch's upsample_bilinear2d_out_frame, step for step, so
// the output equals F.interpolate's: the scale (Ha - 1) / (2 Ha - 1) in
// float32 on the host, the source index scale * h2 and its fraction
// rounded as separate operations, the blend
//     l_h0 (l_w0 x00 + l_w1 x01) + l_h1 (l_w0 x10 + l_w1 x11)
// accumulated in float32 with PyTorch's FMA contraction (blend below) and,
// for bfloat16, rounded once to nearest even.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define VEC 4          // consecutive outputs of a row a thread writes
#define THREADS 256    // threads of a block, at most

template <typename T>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_float(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

// p * x + q * y as PyTorch's build of upsample_bilinear2d_out_frame
// contracts it: the first product fused into an FMA with the second. Left
// to nvcc, this kernel's float32 build contracted otherwise, and 12 % of
// the outputs differed from F.interpolate's in the last bit.
__device__ __forceinline__ float blend(float p, float x, float q, float y) {
  return __fmaf_rn(p, x, __fmul_rn(q, y));
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(THREADS) upsample_concat_kernel(
    const T* __restrict__ a, const T* __restrict__ skip, T* __restrict__ out,
    int cs, int ca, int ha, int wa, int hs, int ws, int top, int left,
    float rh, float rw, int row_threads) {
  const int planes = cs + ca;
  const int nc = blockIdx.x;  // n * (cs + ca) + c
  const int n = nc / planes;
  const int c = nc - n * planes;
  const int t = blockIdx.y * blockDim.x + threadIdx.x;
  const int y = t / row_threads;
  if (y >= hs) return;
  const int x0 = (t - y * row_threads) * VEC;
  T* orow = out + ((long long)nc * hs + y) * ws;

  if (c < cs) {  // the skip half: a copy
    const T* srow = skip + (((long long)n * cs + c) * hs + y) * ws;
    if (kVec) {
      *reinterpret_cast<Pack<T>*>(orow + x0) =
          *reinterpret_cast<const Pack<T>*>(srow + x0);
    } else {
      for (int i = 0; i < VEC && x0 + i < ws; ++i) orow[x0 + i] = srow[x0 + i];
    }
    return;
  }

  Pack<T> p;
  const int hu = 2 * ha, wu = 2 * wa;
  const int u = y - top;  // row of the upsampled image
  if (u < 0 || u >= hu) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) from_float(0.0f, &p.v[i]);
  } else {
    const float h1r = __fmul_rn(rh, (float)u);
    const int h1 = (int)h1r;
    const int h1p = (h1 < ha - 1) ? 1 : 0;
    const float h1l = __fsub_rn(h1r, (float)h1);
    const float h0l = __fsub_rn(1.0f, h1l);
    const T* r0 = a + (((long long)n * ca + (c - cs)) * ha + h1) * wa;
    const T* r1 = r0 + h1p * wa;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int v = x0 + i - left;  // column of the upsampled image
      float val = 0.0f;
      if (v >= 0 && v < wu) {
        const float w1r = __fmul_rn(rw, (float)v);
        const int w1 = (int)w1r;
        const int w1p = (w1 < wa - 1) ? 1 : 0;
        const float w1l = __fsub_rn(w1r, (float)w1);
        const float w0l = __fsub_rn(1.0f, w1l);
        val = blend(h0l, blend(w0l, to_float(__ldg(r0 + w1)), w1l,
                               to_float(__ldg(r0 + w1 + w1p))),
                    h1l, blend(w0l, to_float(__ldg(r1 + w1)), w1l,
                               to_float(__ldg(r1 + w1 + w1p))));
      }
      from_float(val, &p.v[i]);
    }
  }
  if (kVec) {
    *reinterpret_cast<Pack<T>*>(orow + x0) = p;
  } else {
    for (int i = 0; i < VEC && x0 + i < ws; ++i) orow[x0 + i] = p.v[i];
  }
}

template <typename T>
static int launch(const void* a, const void* skip, void* out, int b, int cs,
                  int ca, int ha, int wa, int hs, int ws, int top, int left,
                  cudaStream_t stream) {
  // align_corners=True: (in - 1) / (out - 1) in float32, 0 for one output.
  const float rh = 2 * ha > 1 ? (float)(ha - 1) / (2 * ha - 1) : 0.0f;
  const float rw = 2 * wa > 1 ? (float)(wa - 1) / (2 * wa - 1) : 0.0f;
  const int row_threads = (ws + VEC - 1) / VEC;
  const long long plane_threads = (long long)hs * row_threads;
  const int threads =
      plane_threads >= THREADS ? THREADS : (int)((plane_threads + 31) / 32 * 32);
  const long long blocks_y = (plane_threads + threads - 1) / threads;
  const long long planes = (long long)b * (cs + ca);
  if (blocks_y > 65535 || planes > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)planes, (unsigned)blocks_y);
  const uintptr_t align = sizeof(T) * VEC;
  const bool vec = ws % VEC == 0 && (uintptr_t)skip % align == 0 &&
                   (uintptr_t)out % align == 0;
  if (vec) {
    upsample_concat_kernel<T, true><<<grid, threads, 0, stream>>>(
        (const T*)a, (const T*)skip, (T*)out, cs, ca, ha, wa, hs, ws, top,
        left, rh, rw, row_threads);
  } else {
    upsample_concat_kernel<T, false><<<grid, threads, 0, stream>>>(
        (const T*)a, (const T*)skip, (T*)out, cs, ca, ha, wa, hs, ws, top,
        left, rh, rw, row_threads);
  }
  return (int)cudaGetLastError();
}

// dtype: 0 float32, 1 bfloat16. Every size positive; a, skip and out
// contiguous NCHW on the current device.
extern "C" int upsample_concat_launch(const void* a, const void* skip,
                                      void* out, int dtype, int b, int cs,
                                      int ca, int ha, int wa, int hs, int ws,
                                      int top, int left, void* stream) {
  if (dtype == 0)
    return launch<float>(a, skip, out, b, cs, ca, ha, wa, hs, ws, top, left,
                         (cudaStream_t)stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, skip, out, b, cs, ca, ha, wa, hs, ws, top,
                                 left, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
