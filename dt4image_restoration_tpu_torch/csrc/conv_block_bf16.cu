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
// Bound on the H100: tensor-core operations at the dense bfloat16 rate.
// Each layer is an implicit GEMM, M = pixels, N = F, K = 9 taps x input
// channels. What the design does:
//  * Persistent blocks, one an SM, walk the work items (image, 16 x 16
//    output tile) as item = block + k x grid. Layer l is computed on the
//    tile grown by a halo of L-1-l pixels, so the last layer needs nothing
//    outside the block; pixels outside the image are zeroed after every
//    intermediate layer (SAME padding for the next).
//  * The products are wgmma.mma_async m64nFk16 (bf16 in, f32 out) with
//    both operands read from shared memory by descriptor. With N = F <= 32
//    every k16 step reads its whole A tile once, through registers or
//    not, so A by descriptor costs the same shared-memory traffic as A in
//    registers and spends no load instructions, registers or fences on
//    it. Activations are K-major: per 8-channel plane, one 16-byte row a
//    pixel (the canonical no-swizzle layout: 8-row core matrices of 128
//    contiguous bytes, SBO 128 bytes, LBO one plane). A layer whose input
//    region is si pixels wide numbers its output pixel (oy, ox) as row
//    m = oy si + ox, so tap (ky, kx) is the A tile shifted by
//    ky si + kx whole rows: a 16-byte aligned descriptor. Rows with
//    ox >= si - 2 are computed and dropped (7, 6 and 5 m64 tiles for the
//    three layers of a 16 x 16 tile with L = 3).
//  * The weights are packed once by the wrapper
//    (ops/kernels/conv_block_bf16.py:wgmma_weights) as the B operand of
//    each k16 step, K-major (8 x 8 core matrices; LBO F x 16 bytes, SBO
//    128) and copied into shared memory once per block by one bulk copy
//    (cp.async.bulk on an mbarrier). Where layer 0's weights do not fit
//    beside the rest (Cin > 160 at F = 32, L = 3) they travel with each
//    input chunk instead, by a bulk copy into its ring stage.
//  * Warp specialisation: two producer warpgroups fill a ring of stages,
//    each 16 input channels of one item's input window, under full/empty
//    mbarriers, running ahead into the next items while two consumer
//    warpgroups run the products. A producer thread reads 8 channels x 8
//    pixels with eight 16-byte loads, issued before its stage is free,
//    transposes them in registers (byte permutes) and writes eight 16-byte
//    pixel rows; where W % 8 != 0 it reads element by element. The ring
//    holds at least two stages: a consumer releases a stage once the next
//    chunk's products have been issued.
//  * Both consumer warpgroups take the same number of a layer's m64 tiles
//    (every other one; with an odd count one warpgroup's last tile reads
//    the layer's last rows again and its epilogue drops them). The count
//    then depends on the layer alone: a wgmma under a condition that
//    depends on the thread is serialized by the compiler.
//  * Epilogue in registers: bias and LeakyReLU in float32, two channels
//    rounded together (__floats2bfloat162_rn) into one 32-bit word of the
//    next layer's pixel row, the image-edge test only in tiles whose grown
//    region reaches the edge; the last layer goes through a shared-memory
//    tile to 16-byte stores of NCHW rows. A named barrier of the consumers
//    closes every layer.
//
// Layout: x is NCHW bfloat16 (B, Cin, H, W); y is NCHW bfloat16
// (B, F, H, W); biases are bfloat16 [L][F]. The launch plan (grid, ring
// stages, shared-memory map) is computed by the wrapper
// (ops/kernels/conv_block_bf16.py:plan) and passed as the Plan struct.
//
// Breakdown builds (perf/conv_block_bf16_parts.py): each STRIP_ macro,
// off by default, strips one part and keeps the rest of the work:
// STRIP_INPUT the producers' loads of the input (zeros instead),
// STRIP_PRODUCTS the wgmma products, STRIP_STORES the output's stores to
// device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define TILE 16
#define MAX_LAYERS 4
#define MAX_STAGES 8
#define PRODUCERS 2                 // producer warpgroups
#define CONSUMERS 2                 // consumer warpgroups
#define THREADS ((PRODUCERS + CONSUMERS) * 128)
// m64 tiles of a layer per consumer: 9 at most (L = 4, layer 0).
#define MAX_TILES ((9 + CONSUMERS - 1) / CONSUMERS)
static_assert(MAX_TILES == 5, "products dispatches 1 to 5 tiles");
#define OUT_STRIDE (TILE * TILE + 8)  // bf16 of one channel's output tile
#define MAX_SMEM 232448
#define CONSUMER_BARRIER 1          // named barrier of the consumers
#define BIAS_AT 256                 // the biases' offset past the barriers

// The order of ops/kernels/conv_block_bf16.py:PLAN_FIELDS.
struct Plan {
  int batch, cin, h, w, layers;
  int tiles_x, tiles, items;
  int chunks, stages, resident, vec;
  int w_bytes, w0_bytes;
  int stage_plane, stage_bytes;
  int mid_plane0, mid_plane1;
  int off_w, off_ring, off_mid0, off_mid1, off_out, off_bar, smem;
};
#define PLAN_INTS 25
static_assert(sizeof(Plan) == PLAN_INTS * sizeof(int), "Plan is ints");

// Layer l's geometry: input region side si, output side so, output rows
// (at row stride si) and m64 tiles.
struct Geometry {
  int si, so, rows, tiles;
};
__device__ __forceinline__ Geometry geometry(int layers, int l) {
  Geometry g;
  g.so = TILE + 2 * (layers - 1 - l);
  g.si = g.so + 2;
  g.rows = (g.so - 1) * g.si + g.so;
  g.tiles = (g.rows + 63) / 64;
  return g;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred done;\n WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT;\n}" ::"r"(bar), "r"(parity)
      : "memory");
}

// Arrive on `bar` expecting `bytes`, and copy them from global to shared
// memory with the copy engine in pieces of at most 32 KB; the barrier's
// phase completes when they have landed.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const uint8_t* src,
                                          int bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
  for (int o = 0; o < bytes; o += 32768) {
    const int n = min(32768, bytes - o);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(dst + o), "l"(src + o), "r"(n),
        "r"(bar) : "memory");
  }
}

// Shared-memory writes of this thread become visible to wgmma (the async
// proxy) once a barrier orders them.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync %0, %1;" ::"n"(CONSUMER_BARRIER),
               "n"(CONSUMERS * 128) : "memory");
}

// A wgmma descriptor of a K-major operand without swizzle at shared
// address `addr`: 8-row core matrices of 128 contiguous bytes, the next 8
// rows 128 bytes on (SBO), the second 8 of the 16 k 'lbo' bytes on (LBO).
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16)
         | ((uint64_t)(128 >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += a b on one m64 x 8NT x k16 tile: bf16 operands by descriptor,
// float32 accumulators (thread (warp w, lane 4g + t) holds rows 16w + g
// and 16w + g + 8, columns 8j + 2t and 8j + 2t + 1 in d[4j .. 4j + 3]).
template <int NT>
__device__ __forceinline__ void wgmma(float (&d)[NT * 4], uint64_t a,
                                      uint64_t b);
template <>
__device__ __forceinline__ void wgmma<1>(float (&d)[4], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %6, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<2>(float (&d)[8], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<3>(float (&d)[12], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %14, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "%12, %13, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<4>(float (&d)[16], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ uint4 load16(const uint16_t* p) {
#ifdef STRIP_INPUT
  return make_uint4(0u, 0u, 0u, 0u);
#else
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
#endif
}

__device__ __forceinline__ uint32_t load2(const uint16_t* p) {
#ifdef STRIP_INPUT
  return 0u;
#else
  return __ldg(p);
#endif
}

__device__ __forceinline__ void store16(uint32_t addr, uint32_t a,
                                        uint32_t b, uint32_t c, uint32_t d) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "r"(a), "r"(b), "r"(c), "r"(d) : "memory");
}

// One task of a chunk where W % 8 == 0: window row iy, 8-pixel segment seg
// (from the 8-aligned column at or left of the window's first), 8-channel
// group cg of the chunk's 16 channels [c0, c0 + 16): eight 16-byte loads,
// one a channel; zero outside the image and past Cin.
struct Segment {
  uint4 v[8];
};

__device__ __forceinline__ void load_segment(Segment& s, const uint16_t* x,
                                             const Plan& p, int b, int c0,
                                             int gy, int gx) {
  const bool in = gy >= 0 && gy < p.h && gx >= 0 && gx < p.w;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int c = c0 + k;
    s.v[k] = make_uint4(0u, 0u, 0u, 0u);
    if (in && c < p.cin)
      s.v[k] = load16(x + (((size_t)b * p.cin + c) * p.h + gy) * p.w + gx);
  }
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The segment's pixels that fall in the window (columns [0, s0) from gx0)
// as 16-byte pixel rows of plane `plane` (row iy of the window): pixel px
// takes channel pairs (2j, 2j + 1), the even channel in the low half.
__device__ __forceinline__ void store_segment(const Segment& s,
                                              uint32_t plane, int iy,
                                              int s0, int gx, int gx0) {
#pragma unroll
  for (int px = 0; px < 8; ++px) {
    const int ix = gx + px - gx0;
    if (ix < 0 || ix >= s0) continue;
    const uint32_t sel = (px & 1) ? 0x7632 : 0x5410;
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = __byte_perm(word(s.v[2 * j], px >> 1),
                         word(s.v[2 * j + 1], px >> 1), sel);
    store16(plane + (uint32_t)(iy * s0 + ix) * 16, w[0], w[1], w[2], w[3]);
  }
}

// k16 steps [0, steps) into N m64 tiles: tile i's A starts at a[i] (in
// 16-byte rows); step k is 16-channel group k / 9 (2 planes of `plane16`
// rows on) at tap k % 9 (ky si + kx rows on), and B step k.
template <int NT, int N>
__device__ __forceinline__ void steps_n(float (&acc)[MAX_TILES][NT * 4],
                                        const uint64_t (&a)[MAX_TILES],
                                        uint64_t b, int si, int steps,
                                        uint32_t plane16) {
  constexpr uint32_t STEP16 = NT * 8 * 32 / 16;
#pragma unroll 1
  for (int k = 0; k < steps; ++k) {
    const int grp = k / 9, tap = k - 9 * grp;
    const uint32_t shift = grp * 2 * plane16 + (tap / 3) * si + tap % 3;
#pragma unroll
    for (int i = 0; i < N; ++i)
      wgmma<NT>(acc[i], a[i] + shift, b + k * STEP16);
  }
}

// One consumer warpgroup's products of a run of k16 steps into its n m64
// tiles, committed as one group. n is the same for both warpgroups (a
// warpgroup whose last tile is past the layer's reads the layer's last
// tile again, and its epilogue drops those rows), so it depends on the
// layer alone: a wgmma under a condition that depends on the thread is
// serialized by the compiler. Each count has a loop of its own, with no
// branch between its wgmmas.
template <int NT>
__device__ __forceinline__ void products(int n,
                                         float (&acc)[MAX_TILES][NT * 4],
                                         const uint64_t (&a)[MAX_TILES],
                                         uint64_t b, int si, int steps,
                                         uint32_t plane16) {
#pragma unroll
  for (int i = 0; i < MAX_TILES; ++i) pin(acc[i]);
  wg_fence();
#ifndef STRIP_PRODUCTS
  switch (n) {
    case 1: steps_n<NT, 1>(acc, a, b, si, steps, plane16); break;
    case 2: steps_n<NT, 2>(acc, a, b, si, steps, plane16); break;
    case 3: steps_n<NT, 3>(acc, a, b, si, steps, plane16); break;
    case 4: steps_n<NT, 4>(acc, a, b, si, steps, plane16); break;
    default: steps_n<NT, 5>(acc, a, b, si, steps, plane16); break;
  }
#endif
  wg_commit();
#pragma unroll
  for (int i = 0; i < MAX_TILES; ++i) pin(acc[i]);
}

template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
conv_block_bf16_kernel(const uint16_t* __restrict__ x,
                       const uint8_t* __restrict__ wts,
                       const __nv_bfloat16* __restrict__ bias,
                       __nv_bfloat16* __restrict__ y, const Plan p,
                       float slope) {
  constexpr int F = NT * 8;
  constexpr int FK = (F + 15) & ~15;     // a later layer's K, in channels
  constexpr int W0_CHUNK = 9 * F * 32;   // layer 0's B of one chunk
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + p.off_bar;          // [MAX_STAGES] mbarriers
  const uint32_t empty = full + 8 * MAX_STAGES;    // [MAX_STAGES]
  const uint32_t wbar = empty + 8 * MAX_STAGES;
  const int tid = threadIdx.x;
  // The warpgroup, broadcast from lane 0 so that the compiler treats what
  // depends on it as uniform over the warp.
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int L = p.layers;
  const Geometry g0 = geometry(L, 0);
  const int s0 = g0.si;                  // layer 0's input window side

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + 8 * s, 4 + (p.resident ? 0 : 1));
      mbar_init(empty + 8 * s, CONSUMERS * 4);
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // F not a multiple of 16: the pad planes of the intermediates, which a
  // later layer's k16 steps read and no epilogue writes, are zero.
  if (FK != F) {
    for (int i = tid; i < p.mid_plane0 / 16; i += THREADS)
      store16(base + p.off_mid0 + (F / 8) * p.mid_plane0 + 16 * i, 0u, 0u,
              0u, 0u);
    for (int i = tid; i < p.mid_plane1 / 16; i += THREADS)
      store16(base + p.off_mid1 + (F / 8) * p.mid_plane1 + 16 * i, 0u, 0u,
              0u, 0u);
    fence_async_shared();
  }
  // The biases as float32 pairs, after the barriers.
  float2* const s_bias = reinterpret_cast<float2*>(smem + p.off_bar + BIAS_AT);
  for (int i = tid; i < L * F / 2; i += THREADS)
    s_bias[i] = __bfloat1622float2(
        reinterpret_cast<const __nv_bfloat162*>(bias)[i]);
  __syncthreads();
  if (tid == 0)
    bulk_copy(base + p.off_w, wts + (p.resident ? 0 : p.w0_bytes),
              p.w_bytes, wbar);

  if (wg < PRODUCERS) {
    // ---- producers: chunk `it` of the block's sequence goes to
    // producer warpgroup it % PRODUCERS, into stage it % stages.
    const int ptid = tid & 127;
    int it = 0;
    for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
      const int b = item / p.tiles, tile = item - b * p.tiles;
      const int gy0 = (tile / p.tiles_x) * TILE - L;
      const int gx0 = (tile % p.tiles_x) * TILE - L;
      for (int c = 0; c < p.chunks; ++c, ++it) {
        if (it % PRODUCERS != wg) continue;
        const int s = it % p.stages;
        const uint32_t stage = base + p.off_ring + s * p.stage_bytes;
        const uint32_t par = ((it / p.stages) & 1) ^ 1;
        if (p.vec) {
          // s0 rows x 4 segments x 2 channel groups <= 192 tasks: this
          // thread's two (of 128 threads), loaded before the stage is
          // free.
          const int xs = gx0 & ~7;
          const int n = s0 * 8;
          Segment sa, sb;
          const int ta = ptid, tb = ptid + 128;
          if (ta < n)
            load_segment(sa, x, p, b, 16 * c + 8 * (ta & 1),
                         gy0 + (ta >> 3), xs + 8 * ((ta >> 1) & 3));
          if (tb < n)
            load_segment(sb, x, p, b, 16 * c + 8 * (tb & 1),
                         gy0 + (tb >> 3), xs + 8 * ((tb >> 1) & 3));
          mbar_wait(empty + 8 * s, par);
          if (!p.resident && ptid == 0)
            bulk_copy(stage + 2 * p.stage_plane, wts + c * W0_CHUNK,
                      W0_CHUNK, full + 8 * s);
          if (ta < n)
            store_segment(sa, stage + (ta & 1) * p.stage_plane, ta >> 3,
                          s0, xs + 8 * ((ta >> 1) & 3), gx0);
          if (tb < n)
            store_segment(sb, stage + (tb & 1) * p.stage_plane, tb >> 3,
                          s0, xs + 8 * ((tb >> 1) & 3), gx0);
        } else {
          mbar_wait(empty + 8 * s, par);
          if (!p.resident && ptid == 0)
            bulk_copy(stage + 2 * p.stage_plane, wts + c * W0_CHUNK,
                      W0_CHUNK, full + 8 * s);
          const size_t hw = (size_t)p.h * p.w;
          for (int task = ptid; task < 2 * s0 * s0; task += 128) {
            const int cg = task & 1, q = task >> 1;
            const int gy = gy0 + q / s0, gx = gx0 + q % s0;
            const bool in = gy >= 0 && gy < p.h && gx >= 0 && gx < p.w;
            const uint16_t* px = x + ((size_t)b * p.cin) * hw
                                 + (in ? (size_t)gy * p.w + gx : 0);
            uint32_t w[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int ch = 16 * c + 8 * cg + 2 * j;
              const uint32_t lo =
                  in && ch < p.cin ? load2(px + ch * hw) : 0u;
              const uint32_t hi =
                  in && ch + 1 < p.cin ? load2(px + (ch + 1) * hw) : 0u;
              w[j] = lo | hi << 16;
            }
            store16(stage + cg * p.stage_plane + 16 * q, w[0], w[1], w[2],
                    w[3]);
          }
        }
        fence_async_shared();
        __syncwarp();
        if ((tid & 31) == 0) mbar_arrive(full + 8 * s);  // one a warp
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw takes the m64 tiles cw, cw + 2, ...
  constexpr int STEP = F * 32;           // bytes of B a k16 step
  const int cw = wg - PRODUCERS, ctid = tid - PRODUCERS * 128;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t w_base = base + p.off_w;
  // Layer l >= 1's B in the resident weights.
  const uint32_t w_later = w_base + (p.resident ? p.w0_bytes : 0);
  const uint32_t out_tile = base + p.off_out;
  mbar_wait(wbar, 0);
  int it = 0;
  for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
    const int b = item / p.tiles, tile = item - b * p.tiles;
    const int oy0 = (tile / p.tiles_x) * TILE, ox0 = (tile % p.tiles_x) * TILE;
    for (int l = 0; l < L; ++l) {
      const Geometry ge = geometry(L, l);
      // Tiles of each warpgroup; tile i of this one is the layer's tile
      // CONSUMERS i + cw. Its A rows:
      const int n = (ge.tiles + CONSUMERS - 1) / CONSUMERS;
      uint32_t rows[MAX_TILES];
#pragma unroll
      for (int i = 0; i < MAX_TILES; ++i)
        rows[i] = 64 * min(CONSUMERS * i + cw, ge.tiles - 1);
      float acc[MAX_TILES][NT * 4];
#pragma unroll
      for (int i = 0; i < MAX_TILES; ++i)
#pragma unroll
        for (int k = 0; k < NT * 4; ++k) acc[i][k] = 0.f;
      uint64_t a[MAX_TILES];
      if (l == 0) {
        int prev = -1;
        for (int c = 0; c < p.chunks; ++c, ++it) {
          const int s = it % p.stages;
          mbar_wait(full + 8 * s, (it / p.stages) & 1);
          const uint32_t stage = base + p.off_ring + s * p.stage_bytes;
#pragma unroll
          for (int i = 0; i < MAX_TILES; ++i)
            a[i] = descriptor(stage, p.stage_plane) + rows[i];
          const uint64_t b0 = descriptor(
              p.resident ? w_base + c * W0_CHUNK : stage + 2 * p.stage_plane,
              F * 16);
          products<NT>(n, acc, a, b0, ge.si, 9, 0);
          // The previous chunk's products are done: release its stage.
          wg_wait<1>();
          if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);
          prev = s;
        }
        wg_wait<0>();
#pragma unroll
        for (int i = 0; i < MAX_TILES; ++i) pin(acc[i]);
        if (lane == 0) mbar_arrive(empty + 8 * prev);
      } else {
        const bool even = (l - 1) % 2 == 0;
        const uint32_t plane = even ? p.mid_plane0 : p.mid_plane1;
#pragma unroll
        for (int i = 0; i < MAX_TILES; ++i)
          a[i] = descriptor(base + (even ? p.off_mid0 : p.off_mid1), plane)
                 + rows[i];
        const uint64_t b0 = descriptor(
            w_later + (l - 1) * (FK / 16) * 9 * STEP, F * 16);
        products<NT>(n, acc, a, b0, ge.si, 9 * (FK / 16), plane >> 4);
        wg_wait<0>();
#pragma unroll
        for (int i = 0; i < MAX_TILES; ++i) pin(acc[i]);
      }

      // Epilogue: bias and LeakyReLU in float32, then bfloat16; the last
      // layer into the output tile, the others into the next input's
      // pixel rows with the pixels outside the image zeroed (a test only
      // tiles whose grown region reaches the image's edge need).
      const bool last = l == L - 1;
      const int halo = L - 1 - l;
      const bool edge = oy0 < halo || ox0 < halo
                        || oy0 + TILE + halo > p.h || ox0 + TILE + halo > p.w;
      uint32_t* const dst = reinterpret_cast<uint32_t*>(
          smem + (l % 2 == 0 ? p.off_mid0 : p.off_mid1)) + t;
      const int dplane = (l % 2 == 0 ? p.mid_plane0 : p.mid_plane1) / 4;
      uint16_t* const out =
          reinterpret_cast<uint16_t*>(smem + p.off_out) + 2 * t * OUT_STRIDE;
      float2 bl[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) bl[j] = s_bias[l * F / 2 + 4 * j + t];
      // m / si as (m x ceil(2^16 / si)) >> 16: exact for m < 1024, si < 32.
      const int inv_si = (65536 + ge.si - 1) / ge.si;
      if (last && L == 1) consumer_sync();  // the previous tile has gone out
#pragma unroll
      for (int i = 0; i < MAX_TILES; ++i) {
        if (i >= n) break;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int m = 64 * (CONSUMERS * i + cw) + 16 * warp + g + 8 * r;
          const int oy = (m * inv_si) >> 16, ox = m - oy * ge.si;
          if (m >= ge.rows || ox >= ge.so) continue;
          bool inside = true;
          if (edge) {
            const int gy = oy0 - halo + oy, gx = ox0 - halo + ox;
            inside = gy >= 0 && gy < p.h && gx >= 0 && gx < p.w;
          }
          uint32_t pk[NT];
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            float v0 = acc[i][4 * j + 2 * r] + bl[j].x;
            float v1 = acc[i][4 * j + 2 * r + 1] + bl[j].y;
            v0 = v0 >= 0.f ? v0 : slope * v0;
            v1 = v1 >= 0.f ? v1 : slope * v1;
            const __nv_bfloat162 h2 = __floats2bfloat162_rn(v0, v1);
            pk[j] = inside ? *reinterpret_cast<const uint32_t*>(&h2) : 0u;
          }
          if (last) {
            const int q = oy * TILE + ox;
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              out[8 * j * OUT_STRIDE + q] = (uint16_t)pk[j];
              out[(8 * j + 1) * OUT_STRIDE + q] = (uint16_t)(pk[j] >> 16);
            }
          } else {
            const int q = 4 * (oy * ge.so + ox);
#pragma unroll
            for (int j = 0; j < NT; ++j) dst[j * dplane + q] = pk[j];
          }
        }
      }
      if (!last) fence_async_shared();
      consumer_sync();  // the layer's output is complete
    }

    // The output tile to y: 16-byte rows of 8 pixels where W % 8 == 0.
    const size_t hw = (size_t)p.h * p.w;
    for (int v = ctid; v < F * TILE * 2; v += CONSUMERS * 128) {
      const int co = v / (2 * TILE), py = (v / 2) % TILE, half = v & 1;
      const int gy = oy0 + py, gx = ox0 + 8 * half;
      if (gy >= p.h || gx >= p.w) continue;
      const uint32_t src = out_tile + 2 * (co * OUT_STRIDE + py * TILE
                                           + 8 * half);
      __nv_bfloat16* o = y + ((size_t)b * F + co) * hw + (size_t)gy * p.w
                         + gx;
#ifdef STRIP_STORES
      if (p.h < 0)
#endif
      {
        if (p.vec) {
          uint4 d;
          asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                       : "=r"(d.x), "=r"(d.y), "=r"(d.z), "=r"(d.w)
                       : "r"(src));
          *reinterpret_cast<uint4*>(o) = d;
        } else {
          for (int k = 0; k < 8 && gx + k < p.w; ++k) {
            uint16_t e;
            asm volatile("ld.shared.u16 %0, [%1];" : "=h"(e)
                         : "r"(src + 2 * k));
            reinterpret_cast<uint16_t*>(o)[k] = e;
          }
        }
      }
    }
  }
}

template <int NT>
static int launch(const void* x, const void* w, const void* b, void* y,
                  const Plan& p, int grid, float slope,
                  cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      conv_block_bf16_kernel<NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (e != cudaSuccess) return (int)e;
  conv_block_bf16_kernel<NT><<<grid, THREADS, p.smem, stream>>>(
      (const uint16_t*)x, (const uint8_t*)w, (const __nv_bfloat16*)b,
      (__nv_bfloat16*)y, p, slope);
  return (int)cudaGetLastError();
}

// `w` is PackedConvBlock.tc_weights (bfloat16, wgmma_weights' layout);
// `plan` the PLAN_INTS ints of ops/kernels/conv_block_bf16.py:plan.
extern "C" int conv_block_bf16_launch(const void* x, const void* w,
                                      const void* b, void* y,
                                      const int* plan, int f, int grid,
                                      float slope, void* stream) {
  Plan p;
  memcpy(&p, plan, sizeof p);
  if (f % 8 != 0 || f <= 0 || f > 32 || p.layers < 1
      || p.layers > MAX_LAYERS || p.stages < 2 || p.stages > MAX_STAGES
      || p.smem > MAX_SMEM || p.cin < 1 || grid < 1)
    return (int)cudaErrorInvalidValue;
  if (p.items == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (f / 8) {
    case 1: return launch<1>(x, w, b, y, p, grid, slope, s);
    case 2: return launch<2>(x, w, b, y, p, grid, slope, s);
    case 3: return launch<3>(x, w, b, y, p, grid, slope, s);
    default: return launch<4>(x, w, b, y, p, grid, slope, s);
  }
}
