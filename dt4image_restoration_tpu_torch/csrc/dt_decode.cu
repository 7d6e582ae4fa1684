// K3: the Decision Transformer's whole block stack plus the final LayerNorm
// in one launch, one cluster of four thread blocks per group of sequences.
//
// Replaces the TPU kernel fused_dt_decode
// (dt4image_restoration_tpu/ops/pallas/transformer.py:122). Per block, on the
// (T, E) token activations of each sequence:
//
//     h = LN1(x); qkv = h Wqkv + bqkv
//     att = causal softmax(q k^T / sqrt(D)) v      per head, D = E / 4
//     x = x + att Wo + bo
//     h = LN2(x); h = GELU(h Wfc + bfc)            exact erf GELU
//     x = h Wproj + bproj                          no residual (reference)
//
// then out = LNf(x). LayerNorm eps is 1e-5. Attention is causal within each
// sequence; the TPU kernel's block-diagonal score matrix over the flattened
// batch was an MXU device and is not copied.
//
// Bound on the H100: the four projections, 24 T E^2 flops per sequence and
// block, run on the tensor cores as float32-accurate 3xTF32 products, so
// the least time is the flops over 495/3 = 165 TFLOP/s: 1.5 GFLOP (T = 12)
// and 2.3 GFLOP (T = 18) at the policy's 63 sequences, against 4 MB of
// weights. What the design does about it:
//  * A cluster of CLUSTER = 4 blocks (CTAs) takes S consecutive sequences,
//    M = S T <= 56 tokens, padded to a multiple of 8. CTA r computes head
//    r's q, k and v and the r-th quarter of the output features of o, fc
//    and proj, from the r-th quarter of each weight matrix only: a CTA
//    streams 3 E^2 weights a block, not 12 E^2. The wrapper picks S so that
//    the B sequences fit one wave of the clusters the card runs at once
//    (dt_decode_clusters_at_once): on the H100 that is 30 clusters of one
//    CTA an SM, not 33, since a cluster stays inside one GPC. The policy's
//    63 sequences take S = 3, 21 clusters.
//  * After each of the four products of a block a CTA writes its column
//    slice into the shared memory of all four CTAs (distributed shared
//    memory), and the cluster passes one barrier. Every CTA then holds full
//    rows, so it computes the LayerNorms itself, and head r's attention
//    needs nothing from the other CTAs.
//  * Each product is mma.sync m16n8k8 TF32 tiles, weights as A (m16 over
//    output features), tokens as B (n8 over tokens). One TF32 product is
//    about 1e-3 off at these depths, so both operands are split into
//    hi + lo as they are loaded (split(), as in conv_block.cu) and each
//    product is taken three times (lo hi, hi lo, hi hi).
//  * The wrapper packs each CTA's weights once, unsplit float32, in the
//    order its lanes read them (ops/kernels/transformer.py:
//    pack_dt_fragments). They stream through a ring of STAGES shared-memory
//    chunks, each one bulk copy by the copy engine (cp.async.bulk, its
//    landing signalled on an mbarrier), two chunks in flight while one
//    multiplies. Where a product has fewer m16 tiles than the block has
//    warps, the warps split its K and add their partial sums in shared
//    memory. The chunk plan (Gemm) is compile-time constants: evaluated
//    at run time, its search loop cost thousands of cycles a chunk.
//  * Activation rows are padded to 4 mod 32 floats, so a B fragment's 8
//    tokens x 4 features fall in 32 banks. Attention (T <= 32), the
//    LayerNorms, GELU and the bias and residual epilogues run on the CUDA
//    cores from shared memory: one warp per query row, a key per lane.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define CLUSTER 4             // CTAs per cluster = attention heads
#define WARPS 8
#define THREADS (WARPS * 32)
#define MAX_T 32
#define MAX_M 56              // tokens per cluster, a multiple of 8
#define STAGES 3              // weight chunks in the ring
#define STAGE_FLOATS 4096     // floats per weight chunk (16 KB)
#define LN_EPS 1e-5f
#define FULL 0xffffffffu

// Returned when a cluster and its shared memory do not fit on the card.
#define DT_CLUSTER_DOES_NOT_FIT (-1)

struct DTParams {
  const float *ln1_s, *ln1_b, *qkv_b, *o_b, *ln2_s, *ln2_b, *fc_b, *proj_b,
      *lnf_s, *lnf_b;
  const float* frags;  // (CLUSTER, n_blocks, 3 E^2), pack_dt_fragments
};

enum { QKV = 0, O = 1, FC = 2, PROJ = 3 };

// The largest divisor c of ks that kp divides and whose c k8 steps of mt
// m16 tiles (128 floats each) fit a stage; 0 if there is none.
constexpr int chunk_steps(int ks, int kp, int mt) {
  int best = 0;
  for (int c = 1; c <= ks; ++c)
    if (ks % c == 0 && c % kp == 0 && c * mt * 128 <= STAGE_FLOATS) best = c;
  return best;
}

// Product G of a block in one CTA at width E, fixed at compile time: MT
// m16 tiles of output features, KS k8 steps, KP warps on each m tile
// (split K); a staged chunk is CKS k steps of all MT tiles, FLOATS floats,
// and the product streams CHUNKS of them.
template <int E, int G>
struct Gemm {
  static constexpr int MT = G == QKV ? 3 * E / 64 : G == FC ? E / 16 : E / 64;
  static constexpr int KS = G == PROJ ? E / 2 : E / 8;
  static constexpr int KP = WARPS / MT;
  static constexpr int CKS = chunk_steps(KS, KP, MT);
  static constexpr int CHUNKS = CKS > 0 ? KS / CKS : 0;
  static constexpr int FLOATS = CKS * MT * 128;
  static_assert(MT <= WARPS && CKS > 0 && CHUNKS * FLOATS == KS * MT * 128,
                "a product's chunks must tile its weights");
};

// Chunks in one block's stream: the products' chunks in turn.
template <int E>
constexpr int chunks_per_block = Gemm<E, QKV>::CHUNKS + Gemm<E, O>::CHUNKS
                                + Gemm<E, FC>::CHUNKS + Gemm<E, PROJ>::CHUNKS;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               ::"r"(smem_addr(bar)));
}

// Copy `bytes` from global to shared memory with the copy engine (TMA); the
// barrier's phase completes when they have landed.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n .reg .pred done;\n WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT;\n}" ::"r"(smem_addr(bar)), "r"(parity)
      : "memory");
}

// d += a b on one m16n8k8 tile, TF32 operands, float32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v = hi + lo, hi rounded to TF32 to nearest (ties away from zero), lo the
// exact rest, of which the tensor core reads the top 19 bits.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// This CTA's weight chunks, streamed in order through the ring.
struct Stream {
  const float* src;  // the CTA's fragments
  float* ring;       // STAGES x STAGE_FLOATS
  uint64_t* full;    // STAGES barriers: stage i's chunk has landed
  size_t off;        // float offset of the next chunk to issue
  int issued, consumed, total;
};

// Floats in chunk j of a block's stream.
template <int E>
__device__ __forceinline__ int chunk_floats_at(int j) {
  constexpr int c0 = Gemm<E, QKV>::CHUNKS, c1 = c0 + Gemm<E, O>::CHUNKS,
                c2 = c1 + Gemm<E, FC>::CHUNKS;
  return j < c0   ? Gemm<E, QKV>::FLOATS
         : j < c1 ? Gemm<E, O>::FLOATS
         : j < c2 ? Gemm<E, FC>::FLOATS
                  : Gemm<E, PROJ>::FLOATS;
}

// Thread 0 starts copying the next chunk into its stage.
template <int E>
__device__ __forceinline__ void issue(Stream& s) {
  if (s.issued < s.total) {
    const int n = chunk_floats_at<E>(s.issued % chunks_per_block<E>);
    if (threadIdx.x == 0)
      bulk_copy(s.ring + (s.issued % STAGES) * STAGE_FLOATS, s.src + s.off,
                4 * n, s.full + s.issued % STAGES);
    s.off += n;
  }
  ++s.issued;
}

// The next chunk, once it has landed. The stage that every warp has just
// finished with starts loading the chunk STAGES - 1 further on.
template <int E>
__device__ __forceinline__ const float* next_chunk(Stream& s) {
  __syncthreads();
  issue<E>(s);
  const int c = s.consumed++;
  mbar_wait(s.full + c % STAGES, (c / STAGES) & 1);
  return s.ring + (c % STAGES) * STAGE_FLOATS;
}

// One k8 step of a warp's m16 tile over the NT n8 tiles: `a` is this lane's
// A fragment (rows g, g + 8 by columns t, t + 4), `b` points at feature
// k0 + t of token g, rows `stride` floats apart.
template <int NT>
__device__ __forceinline__ void kstep(float4 a, const float* b, int stride,
                                      float (&acc)[NT][4]) {
  uint32_t ah[4], al[4];
  split(a.x, ah[0], al[0]);
  split(a.y, ah[1], al[1]);
  split(a.z, ah[2], al[2]);
  split(a.w, ah[3], al[3]);
  uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float* bj = b + 8 * j * stride;
    split(bj[0], bh[j][0], bl[j][0]);
    split(bj[4], bh[j][1], bl[j][1]);
  }
  // Small terms first, each product over the n tiles in turn, so that no
  // product waits on the one just before it.
#pragma unroll
  for (int j = 0; j < NT; ++j) mma(acc[j], al, bh[j][0], bh[j][1]);
#pragma unroll
  for (int j = 0; j < NT; ++j) mma(acc[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
  for (int j = 0; j < NT; ++j) mma(acc[j], ah, bh[j][0], bh[j][1]);
}

// Product G of a block: D[m][n] = sum_k A[m][k] act[n][k] for this CTA's
// 16 MT output features m and 8 NT tokens n; out(m, n, D[m][n]) takes each
// sum once. Warp w owns m tile w % MT and every KP-th k step from w / MT.
template <int E, int G, int NT, class Out>
__device__ __forceinline__ void gemm(Stream& s, const float* act, int stride,
                                     float* part, Out out) {
  using P = Gemm<E, G>;
  constexpr int MT = P::MT, KP = P::KP, CKS = P::CKS, MP = 8 * NT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool active = warp < MT * KP;
  const int mt = warp % MT, kp = warp / MT;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  const float* b = act + g * stride + t;
  for (int c = 0; c < P::CHUNKS; ++c) {
    const float4* st = reinterpret_cast<const float4*>(next_chunk<E>(s));
    if (active) {
#pragma unroll
      for (int ii = 0; ii < CKS / KP; ++ii) {
        const int i = ii * KP + kp;
        kstep<NT>(st[(i * MT + mt) * 32 + lane], b + (c * CKS + i) * 8,
                  stride, acc);
      }
    }
  }
  if constexpr (KP == 1) {
    if (active) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            out(mt * 16 + g + 8 * h, 8 * j + 2 * t + e, acc[j][2 * h + e]);
    }
  } else {
    // Partial sums of the KP warps of each m tile, added in a fixed order,
    // once every warp is done with its operand (part may share its memory).
    __syncthreads();
    if (active) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            part[((kp * MT + mt) * 16 + g + 8 * h) * MP + 8 * j + 2 * t + e] =
                acc[j][2 * h + e];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < MT * 16 * MP; idx += THREADS) {
      float v = 0.f;
#pragma unroll
      for (int p = 0; p < KP; ++p) v += part[p * MT * 16 * MP + idx];
      out(idx / MP, idx % MP, v);
    }
  }
}

// LayerNorm of rows row0, row0 + step, ... < rows (one warp per row, E
// values), from `in` to `out`, row strides is and os.
template <int E>
__device__ __forceinline__ void layernorm(const float* in, int is, float* out,
                                          int os, int row0, int rows,
                                          int step, const float* s,
                                          const float* b) {
  constexpr int V = E / 32;
  const int lane = threadIdx.x & 31;
  for (int row = row0 + (threadIdx.x >> 5); row < rows; row += step) {
    float v[V];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      v[i] = in[row * is + lane + 32 * i];
      sum += v[i];
    }
    const float mean = warp_sum(sum) / E;
    float var = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      v[i] -= mean;
      var += v[i] * v[i];
    }
    const float rs = 1.0f / sqrtf(warp_sum(var) / E + LN_EPS);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int k = lane + 32 * i;
      out[row * os + k] = v[i] * rs * __ldg(s + k) + __ldg(b + k);
    }
  }
}

// Shared memory of a CTA, in floats per row of the cluster's MP = 8 NT
// tokens: the residual stream x (XS), the LayerNorm output h, which the
// split-K partial sums of o and proj (WARPS x 16 a token) overwrite once
// h is spent (HR), and the MLP hidden (HS), which between MLPs holds this
// head's q|k|v (QS) and then the attention output of all heads (XS); then
// the weight ring.
template <int E, int NT>
struct Layout {
  static constexpr int MP = 8 * NT;
  static constexpr int XS = E + 4;
  static constexpr int HR = XS > WARPS * 16 ? XS : WARPS * 16;
  static constexpr int HS = 4 * E + 4;
  static constexpr int QS = 3 * (E / CLUSTER) + 1;
  static constexpr size_t floats =
      (size_t)MP * (XS + HR + HS) + STAGES * STAGE_FLOATS;
};

template <int E, int NT>
__global__ void __launch_bounds__(THREADS, 1)
dt_decode_kernel(const float* __restrict__ tokens, float* __restrict__ out,
                 int batch, int T, int S, int n_blocks, DTParams p) {
  using L = Layout<E, NT>;
  constexpr int Q = E / CLUSTER;     // head width; o and proj columns a CTA
  constexpr int MP = L::MP, XS = L::XS, HS = L::HS, QS = L::QS;
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  extern __shared__ float4 smem4[];
  __shared__ uint64_t full[STAGES];
  float* xs = reinterpret_cast<float*>(smem4);
  float* hs = xs + MP * XS;
  float* part = hs;
  float* big = hs + MP * L::HR;
  float* qkv = big;
  float* att = big + MP * QS;
  float* ring = big + MP * HS;
  float* xs_r[CLUSTER];
  float* big_r[CLUSTER];
#pragma unroll
  for (int q = 0; q < CLUSTER; ++q) {
    xs_r[q] = cluster.map_shared_rank(xs, q);
    big_r[q] = cluster.map_shared_rank(big, q);
  }

  const int seq0 = (blockIdx.x / CLUSTER) * S;
  const int m_valid = min(S, batch - seq0) * T;   // tokens of real sequences
  const float* tk = tokens + (size_t)seq0 * T * E;
  for (int i = threadIdx.x; i < MP * XS; i += THREADS) {
    const int m = i / XS, k = i % XS;
    xs[i] = (m < m_valid && k < E) ? tk[m * E + k] : 0.f;
  }
  // Padded tokens stay finite; no product mixes tokens.
  for (int i = threadIdx.x; i < MP * (L::HR + HS); i += THREADS)
    hs[i] = 0.f;

  Stream s;
  s.src = p.frags + (size_t)r * n_blocks * 3 * E * E;
  s.ring = ring;
  s.full = full;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(full + i);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  s.off = 0;
  s.issued = s.consumed = 0;
  s.total = n_blocks * chunks_per_block<E>;
  for (int i = 0; i < STAGES - 1; ++i) issue<E>(s);
  cluster.sync();  // every CTA runs before any writes into another

  const float scale = 1.0f / sqrtf((float)Q);
  for (int blk = 0; blk < n_blocks; ++blk) {
    layernorm<E>(xs, XS, hs, XS, 0, MP, WARPS, p.ln1_s + blk * E,
                 p.ln1_b + blk * E);
    __syncthreads();
    const float* bqkv = p.qkv_b + blk * 3 * E;
    gemm<E, QKV, NT>(s, hs, XS, part, [&](int m, int n, float v) {
      qkv[n * QS + m] = v + __ldg(bqkv + (m / Q) * E + r * Q + m % Q);
    });
    __syncthreads();

    // Head r, one warp per query row i of sequence `base`, key j in lane j;
    // the output column d of the row in lane d, to every CTA.
    for (int row = warp; row < S * T; row += WARPS) {
      const int i = row % T, base = row - i;
      float sc = -INFINITY;
      if (lane <= i) {
        const float* qr = qkv + row * QS;
        const float* kr = qkv + (base + lane) * QS + Q;
        float a = 0.f;
#pragma unroll
        for (int d = 0; d < Q; ++d) a = fmaf(qr[d], kr[d], a);
        sc = a * scale;
      }
      const float mx = warp_max(sc);
      const float ex = lane <= i ? expf(sc - mx) : 0.f;
      const float pr = ex / warp_sum(ex);
      const float* vc = qkv + base * QS + 2 * Q + lane;
      float o = 0.f;
      for (int j = 0; j <= i; ++j) {
        const float pj = __shfl_sync(FULL, pr, j);
        if (lane < Q) o = fmaf(pj, vc[j * QS], o);
      }
      if (lane < Q) {
        const int at = MP * QS + row * XS + r * Q + lane;
#pragma unroll
        for (int q = 0; q < CLUSTER; ++q) big_r[q][at] = o;
      }
    }
    cluster.sync();

    const float* bo = p.o_b + blk * E;
    gemm<E, O, NT>(s, att, XS, part, [&](int m, int n, float v) {
      const int at = n * XS + r * Q + m;
      const float x = xs[at] + v + __ldg(bo + r * Q + m);
#pragma unroll
      for (int q = 0; q < CLUSTER; ++q) xs_r[q][at] = x;
    });
    cluster.sync();

    layernorm<E>(xs, XS, hs, XS, 0, MP, WARPS, p.ln2_s + blk * E,
                 p.ln2_b + blk * E);
    __syncthreads();
    const float* bfc = p.fc_b + blk * 4 * E;
    gemm<E, FC, NT>(s, hs, XS, part, [&](int m, int n, float v) {
      float h = v + __ldg(bfc + r * E + m);
      h = h * 0.5f * (1.0f + erff(h * 0.70710678118654752f));
#pragma unroll
      for (int q = 0; q < CLUSTER; ++q) big_r[q][n * HS + r * E + m] = h;
    });
    cluster.sync();

    const float* bp = p.proj_b + blk * E;
    gemm<E, PROJ, NT>(s, big, HS, part, [&](int m, int n, float v) {
      const float x = v + __ldg(bp + r * Q + m);
#pragma unroll
      for (int q = 0; q < CLUSTER; ++q) xs_r[q][n * XS + r * Q + m] = x;
    });
    cluster.sync();
  }
  // The final LayerNorm: CTA r takes every CLUSTER-th warp's rows.
  layernorm<E>(xs, XS, out + (size_t)seq0 * T * E, E, r * WARPS, m_valid,
               CLUSTER * WARPS, p.lnf_s, p.lnf_b);
}

// Shared memory of one CTA, in bytes.
template <int E, int NT>
constexpr size_t smem_bytes() {
  return sizeof(float) * Layout<E, NT>::floats;
}
static_assert(smem_bytes<128, MAX_M / 8>() <= 232448,
              "a CTA's shared memory must fit the H100's 227 KB");

// The launch configuration of one instance, without its grid. Once per
// instance, its shared-memory limit is raised and the number of its
// clusters that can run on the card at once is taken into `fit`.
template <int E, int NT>
static cudaError_t configure(cudaLaunchConfig_t& cfg,
                             cudaLaunchAttribute& attr, int& fit) {
  static int clusters = -1;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CLUSTER;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = {};
  cfg.gridDim = dim3(CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes<E, NT>();
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (clusters < 0) {
    auto kernel = dt_decode_kernel<E, NT>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)cfg.dynamicSmemBytes);
    if (e != cudaSuccess) return e;
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (e != cudaSuccess) return e;
    clusters = n;
  }
  fit = clusters;
  return cudaSuccess;
}

template <int E, int NT>
static int launch(const float* tokens, float* out, int batch, int T, int S,
                  int n_blocks, const DTParams& p, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int fit = 0;
  cudaError_t e = configure<E, NT>(cfg, attr, fit);
  if (e != cudaSuccess) return (int)e;
  if (fit < 1) return DT_CLUSTER_DOES_NOT_FIT;
  cfg.gridDim = dim3((unsigned)((batch + S - 1) / S * CLUSTER));
  cfg.stream = stream;
  e = cudaLaunchKernelEx(&cfg, dt_decode_kernel<E, NT>, tokens, out, batch,
                         T, S, n_blocks, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int E>
static int launch_nt(int nt, const float* tokens, float* out, int batch,
                     int T, int S, int n_blocks, const DTParams& p,
                     cudaStream_t st) {
  switch (nt) {
    case 1: return launch<E, 1>(tokens, out, batch, T, S, n_blocks, p, st);
    case 2: return launch<E, 2>(tokens, out, batch, T, S, n_blocks, p, st);
    case 3: return launch<E, 3>(tokens, out, batch, T, S, n_blocks, p, st);
    case 4: return launch<E, 4>(tokens, out, batch, T, S, n_blocks, p, st);
    case 5: return launch<E, 5>(tokens, out, batch, T, S, n_blocks, p, st);
    case 6: return launch<E, 6>(tokens, out, batch, T, S, n_blocks, p, st);
    default: return launch<E, 7>(tokens, out, batch, T, S, n_blocks, p, st);
  }
}

// How many clusters of the largest instance at width E (one CTA an SM) the
// card runs at once: the wrapper's wave. Negative: minus a CUDA error code.
extern "C" int dt_decode_clusters_at_once(int E) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int fit = 0;
  cudaError_t e = E == 64 ? configure<64, MAX_M / 8>(cfg, attr, fit)
                          : configure<128, MAX_M / 8>(cfg, attr, fit);
  return e == cudaSuccess ? fit : -(int)e;
}

// `frags` is pack_dt_fragments' buffer; S sequences per cluster.
extern "C" int dt_decode_launch(
    const void* tokens, void* out, const void* frags, int batch, int T,
    int E, int H, int S, int n_blocks, const void* ln1_s, const void* ln1_b,
    const void* qkv_b, const void* o_b, const void* ln2_s, const void* ln2_b,
    const void* fc_b, const void* proj_b, const void* lnf_s,
    const void* lnf_b, void* stream) {
  if (T < 1 || T > MAX_T || (E != 64 && E != 128) || H != CLUSTER || S < 1
      || S * T > MAX_M || n_blocks < 0 || batch < 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const DTParams p = {(const float*)ln1_s, (const float*)ln1_b,
                      (const float*)qkv_b, (const float*)o_b,
                      (const float*)ln2_s, (const float*)ln2_b,
                      (const float*)fc_b,  (const float*)proj_b,
                      (const float*)lnf_s, (const float*)lnf_b,
                      (const float*)frags};
  const int nt = (S * T + 7) / 8;
  const float* tk = (const float*)tokens;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (E == 64) return launch_nt<64>(nt, tk, o, batch, T, S, n_blocks, p, st);
  return launch_nt<128>(nt, tk, o, batch, T, S, n_blocks, p, st);
}
