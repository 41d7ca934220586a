// The whole FFN sublayer of a decode step in one kernel: residual,
// LayerNorm (fp32 statistics), W_in (plus W_gate), activation, W_out.
//
// Replaces the TPU kernel `_fused_kernel` (transformer_tpu/ops/ffn.py,
// entered through `fused_ln_ffn`). What it computes for rows x (M, d):
//
//   h   = LN(x) (pre-LN) or x (post-LN), rounded to the compute dtype T
//   z   = round_T(h . W_in[:, f]) + b_in[f]          (fp32 accumulation)
//   t   = act(z)   or, gated, act(round_T(h . W_gate[:, f]) + b_gate[f]) * z
//   y   = round_T(sum_f t[f] * W_out[f, :]) + b_out  (fp32 accumulation)
//   out = x + y (pre-LN) or LN(x + y) (post-LN)
//
// gelu is the tanh approximation (jax.nn.gelu's default); silu is
// x * sigmoid(x). Activations are evaluated in fp32 on T values and
// rounded to T, as every elementwise step here is.
//
// Bound on an H100: at decode M = slots * S_q is a handful of rows, so
// the sublayer does ~2 flops per weight byte read and is bound by reading
// the weights once: 2 * d * dff * 2 B = 4.2 MB a layer for long4k in bf16
// (3 matrices when gated), 1.26 us at 3.35 TB/s. So few bytes take about
// as long as the memory's latency: every SM has to stream its share at
// once. What this design does about it:
//
// - One CTA per 32-byte slab of dff (16 bf16 or 8 fp32 columns) and 8
//   rows: 128 CTAs at dff 2048 in bf16 for M <= 8, each owning its W_in
//   (and W_gate) columns and the matching W_out rows. It issues its x rows
//   and its whole slab at launch as 16-byte cp.async copies into shared
//   memory (W_in's strided columns, 32 bytes of each of d rows, then
//   W_out's rows, one contiguous run), in three groups, so W_out is still
//   in flight while the first product runs. The CTAs of later row chunks
//   read the slabs again from L2.
// - Every CTA holds its 8 FFN input rows h (LN(x) for pre-LN) in shared
//   memory, transposed, and computes its slab of the intermediate t
//   (8 x slab) with CUDA-core FMAs: at ~2 flops a byte the tensor cores
//   buy nothing. 64 k-segments x 4 column groups of 8 bytes; the segment
//   sums are added in a fixed order.
// - Its slab's fp32 contribution to y (8 x d) is summed across thread
//   block clusters of 8 through distributed shared memory, each CTA adding
//   d / 8 columns over the 8 ranks in rank order. The global scratch then
//   holds one partial per cluster (16 at dff 2048), not one per CTA.
// - The last cluster of a row chunk to finish (a ticket after a memory
//   fence; the ticket is reset by that cluster, so nothing is zeroed
//   between calls) finishes the chunk's rows, one whole row per CTA: the
//   cluster partials added in cluster order, b_out, the residual and for
//   post-LN the row's LayerNorm with CTA-wide sums. Every sum runs in a
//   fixed order, so the result does not depend on scheduling, and no host
//   read or memset is needed: a decode step with this kernel can be
//   captured in a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;    // 8 warps
constexpr int kCluster = 8;      // CTAs per cluster
constexpr int kSlabBytes = 32;   // bytes of each weight row a CTA owns
constexpr int kRowChunk = 8;     // rows per CTA (grid y)
constexpr int kMaxRows = 256;    // M: 32 row chunks, one ticket each
constexpr int kMaxD = 1024;
constexpr int kDMultiple = 64;   // d: k-segments of the first product

enum Act { kRelu = 0, kGelu = 1, kSilu = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ float round_t(float x);
template <> __device__ __forceinline__ float round_t<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_t<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 8 bytes of T from shared memory as fp32 values.
__device__ __forceinline__ void load8(const float* p, float (&v)[2]) {
  const float2 a = *reinterpret_cast<const float2*>(p);
  v[0] = a.x;
  v[1] = a.y;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(a.x << 16);
  v[1] = __uint_as_float(a.x & 0xffff0000u);
  v[2] = __uint_as_float(a.y << 16);
  v[3] = __uint_as_float(a.y & 0xffff0000u);
}

// Two adjacent T values from shared memory as fp32.
__device__ __forceinline__ void load2(const float* p, float (&v)[2]) {
  const float2 a = *reinterpret_cast<const float2*>(p);
  v[0] = a.x;
  v[1] = a.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float (&v)[2]) {
  const uint32_t a = *reinterpret_cast<const uint32_t*>(p);
  v[0] = __uint_as_float(a << 16);
  v[1] = __uint_as_float(a & 0xffff0000u);
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float activate(float x, int act) {
  if (act == kRelu) return fmaxf(x, 0.f);
  if (act == kGelu) {
    const float k = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * x * (1.f + tanhf(k * (x + 0.044715f * x * x * x)));
  }
  return x / (1.f + expf(-x));  // silu
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
struct Slab {
  static constexpr int kCols = kSlabBytes / sizeof(T);  // dff columns a CTA owns
  static constexpr int kVec = 8 / sizeof(T);            // columns a thread reads at once
  static constexpr int kGroups = kCols / kVec;          // column groups
  static constexpr int kSegs = kThreads / kGroups;      // k-segments of the first product
  static_assert(kSegs == kDMultiple, "d must split into whole k-segments");
  static_assert(kRowChunk <= kCluster, "each rank of the last cluster finishes one row");
};

// Dynamic shared memory: W_in [d][cols], W_gate [d][cols] when gated,
// W_out [cols][d] and the chunk's x [kRowChunk][d] (all T), then fp32: h
// transposed [d][kRowChunk] for the first product, then partial y
// [kRowChunk][d]; the LayerNorm scale and bias of pre-LN [2][d]; the first
// product's segment sums [gated ? 2 : 1][kRowChunk][kSegs][cols]; t
// [kRowChunk][cols]; the block sums of the last stage [kThreads / 32]; the
// last-cluster flag.
template <typename T, bool Gated>
constexpr size_t smem_bytes(int d) {
  using S = Slab<T>;
  return static_cast<size_t>(Gated ? 3 : 2) * d * kSlabBytes +
         static_cast<size_t>(kRowChunk) * d * sizeof(T) +
         sizeof(float) * (static_cast<size_t>(kRowChunk + 2) * d +
                          (Gated ? 2 : 1) * kRowChunk * S::kSegs * S::kCols +
                          kRowChunk * S::kCols + kThreads / 32 + 4);
}

// The sum of v over the CTA, in warp order (scratch: kThreads / 32 floats).
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += scratch[w];
  __syncthreads();  // scratch is free again
  return total;
}

// Grid: (dff / cols CTAs in clusters of 8) x (row chunks of 8). CTA
// (x, y) owns dff columns [x * cols, (x + 1) * cols) and rows
// [y * 8, y * 8 + 8); the CTAs of one row chunk read the same slabs, the
// first from HBM and the others from L2.
template <typename T, bool Gated>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
fused_ln_ffn_kernel(const T* __restrict__ x, const T* __restrict__ w_in,
                    const T* __restrict__ b_in, const T* __restrict__ w_gate,
                    const T* __restrict__ b_gate, const T* __restrict__ w_out,
                    const T* __restrict__ b_out, const T* __restrict__ ln_scale,
                    const T* __restrict__ ln_bias, T* __restrict__ out,
                    float* __restrict__ partial, unsigned int* __restrict__ tickets, int m, int d,
                    int dff, int act, int pre_ln, float eps) {
  using S = Slab<T>;
  constexpr int W = S::kCols, V = S::kVec;
  static_assert(kRowChunk == 8, "the first product reads a k's rows as two float4s");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * W;  // this CTA's dff columns [c0, c0 + W)
  const int r0 = blockIdx.y * kRowChunk, rc = min(kRowChunk, m - r0);  // and rows
  const uint32_t rank = hopper::cluster_rank();
  const int cl = blockIdx.x / kCluster, n_cl = gridDim.x / kCluster;
  const int dc = d / kCluster;  // y columns this CTA sums for its cluster

  extern __shared__ __align__(16) uint8_t smem[];
  T* win = reinterpret_cast<T*>(smem);               // [d][W]
  T* wg = win + d * W;                               // [d][W] (gated)
  T* wo = wg + (Gated ? d * W : 0);                  // [W][d]
  T* xt = wo + W * d;                                // [kRowChunk][d]
  float* hbuf = reinterpret_cast<float*>(xt + kRowChunk * d);  // h^T, then partial y
  float* lns = hbuf + kRowChunk * d;                 // [d]
  float* lnb = lns + d;                              // [d]
  float* red = lnb + d;                              // [Gated ? 2 : 1][kRowChunk][kSegs][W]
  float* ts = red + (Gated ? 2 : 1) * kRowChunk * S::kSegs * W;  // [kRowChunk][W]
  float* sums = ts + kRowChunk * W;                  // [kThreads / 32]
  unsigned int* flag = reinterpret_cast<unsigned int*>(sums + kThreads / 32);

  // 1. Everything in flight at once, as 16-byte cp.async copies in three
  //    groups: the chunk's x rows (one contiguous run); W_in (and W_gate)
  //    columns, 32 bytes of each of d rows; W_out's W rows, one contiguous
  //    run of 32 * d bytes. W_out is still in flight while the first
  //    product runs.
  {
    const char* src_x = reinterpret_cast<const char*>(x + static_cast<int64_t>(r0) * d);
    const int x_chunks = rc * d * static_cast<int>(sizeof(T)) / 16;
    for (int i = tid; i < x_chunks; i += kThreads)
      hopper::cp_async16(reinterpret_cast<char*>(xt) + i * 16, src_x + i * 16);
    hopper::cp_async_commit();
    const size_t row_bytes = static_cast<size_t>(dff) * sizeof(T);
    const char* src_in = reinterpret_cast<const char*>(w_in + c0);
    const char* src_gate = Gated ? reinterpret_cast<const char*>(w_gate + c0) : nullptr;
    for (int i = tid; i < 2 * d; i += kThreads) {
      const size_t off = static_cast<size_t>(i >> 1) * row_bytes + (i & 1) * 16;
      hopper::cp_async16(reinterpret_cast<char*>(win) + i * 16, src_in + off);
      if constexpr (Gated)
        hopper::cp_async16(reinterpret_cast<char*>(wg) + i * 16, src_gate + off);
    }
    hopper::cp_async_commit();
    const char* src_out = reinterpret_cast<const char*>(w_out + static_cast<size_t>(c0) * d);
    for (int i = tid; i < 2 * d; i += kThreads)
      hopper::cp_async16(reinterpret_cast<char*>(wo) + i * 16,
                         src_out + static_cast<size_t>(i) * 16);
    hopper::cp_async_commit();
  }
  // b_out and the LayerNorm parameters of a thread's columns c = tid +
  // j * kThreads, for the last stage: loaded now, first used at the end.
  constexpr int J = kMaxD / kThreads;
  T bo[J], lsc[J], lbi[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = tid + j * kThreads;
    if (c < d) {
      bo[j] = b_out[c];
      lsc[j] = ln_scale[c];
      lbi[j] = ln_bias[c];
    }
  }
  if (pre_ln) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = tid + j * kThreads;
      if (c < d) {
        lns[c] = to_f(lsc[j]);
        lnb[c] = to_f(lbi[j]);
      }
    }
  }
  hopper::cp_async_wait<2>();  // this thread's x copies have landed
  __syncthreads();

  // 2. FFN input rows, one warp a row held in registers: LN(x) for pre-LN
  //    (fp32 statistics, affine in fp32, rounded to T), x for post-LN;
  //    stored transposed, so that the first product reads a k's 8 rows as
  //    two float4s.
  if (warp < rc) {
    constexpr int L = kMaxD / 32;
    const T* xr = xt + warp * d;
    float v[L];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int c = lane + 32 * j;
      v[j] = c < d ? to_f(xr[c]) : 0.f;
      s += v[j];
    }
    if (pre_ln) {
      const float mean = warp_sum(s) / d;
      float var = 0.f;
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const float t = v[j] - mean;
        if (lane + 32 * j < d) var += t * t;
      }
      const float rstd = rsqrtf(warp_sum(var) / d + eps);
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const int c = lane + 32 * j;
        if (c < d) v[j] = round_t<T>((v[j] - mean) * rstd * lns[c] + lnb[c]);
      }
    }
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int c = lane + 32 * j;
      if (c < d) hbuf[c * kRowChunk + warp] = v[j];
    }
  }
  hopper::cp_async_wait<1>();  // this thread's W_in (and W_gate) copies have landed
  __syncthreads();

  // 3. First product: thread (segment, column group) sums k = seg + kSegs*i
  //    for the chunk's rows (rows past rc hold stale values; their sums are
  //    never read), then kSegs segment sums per value: 8 independent chains
  //    and a fixed tree.
  {
    const int grp = tid % S::kGroups, seg = tid / S::kGroups;
    float z[kRowChunk][V], zg[kRowChunk][V];
#pragma unroll
    for (int r = 0; r < kRowChunk; ++r)
#pragma unroll
      for (int j = 0; j < V; ++j) z[r][j] = zg[r][j] = 0.f;
#pragma unroll 2
    for (int k = seg; k < d; k += S::kSegs) {
      float wv[V], gv[V];
      load8(win + k * W + grp * V, wv);
      if constexpr (Gated) load8(wg + k * W + grp * V, gv);
      const float4 h0 = *reinterpret_cast<const float4*>(hbuf + k * kRowChunk);
      const float4 h1 = *reinterpret_cast<const float4*>(hbuf + k * kRowChunk + 4);
      const float hv[kRowChunk] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
      for (int r = 0; r < kRowChunk; ++r)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          z[r][j] = fmaf(hv[r], wv[j], z[r][j]);
          if constexpr (Gated) zg[r][j] = fmaf(hv[r], gv[j], zg[r][j]);
        }
    }
#pragma unroll
    for (int r = 0; r < kRowChunk; ++r) {
      float* at = red + (r * S::kSegs + seg) * W + grp * V;  // one 8- or 16-byte store
      store_vec(at, z[r]);
      if constexpr (Gated) store_vec(at + kRowChunk * S::kSegs * W, zg[r]);
    }
  }
  __syncthreads();
  if (tid < rc * W) {
    const int r = tid / W, col = tid % W, f = c0 + col;
    float za[8] = {}, zga[8] = {};
#pragma unroll
    for (int s = 0; s < S::kSegs; ++s) {
      const int at = (r * S::kSegs + s) * W + col;
      za[s % 8] += red[at];
      if constexpr (Gated) zga[s % 8] += red[kRowChunk * S::kSegs * W + at];
    }
    const float z = ((za[0] + za[1]) + (za[2] + za[3])) + ((za[4] + za[5]) + (za[6] + za[7]));
    const float zg =
        ((zga[0] + zga[1]) + (zga[2] + zga[3])) + ((zga[4] + zga[5]) + (zga[6] + zga[7]));
    const float u = round_t<T>(round_t<T>(z) + to_f(b_in[f]));
    float t;
    if constexpr (Gated) {
      const float g = round_t<T>(round_t<T>(zg) + to_f(b_gate[f]));
      t = round_t<T>(round_t<T>(activate(g, act)) * u);
    } else {
      t = round_t<T>(activate(u, act));
    }
    ts[r * W + col] = t;
  }
  hopper::cp_async_wait<0>();  // this thread's W_out copies have landed
  __syncthreads();

  // 4. Second product: the slab's fp32 contribution to y for the chunk's
  //    rows, into hbuf (h is no longer needed). A thread keeps the W
  //    weights of its column pairs in registers and walks the rows.
  {
    constexpr int P = kMaxD / 2 / kThreads;  // pairs 2p, 2p + 1, p = tid + i * kThreads
    float wv[P][W][2];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int c = 2 * (tid + i * kThreads);
#pragma unroll
      for (int f = 0; f < W; ++f) {
        if (c < d) {
          load2(wo + f * d + c, wv[i][f]);
        } else {
          wv[i][f][0] = wv[i][f][1] = 0.f;
        }
      }
    }
    for (int r = 0; r < rc; ++r) {
      float tv[W];
#pragma unroll
      for (int f = 0; f < W; ++f) tv[f] = ts[r * W + f];
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int c = 2 * (tid + i * kThreads);
        if (c >= d) break;
        float s[2] = {0.f, 0.f};
#pragma unroll
        for (int f = 0; f < W; ++f) {
          s[0] = fmaf(tv[f], wv[i][f][0], s[0]);
          s[1] = fmaf(tv[f], wv[i][f][1], s[1]);
        }
        store_vec(hbuf + r * d + c, s);
      }
    }
  }
  hopper::cluster_sync();  // every CTA of the cluster holds its partial y

  // 5. The cluster's partial: this CTA adds columns [rank*dc, (rank+1)*dc)
  //    over the 8 ranks' shared memory, in rank order.
  for (int i = tid; i < rc * dc; i += kThreads) {
    const int r = i / dc, c = rank * dc + i % dc;
    const float* local = hbuf + r * d + c;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kCluster; ++q) s += hopper::ld_cluster(hopper::cluster_addr(local, q));
    partial[(static_cast<int64_t>(cl) * m + r0 + r) * d + c] = s;
  }
  hopper::cluster_sync();  // the cluster's partial is written and its hbuf reads are done

  // 6. The last cluster of the row chunk to finish finalises. Rank 0 takes
  //    the ticket and hands the answer to every rank's shared memory. Its
  //    add releases the cluster's partial (ordered before it by the barrier
  //    above) and acquires the other clusters'; the barrier below carries
  //    that to the rest of the cluster.
  if (rank == 0 && tid == 0) {
    unsigned int* ticket = tickets + blockIdx.y;
    const unsigned int last =
        hopper::atomic_add_acq_rel(ticket, 1u) == static_cast<unsigned int>(n_cl - 1);
    if (last) *ticket = 0;  // every other cluster has taken its ticket
#pragma unroll
    for (int q = 0; q < kCluster; ++q) hopper::st_cluster(hopper::cluster_addr(flag, q), last);
  }
  hopper::cluster_sync();
  if (*reinterpret_cast<volatile unsigned int*>(flag) == 0 || static_cast<int>(rank) >= rc)
    return;

  // 7. Rank r finishes row r0 + r whole: y = the cluster partials in
  //    cluster order, then b_out and the residual, then for post-LN the
  //    row's LayerNorm with CTA-wide sums.
  const int64_t row = r0 + rank;
  float res[J];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = tid + j * kThreads;
    res[j] = 0.f;
    if (c >= d) continue;
    float y = 0.f;
#pragma unroll 16
    for (int q = 0; q < n_cl; ++q)
      y += __ldcg(partial + (static_cast<int64_t>(q) * m + row) * d + c);
    res[j] = round_t<T>(to_f(xt[rank * d + c]) + round_t<T>(round_t<T>(y) + to_f(bo[j])));
    s += res[j];
    if (pre_ln) out[row * d + c] = from_f<T>(res[j]);
  }
  if (pre_ln) return;
  const float mean = block_sum(s, sums) / d;
  float v = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const float t = res[j] - mean;
    if (tid + j * kThreads < d) v += t * t;
  }
  const float rstd = rsqrtf(block_sum(v, sums) / d + eps);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = tid + j * kThreads;
    if (c < d)
      out[row * d + c] =
          from_f<T>(round_t<T>((res[j] - mean) * rstd * to_f(lsc[j]) + to_f(lbi[j])));
  }
}

template <typename T, bool Gated>
cudaError_t launch(const void* x, const void* w_in, const void* b_in, const void* w_gate,
                   const void* b_gate, const void* w_out, const void* b_out,
                   const void* ln_scale, const void* ln_bias, void* out, float* partial,
                   unsigned int* tickets, int m, int d, int dff, int act, int pre_ln, float eps,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<T, Gated>(d);
  auto kernel = fused_ln_ffn_kernel<T, Gated>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(dff / Slab<T>::kCols, (m + kRowChunk - 1) / kRowChunk);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_in), static_cast<const T*>(b_in),
      static_cast<const T*>(w_gate), static_cast<const T*>(b_gate),
      static_cast<const T*>(w_out), static_cast<const T*>(b_out),
      static_cast<const T*>(ln_scale), static_cast<const T*>(ln_bias),
      static_cast<T*>(out), partial, tickets, m, d, dff, act, pre_ln, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(bool gated, const void* x, const void* w_in, const void* b_in,
                     const void* w_gate, const void* b_gate, const void* w_out,
                     const void* b_out, const void* ln_scale, const void* ln_bias, void* out,
                     float* partial, unsigned int* tickets, int m, int d, int dff, int act,
                     int pre_ln, float eps, cudaStream_t stream) {
  if (dff % (Slab<T>::kCols * kCluster) != 0) return cudaErrorInvalidValue;
  auto fn = gated ? launch<T, true> : launch<T, false>;
  return fn(x, w_in, b_in, w_gate, b_gate, w_out, b_out, ln_scale, ln_bias, out, partial, tickets,
            m, d, dff, act, pre_ln, eps, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. act: 0 relu, 1 gelu (tanh), 2 silu;
// w_gate/b_gate non-null selects the gated form. Shapes as
// ops/ffn.py `check_kernel_args` states them (the Python side refuses
// anything else before a build; this guard returns cudaErrorInvalidValue).
// partial holds (dff / (cols * 8)) * m * d floats, cols = 32 / sizeof(T);
// tickets are ceil(m / 8) counters, zero before the first call and left
// zero by every call.
extern "C" int fused_ln_ffn(int dtype, const void* x, const void* w_in, const void* b_in,
                            const void* w_gate, const void* b_gate, const void* w_out,
                            const void* b_out, const void* ln_scale, const void* ln_bias,
                            void* out, float* partial, unsigned int* tickets, int m, int d,
                            int dff, int act, int pre_ln, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || m > kMaxRows || d < kDMultiple || d > kMaxD || d % kDMultiple != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool gated = w_gate != nullptr;
  if (dtype == 0)
    return static_cast<int>(dispatch<float>(gated, x, w_in, b_in, w_gate, b_gate, w_out, b_out,
                                            ln_scale, ln_bias, out, partial, tickets, m, d, dff,
                                            act, pre_ln, eps, s));
  if (dtype == 1)
    return static_cast<int>(dispatch<__nv_bfloat16>(gated, x, w_in, b_in, w_gate, b_gate, w_out,
                                                     b_out, ln_scale, ln_bias, out, partial,
                                                     tickets, m, d, dff, act, pre_ln, eps, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
