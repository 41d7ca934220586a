// Paged decode/verify attention over a KV block pool, blocks read in place.
//
// Replaces the TPU kernel `_paged_kernel` (transformer_tpu/kernels/
// paged_flash.py, entered through `paged_flash_attention`). What it
// computes, per sequence n and kv head h:
//
//   folded query rows r = g * S_q + i  (query head h*G + g, query index i)
//   score(r, t) = round_T(q_r . k_t) * scale    (dot in the compute dtype T)
//   visible(r, t) = t <= len[n] - S_q + i        (per-row offset causality)
//   online softmax over the table, fp32 running max / normaliser / output
//   p = exp(score - m) where score > -1e29 else 0; P.V with p rounded to T
//   out = acc / l
//
// int8 pools hold codes plus one fp32 scale per (position, head); the
// kernel dequantises as round_T(T(code) * T(scale)), exactly as the TPU
// kernel does in VMEM.
//
// Bound on an H100: decode attention reads each visible K/V row once and
// does ~4*D flops per row per query head, far below the ~295 flop/byte
// ridge, so it is bound by the bytes of the visible K/V rows (HBM).
// What this design does about it: one CTA per (sequence, kv head) loads
// its own table row and length and walks only ceil(len / B) table entries,
// so stale table entries and positions past the length cost no read (the
// TPU version DMAs every entry and skips only the compute). All G query
// heads of a kv head are folded into one CTA, so each K/V row is read from
// HBM once whatever the GQA group size. Tiles of up to 64 tokens (several
// pool blocks) are staged in shared memory per step. This first version
// uses CUDA cores and plain loads; it keeps few CTAs in flight at small
// batch, which is the known gap to the bound (cp.async / TMA pipelining
// and a split over the sequence are later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e30f;     // flash_attention.py _MASKED
constexpr float kMaskGuard = -1e29f;  // flash_attention.py _MASK_GUARD
constexpr int kThreads = 128;
constexpr int kTileTokens = 64;

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

// One pool element as the compute dtype sees it (float holding a T value).
template <typename T, bool Q>
__device__ __forceinline__ float load_kv(const void* pool, const float* scale,
                                         int64_t row, int64_t elem) {
  if constexpr (Q) {
    const float code = static_cast<float>(static_cast<const int8_t*>(pool)[elem]);
    return round_t<T>(code * round_t<T>(scale[row]));
  } else {
    return to_f(static_cast<const T*>(pool)[elem]);
  }
}

template <typename T, bool Q>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const void* __restrict__ k_pool,
                       const void* __restrict__ v_pool,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ table,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       int s_q, int n_heads, int h_kv, int d, int block_tokens,
                       int nmax, int blocks_per_tile, float scale) {
  const int h = blockIdx.x;  // kv head
  const int n = blockIdx.y;  // sequence
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = kThreads / 32;
  const int group = n_heads / h_kv;
  const int gs = group * s_q;
  const int tt = blocks_per_tile * block_tokens;  // tokens per tile
  const int dp = d + 1;                           // padded K row

  extern __shared__ float smem[];
  float* qs = smem;                 // [gs][d]
  float* ks = qs + gs * d;          // [tt][d + 1]
  float* vs = ks + tt * dp;         // [tt][d]
  float* ps = vs + tt * d;          // [gs][tt] scores, then p rounded to T
  float* acc = ps + gs * tt;        // [gs][d]
  float* m_run = acc + gs * d;      // [gs]
  float* l_run = m_run + gs;        // [gs]
  float* alpha = l_run + gs;        // [gs]

  const int len = lengths[n];
  const int* trow = table + static_cast<int64_t>(n) * nmax;
  int n_blocks = (len + block_tokens - 1) / block_tokens;
  if (n_blocks > nmax) n_blocks = nmax;

  for (int idx = tid; idx < gs * d; idx += kThreads) {
    const int r = idx / d, c = idx % d;
    const int g = r / s_q, i = r % s_q;
    const int head = h * group + g;
    qs[idx] = to_f(q[((static_cast<int64_t>(n) * s_q + i) * n_heads + head) * d + c]);
    acc[idx] = 0.f;
  }
  for (int r = tid; r < gs; r += kThreads) {
    m_run[r] = kMasked;
    l_run[r] = 0.f;
  }
  __syncthreads();

  for (int j0 = 0; j0 < n_blocks; j0 += blocks_per_tile) {
    // Stage the tile's K/V rows (dequantised, as T values) in shared memory.
    for (int idx = tid; idx < tt * d; idx += kThreads) {
      const int t = idx / d, c = idx % d;
      const int jj = j0 + t / block_tokens;
      float kv = 0.f, vv = 0.f;
      if (jj < n_blocks) {
        const int64_t row =
            (static_cast<int64_t>(trow[jj]) * block_tokens + t % block_tokens) * h_kv + h;
        kv = load_kv<T, Q>(k_pool, k_scale, row, row * d + c);
        vv = load_kv<T, Q>(v_pool, v_scale, row, row * d + c);
      }
      ks[t * dp + c] = kv;
      vs[t * d + c] = vv;
    }
    __syncthreads();

    // Scores: dot in fp32 over exact T products, rounded to T, then scaled.
    for (int idx = tid; idx < gs * tt; idx += kThreads) {
      const int r = idx / tt, t = idx % tt;
      const int pos = j0 * block_tokens + t;
      const int q_pos = len - s_q + r % s_q;
      float s = kMasked;
      if (pos <= q_pos && pos < n_blocks * block_tokens) {
        const float* qr = qs + r * d;
        const float* kr = ks + t * dp;
        float dot = 0.f;
        for (int c = 0; c < d; ++c) dot = fmaf(qr[c], kr[c], dot);
        s = round_t<T>(dot) * scale;
      }
      ps[idx] = s;
    }
    __syncthreads();

    // Online-softmax update, one warp per folded row.
    for (int r = warp; r < gs; r += n_warps) {
      float* pr = ps + r * tt;
      float mx = kMasked;
      for (int t = lane; t < tt; t += 32) mx = fmaxf(mx, pr[t]);
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_run[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < tt; t += 32) {
        const float s = pr[t];
        const float p = s > kMaskGuard ? expf(s - m_new) : 0.f;
        sum += p;
        pr[t] = round_t<T>(p);
      }
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        alpha[r] = a;
        l_run[r] = a * l_run[r] + sum;
        m_run[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P.V, fp32 accumulation.
    for (int idx = tid; idx < gs * d; idx += kThreads) {
      const int r = idx / d, c = idx % d;
      const float* pr = ps + r * tt;
      float pv = 0.f;
      for (int t = 0; t < tt; ++t) pv = fmaf(pr[t], vs[t * d + c], pv);
      acc[idx] = acc[idx] * alpha[r] + pv;
    }
    __syncthreads();
  }

  for (int idx = tid; idx < gs * d; idx += kThreads) {
    const int r = idx / d, c = idx % d;
    const int g = r / s_q, i = r % s_q;
    const int head = h * group + g;
    out[((static_cast<int64_t>(n) * s_q + i) * n_heads + head) * d + c] =
        from_f<T>(acc[idx] / l_run[r]);
  }
}

template <typename T, bool Q>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ks,
                   const float* vsc, const int* table, const int* lengths, void* out,
                   int n, int s_q, int n_heads, int h_kv, int d, int block_tokens,
                   int nmax, float scale, cudaStream_t stream) {
  const int blocks_per_tile = block_tokens >= kTileTokens ? 1 : kTileTokens / block_tokens;
  const int tt = blocks_per_tile * block_tokens;
  const int gs = (n_heads / h_kv) * s_q;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(gs) * d * 2 + static_cast<size_t>(tt) * (d + 1) +
                       static_cast<size_t>(tt) * d + static_cast<size_t>(gs) * tt + 3 * gs);
  auto kernel = paged_attention_kernel<T, Q>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid(h_kv, n);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), k, v, ks, vsc, table, lengths, static_cast<T*>(out), s_q,
      n_heads, h_kv, d, block_tokens, nmax, blocks_per_tile, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the compute dtype of q, out and a
// non-quantised pool). k_scale/v_scale non-null means int8 pools.
extern "C" int paged_attention(int dtype, const void* q, const void* k_pool,
                               const void* v_pool, const float* k_scale,
                               const float* v_scale, const int* table,
                               const int* lengths, void* out, int n, int s_q,
                               int n_heads, int h_kv, int d, int block_tokens,
                               int nmax, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool quant = k_scale != nullptr;
  if (dtype == 0) {
    return quant ? launch<float, true>(q, k_pool, v_pool, k_scale, v_scale, table, lengths,
                                       out, n, s_q, n_heads, h_kv, d, block_tokens, nmax,
                                       scale, s)
                 : launch<float, false>(q, k_pool, v_pool, k_scale, v_scale, table, lengths,
                                        out, n, s_q, n_heads, h_kv, d, block_tokens, nmax,
                                        scale, s);
  }
  if (dtype == 1) {
    return quant ? launch<__nv_bfloat16, true>(q, k_pool, v_pool, k_scale, v_scale, table,
                                               lengths, out, n, s_q, n_heads, h_kv, d,
                                               block_tokens, nmax, scale, s)
                 : launch<__nv_bfloat16, false>(q, k_pool, v_pool, k_scale, v_scale, table,
                                                lengths, out, n, s_q, n_heads, h_kv, d,
                                                block_tokens, nmax, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
