// Blockwise (flash) attention for training: forward, dQ and dK/dV.
//
// Replaces four TPU kernels of transformer_tpu/kernels/flash_attention.py:
//   flash_fwd        <- `_fwd_kernel`       (online softmax; writes out and the row lse)
//   flash_ring_step  <- `_ring_step_kernel` (the same tile loop, but the (m, l, acc)
//                                            carry is read from and written back to
//                                            device memory in place: one ring hop)
//   flash_dq         <- `_dq_kernel`        (dQ, P recomputed from lse)
//   flash_dkdv       <- `_dkdv_kernel`      (dK and dV, summed over the GQA group)
//
// Layouts are the model's: q/dO/out/dq (B, S_q, H, D), k/v/dk/dv
// (B, S_k, H_kv, D), row-major and contiguous, read in place (no fold to
// (B*H, S, D) in device memory); kv_mask (B, S_k) uint8 or null; lse and
// delta (B, H, S_q) fp32; the ring carry m, l (B, H, S_q) and acc
// (B, S_q, H, D) fp32. Query head h reads kv head h / (H / H_kv).
//
// Numerics mirror the TPU kernels (T = bf16 or fp32): scores are q.k over
// T values with fp32 accumulation (exact products, fp32 FMAs), times the
// scale in fp32; key padding, causality (col > row) and the band
// (col <= row - band) set a score to -1e30, and exp is guarded
// (s > -1e29) so masked entries are exactly 0; the normaliser sums the
// unrounded fp32 p; P.V, dS.K, P^T.dO and (dS*scale)^T.Q take their left
// operand rounded to T and accumulate in fp32. A row with no visible key
// gets out = 0, lse = -1e30 and zero gradients.
//
// Bound on an H100: at long4k (B 4, H 8, S 4095, D 64, causal) the forward
// is 6.9e10 flops against 67 MB of q/k/v/out, far above the ~295 flop/byte
// ridge, so all three kernels are bound by operations (a ring hop at
// C 1024 moves its fp32 carry too and sits near the ridge). What this design
// does about it: 64x64 tiles, 256 threads each owning a 4x4 block of the
// score tile and a 4 x D/16 block of the output, operands staged in shared
// memory as fp32 and read as float4, so each thread does 16 FMAs per two
// shared loads; the score tile, P and dS never leave the chip; tiles above
// the diagonal or below the band are skipped structurally. This first
// version runs on the CUDA cores in fp32, not on the tensor cores, which
// is the known gap to the bf16 bound (mma/wgmma, TMA and pipelining are
// later work). Each output element is written once by one CTA: dQ by the
// CTA of its q tile, dK/dV by the CTA of its k tile walking every
// (group member, q tile) pair, so nothing needs atomics and results do not
// depend on scheduling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e30f;     // flash_attention.py _MASKED
constexpr float kMaskGuard = -1e29f;  // flash_attention.py _MASK_GUARD
constexpr int kTile = 64;             // q and k tile rows
constexpr int kThreads = 256;         // 16 x 16 threads
constexpr int kLd = kTile + 4;        // row stride of transposed [D][tile] buffers

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

// Rows [r0, r0 + 64) of one head of a (B, S, heads, D) tensor into shared
// memory as fp32, zero past `s`: transposed (dst[c * kLd + r]) or natural
// (dst[r * D + c]).
template <typename T, int D, bool Transposed>
__device__ __forceinline__ void load_tile(float* dst, const T* base, int64_t row_stride,
                                          int r0, int s) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const float x = r0 + r < s ? to_f(base[static_cast<int64_t>(r0 + r) * row_stride + c]) : 0.f;
    if (Transposed) {
      dst[c * kLd + r] = x;
    } else {
      dst[r * D + c] = x;
    }
  }
}

// A 4x4 block of a^T b over D: acc[i][j] += sum_d at[d][ri + i] * bt[d][cj + j]
// (both operands transposed, [D][kLd]).
template <int D>
__device__ __forceinline__ void block_dot(float (&acc)[4][4], const float* at, int ri,
                                          const float* bt, int cj) {
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(at + d * kLd + ri);
    const float4 b = *reinterpret_cast<const float4*>(bt + d * kLd + cj);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][c] += sum_t pt[t][ri + i] * vn[t][cj + c] over the tile's 64 rows
// (pt transposed [64][kLd], vn natural [64][D]); DC = D / 16 columns.
template <int D>
__device__ __forceinline__ void block_pv(float (&acc)[4][D / 16], const float* pt, int ri,
                                         const float* vn, int cj) {
  constexpr int DC = D / 16;
#pragma unroll 4
  for (int t = 0; t < kTile; ++t) {
    const float4 a = *reinterpret_cast<const float4*>(pt + t * kLd + ri);
    const float av[4] = {a.x, a.y, a.z, a.w};
    float bv[DC];
#pragma unroll
    for (int c = 0; c < DC; ++c) bv[c] = vn[t * D + cj + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
  }
}

// Reductions over the 16 threads (tx) that share a row: lanes 0-15 and
// 16-31 of a warp are two rows' groups, so xor offsets below 16 stay inside.
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The band is separate from causality, as `_FlashConfig.band` is: a ring
// hop t passes W - t*C, which may be 0 or negative, so `has_band` says
// whether there is one and no value of `band` means "none".
__device__ __forceinline__ bool visible(int row, int col, int causal, int has_band, int band) {
  if (causal && col > row) return false;
  if (has_band && col <= row - band) return false;
  return true;
}

// Key columns [k0, k0 + 64): 1 where the key exists and is not padding.
__device__ __forceinline__ void load_key_flags(float* flags, const uint8_t* kv_mask, int b,
                                               int s_k, int k0) {
  for (int t = threadIdx.x; t < kTile; t += kThreads) {
    const int col = k0 + t;
    const bool ok = col < s_k && (kv_mask == nullptr ||
                                  kv_mask[static_cast<int64_t>(b) * s_k + col] != 0);
    flags[t] = ok ? 1.f : 0.f;
  }
}

// The k tiles a q tile starting at q0 can see. The band's lower edge is
// taken from the tile's first row (`_visible`): its leftmost visible
// column q0 - band + 1 is the leftmost of the tile.
__device__ __forceinline__ void k_tile_range(int q0, int s_k, int causal, int has_band,
                                             int band, int* begin, int* end) {
  int e = (s_k + kTile - 1) / kTile;
  if (causal) e = min(e, (q0 + kTile - 1) / kTile + 1);
  int bgn = 0;
  if (has_band) bgn = max(0, q0 - band + 1) / kTile;
  *begin = bgn;
  *end = e;
}

// ---------------------------------------------------------------------------
// Forward and ring step: one CTA per (q tile, batch * head). The forward
// (Carry = false) starts the row statistics at (m, l, acc) = (-1e30, 0, 0)
// and finalises out = acc / l and lse = m + log l; the ring step (Carry =
// true) reads the carry of its 64 rows from device memory first and writes
// it back unnormalised, so one launch folds one KV chunk into it. Each
// carry row is read and written by the one CTA that owns it, which is what
// makes the in-place update (the TPU kernel's input_output_aliases) safe.

template <typename T, int D, bool Carry>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const uint8_t* __restrict__ kv_mask, T* __restrict__ out,
                 float* __restrict__ lse, float* __restrict__ m_io, float* __restrict__ l_io,
                 float* __restrict__ acc_io, int s_q, int s_k, int h, int h_kv, int causal,
                 int has_band, int band, float scale) {
  constexpr int DC = D / 16;
  const int q0 = blockIdx.x * kTile;
  const int b = blockIdx.y / h, head = blockIdx.y % h;
  const int hk = head / (h / h_kv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  extern __shared__ __align__(16) float smem[];
  float* qt = smem;               // [D][kLd]
  float* kt = qt + D * kLd;       // [D][kLd]
  float* vn = kt + D * kLd;       // [64][D]
  float* pt = vn + kTile * D;     // [64 keys][kLd]: p rounded to T
  float* kflag = pt + kTile * kLd;

  const int64_t qs = static_cast<int64_t>(h) * D, ks = static_cast<int64_t>(h_kv) * D;
  const T* qb = q + static_cast<int64_t>(b) * s_q * qs + head * D;
  const T* kb = k + static_cast<int64_t>(b) * s_k * ks + hk * D;
  const T* vb = v + static_cast<int64_t>(b) * s_k * ks + hk * D;
  load_tile<T, D, true>(qt, qb, qs, q0, s_q);

  const int64_t row_off = (static_cast<int64_t>(b) * h + head) * s_q;  // into (B, H, S_q)
  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
    if (Carry && row < s_q) {
      m[i] = m_io[row_off + row];
      l[i] = l_io[row_off + row];
      const float* arow = acc_io + (static_cast<int64_t>(b) * s_q + row) * qs + head * D;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] = arow[tx * DC + c];
    }
  }

  int kt_begin, kt_end;
  k_tile_range(q0, s_k, causal, has_band, band, &kt_begin, &kt_end);
  for (int tile = kt_begin; tile < kt_end; ++tile) {
    const int k0 = tile * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D, true>(kt, kb, ks, k0, s_k);
    load_tile<T, D, false>(vn, vb, ks, k0, s_k);
    load_key_flags(kflag, kv_mask, b, s_k, k0);
    __syncthreads();

    float s[4][4] = {};
    block_dot<D>(s, qt, ty * 4, kt, tx * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        const bool ok = kflag[tx * 4 + j] != 0.f && visible(row, col, causal, has_band, band);
        s[i][j] = ok ? s[i][j] * scale : kMasked;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] > kMaskGuard ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        pt[(tx * 4 + j) * kLd + ty * 4 + i] = round_t<T>(p);
      }
      const float corr = expf(m[i] - m_new);
      l[i] = corr * l[i] + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
    block_pv<D>(acc, pt, ty * 4, vn, tx * DC);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= s_q) continue;
    if (Carry) {
      float* arow = acc_io + (static_cast<int64_t>(b) * s_q + row) * qs + head * D;
#pragma unroll
      for (int c = 0; c < DC; ++c) arow[tx * DC + c] = acc[i][c];
      if (tx == 0) {
        m_io[row_off + row] = m[i];
        l_io[row_off + row] = l[i];
      }
      continue;
    }
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* orow = out + static_cast<int64_t>(b) * s_q * qs + row * qs + head * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tx * DC + c] = from_f<T>(acc[i][c] / l_safe);
    if (tx == 0) lse[(static_cast<int64_t>(b) * h + head) * s_q + row] = m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// dQ: one CTA per (q tile, batch * head).

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, const uint8_t* __restrict__ kv_mask,
                T* __restrict__ dq, int s_q, int s_k, int h, int h_kv, int causal,
                int has_band, int band, float scale) {
  constexpr int DC = D / 16;
  const int q0 = blockIdx.x * kTile;
  const int b = blockIdx.y / h, head = blockIdx.y % h;
  const int hk = head / (h / h_kv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  extern __shared__ __align__(16) float smem[];
  float* qt = smem;               // [D][kLd]
  float* dot_ = qt + D * kLd;     // [D][kLd] dO transposed
  float* kt = dot_ + D * kLd;     // [D][kLd]
  float* vt = kt + D * kLd;       // [D][kLd]
  float* kn = vt + D * kLd;       // [64][D]
  float* dst = kn + kTile * D;    // [64 keys][kLd]: ds rounded to T
  float* kflag = dst + kTile * kLd;
  float* lse_s = kflag + kTile;   // [64]
  float* delta_s = lse_s + kTile; // [64]

  const int64_t qs = static_cast<int64_t>(h) * D, ks = static_cast<int64_t>(h_kv) * D;
  const int64_t qoff = static_cast<int64_t>(b) * s_q * qs + head * D;
  const T* kb = k + static_cast<int64_t>(b) * s_k * ks + hk * D;
  const T* vb = v + static_cast<int64_t>(b) * s_k * ks + hk * D;
  load_tile<T, D, true>(qt, q + qoff, qs, q0, s_q);
  load_tile<T, D, true>(dot_, dout + qoff, qs, q0, s_q);
  const int64_t roff = (static_cast<int64_t>(b) * h + head) * s_q;
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const bool in = q0 + r < s_q;
    lse_s[r] = in ? lse[roff + q0 + r] : 0.f;
    delta_s[r] = in ? delta[roff + q0 + r] : 0.f;
  }

  float acc[4][DC] = {};
  int kt_begin, kt_end;
  k_tile_range(q0, s_k, causal, has_band, band, &kt_begin, &kt_end);
  for (int tile = kt_begin; tile < kt_end; ++tile) {
    const int k0 = tile * kTile;
    __syncthreads();
    load_tile<T, D, true>(kt, kb, ks, k0, s_k);
    load_tile<T, D, true>(vt, vb, ks, k0, s_k);
    load_tile<T, D, false>(kn, kb, ks, k0, s_k);
    load_key_flags(kflag, kv_mask, b, s_k, k0);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    block_dot<D>(s, qt, ty * 4, kt, tx * 4);
    block_dot<D>(dp, dot_, ty * 4, vt, tx * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        const bool ok =
            row < s_q && kflag[tx * 4 + j] != 0.f && visible(row, col, causal, has_band, band);
        const float sv = ok ? s[i][j] * scale : kMasked;
        const float p = sv > kMaskGuard ? expf(sv - lse_s[r]) : 0.f;
        dst[(tx * 4 + j) * kLd + r] = round_t<T>(p * (dp[i][j] - delta_s[r]));
      }
    }
    __syncthreads();
    block_pv<D>(acc, dst, ty * 4, kn, tx * DC);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= s_q) continue;
    T* drow = dq + qoff + row * qs;
#pragma unroll
    for (int c = 0; c < DC; ++c) drow[tx * DC + c] = from_f<T>(acc[i][c] * scale);
  }
}

// ---------------------------------------------------------------------------
// dK/dV: one CTA per (k tile, batch * kv head), walking (group member,
// q tile) pairs. Thread (ty, tx) owns keys ty*4.. of the transposed score
// tile and queries tx*4.. of it.

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, const uint8_t* __restrict__ kv_mask,
                  T* __restrict__ dk, T* __restrict__ dv, int s_q, int s_k, int h, int h_kv,
                  int causal, int has_band, int band, float scale) {
  constexpr int DC = D / 16;
  const int k0 = blockIdx.x * kTile;
  const int b = blockIdx.y / h_kv, hk = blockIdx.y % h_kv;
  const int group = h / h_kv;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  extern __shared__ __align__(16) float smem[];
  float* kt = smem;               // [D][kLd]
  float* vt = kt + D * kLd;       // [D][kLd]
  float* qt = vt + D * kLd;       // [D][kLd]
  float* dot_ = qt + D * kLd;     // [D][kLd]
  float* qn = dot_ + D * kLd;     // [64][D]
  float* don = qn + kTile * D;    // [64][D]
  float* pn = don + kTile * D;    // [64 queries][kLd]: p rounded to T
  float* dsn = pn + kTile * kLd;  // [64 queries][kLd]: ds * scale rounded to T
  float* kflag = dsn + kTile * kLd;
  float* lse_s = kflag + kTile;
  float* delta_s = lse_s + kTile;

  const int64_t qs = static_cast<int64_t>(h) * D, ks = static_cast<int64_t>(h_kv) * D;
  const int64_t koff = static_cast<int64_t>(b) * s_k * ks + hk * D;
  load_tile<T, D, true>(kt, k + koff, ks, k0, s_k);
  load_tile<T, D, true>(vt, v + koff, ks, k0, s_k);
  load_key_flags(kflag, kv_mask, b, s_k, k0);

  // The q tiles that can see this k tile: under the band, q tile i does
  // while i * 64 <= k0 + 62 + band (its first row's rule, as `_visible`),
  // which may be no tile at all when the band is 0 or negative.
  const int nq = (s_q + kTile - 1) / kTile;
  const int qt_begin = causal ? k0 / kTile : 0;
  int qt_end = nq;
  if (has_band) {
    const int hi = k0 + kTile - 2 + band;
    qt_end = hi < 0 ? 0 : min(nq, hi / kTile + 1);
  }

  float dk_acc[4][DC] = {}, dv_acc[4][DC] = {};
  for (int g = 0; g < group; ++g) {
    const int head = hk * group + g;
    const int64_t qoff = static_cast<int64_t>(b) * s_q * qs + head * D;
    const int64_t roff = (static_cast<int64_t>(b) * h + head) * s_q;
    for (int tile = qt_begin; tile < qt_end; ++tile) {
      const int q0 = tile * kTile;
      __syncthreads();
      load_tile<T, D, true>(qt, q + qoff, qs, q0, s_q);
      load_tile<T, D, true>(dot_, dout + qoff, qs, q0, s_q);
      load_tile<T, D, false>(qn, q + qoff, qs, q0, s_q);
      load_tile<T, D, false>(don, dout + qoff, qs, q0, s_q);
      for (int r = threadIdx.x; r < kTile; r += kThreads) {
        const bool in = q0 + r < s_q;
        lse_s[r] = in ? lse[roff + q0 + r] : 0.f;
        delta_s[r] = in ? delta[roff + q0 + r] : 0.f;
      }
      __syncthreads();

      float s[4][4] = {}, dp[4][4] = {};
      block_dot<D>(s, kt, ty * 4, qt, tx * 4);   // s[i][j] = k_(ty*4+i) . q_(tx*4+j)
      block_dot<D>(dp, vt, ty * 4, dot_, tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = ty * 4 + i, col = k0 + c;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx * 4 + j, row = q0 + r;
          const bool ok = row < s_q && kflag[c] != 0.f && visible(row, col, causal, has_band, band);
          const float sv = ok ? s[i][j] * scale : kMasked;
          const float p = sv > kMaskGuard ? expf(sv - lse_s[r]) : 0.f;
          const float ds = p * (dp[i][j] - delta_s[r]);
          pn[r * kLd + c] = round_t<T>(p);
          dsn[r * kLd + c] = round_t<T>(ds * scale);
        }
      }
      __syncthreads();
      block_pv<D>(dv_acc, pn, ty * 4, don, tx * DC);
      block_pv<D>(dk_acc, dsn, ty * 4, qn, tx * DC);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = k0 + ty * 4 + i;
    if (col >= s_k) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[koff + col * ks + tx * DC + c] = from_f<T>(dk_acc[i][c]);
      dv[koff + col * ks + tx * DC + c] = from_f<T>(dv_acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

constexpr size_t fwd_smem(int d) {
  return sizeof(float) * (2 * d * kLd + kTile * d + kTile * kLd + kTile);
}
constexpr size_t dq_smem(int d) {
  return sizeof(float) * (4 * d * kLd + kTile * d + kTile * kLd + 3 * kTile);
}
constexpr size_t dkdv_smem(int d) {
  return sizeof(float) * (4 * d * kLd + 2 * kTile * d + 2 * kTile * kLd + 3 * kTile);
}

// Carry = false: out and lse are written, the carry pointers are null.
// Carry = true: m, l and acc are updated in place, out and lse are null.
template <typename T, int D, bool Carry>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const uint8_t* mask,
                       void* out, float* lse, float* m, float* l, float* acc, int b, int s_q,
                       int s_k, int h, int h_kv, int causal, int has_band, int band, float scale,
                       cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D, Carry>;
  cudaError_t e = set_smem(kernel, fwd_smem(D));
  if (e != cudaSuccess) return e;
  dim3 grid((s_q + kTile - 1) / kTile, b * h);
  kernel<<<grid, kThreads, fwd_smem(D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<T*>(out), lse, m, l, acc, s_q, s_k, h, h_kv, causal, has_band, band, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_plain_fwd(const void* q, const void* k, const void* v, const uint8_t* mask,
                             void* out, float* lse, int b, int s_q, int s_k, int h, int h_kv,
                             int causal, int has_band, int band, float scale,
                             cudaStream_t stream) {
  return launch_fwd<T, D, false>(q, k, v, mask, out, lse, nullptr, nullptr, nullptr, b, s_q,
                                 s_k, h, h_kv, causal, has_band, band, scale, stream);
}

template <typename T, int D>
cudaError_t launch_ring_step(const void* q, const void* k, const void* v, const uint8_t* mask,
                             float* m, float* l, float* acc, int b, int s_q, int s_k, int h,
                             int h_kv, int causal, int has_band, int band, float scale,
                             cudaStream_t stream) {
  return launch_fwd<T, D, true>(q, k, v, mask, nullptr, nullptr, m, l, acc, b, s_q, s_k, h,
                                h_kv, causal, has_band, band, scale, stream);
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, const uint8_t* mask, void* dq,
                      int b, int s_q, int s_k, int h, int h_kv, int causal, int has_band,
                      int band, float scale, cudaStream_t stream) {
  auto kernel = flash_dq_kernel<T, D>;
  cudaError_t e = set_smem(kernel, dq_smem(D));
  if (e != cudaSuccess) return e;
  dim3 grid((s_q + kTile - 1) / kTile, b * h);
  kernel<<<grid, kThreads, dq_smem(D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, mask, static_cast<T*>(dq), s_q, s_k, h, h_kv,
      causal, has_band, band, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, const uint8_t* mask, void* dk,
                        void* dv, int b, int s_q, int s_k, int h, int h_kv, int causal,
                        int has_band, int band, float scale, cudaStream_t stream) {
  auto kernel = flash_dkdv_kernel<T, D>;
  cudaError_t e = set_smem(kernel, dkdv_smem(D));
  if (e != cudaSuccess) return e;
  dim3 grid((s_k + kTile - 1) / kTile, b * h_kv);
  kernel<<<grid, kThreads, dkdv_smem(D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, mask, static_cast<T*>(dk), static_cast<T*>(dv),
      s_q, s_k, h, h_kv, causal, has_band, band, scale);
  return cudaGetLastError();
}

// Dispatch on (dtype code, head_dim): 0 = float32, 1 = bfloat16; D 32 or 64.
#define FLASH_DISPATCH(FN, ...)                                                  \
  do {                                                                           \
    if (dtype == 0 && d == 32) return FN<float, 32>(__VA_ARGS__);                \
    if (dtype == 0 && d == 64) return FN<float, 64>(__VA_ARGS__);                \
    if (dtype == 1 && d == 32) return FN<__nv_bfloat16, 32>(__VA_ARGS__);        \
    if (dtype == 1 && d == 64) return FN<__nv_bfloat16, 64>(__VA_ARGS__);        \
    return static_cast<int>(cudaErrorInvalidValue);                              \
  } while (0)

bool bad_shape(int b, int s_q, int s_k, int h, int h_kv) {
  return b < 1 || s_q < 1 || s_k < 1 || h_kv < 1 || h % h_kv != 0 || b * h > 65535;
}

}  // namespace

extern "C" int flash_fwd(int dtype, const void* q, const void* k, const void* v,
                         const uint8_t* kv_mask, void* out, float* lse, int b, int s_q,
                         int s_k, int h, int h_kv, int d, int causal, int has_band, int band,
                         float scale, void* stream) {
  if (bad_shape(b, s_q, s_k, h, h_kv)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_plain_fwd, q, k, v, kv_mask, out, lse, b, s_q, s_k, h, h_kv, causal,
                 has_band, band, scale, st);
}

extern "C" int flash_ring_step(int dtype, const void* q, const void* k, const void* v,
                               const uint8_t* kv_mask, float* m, float* l, float* acc, int b,
                               int s_q, int s_k, int h, int h_kv, int d, int causal,
                               int has_band, int band, float scale, void* stream) {
  if (bad_shape(b, s_q, s_k, h, h_kv)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_ring_step, q, k, v, kv_mask, m, l, acc, b, s_q, s_k, h, h_kv, causal,
                 has_band, band, scale, st);
}

extern "C" int flash_dq(int dtype, const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, const float* delta,
                        const uint8_t* kv_mask, void* dq, int b, int s_q, int s_k, int h,
                        int h_kv, int d, int causal, int has_band, int band, float scale,
                        void* stream) {
  if (bad_shape(b, s_q, s_k, h, h_kv)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_dq, q, k, v, dout, lse, delta, kv_mask, dq, b, s_q, s_k, h, h_kv,
                 causal, has_band, band, scale, st);
}

extern "C" int flash_dkdv(int dtype, const void* q, const void* k, const void* v,
                          const void* dout, const float* lse, const float* delta,
                          const uint8_t* kv_mask, void* dk, void* dv, int b, int s_q, int s_k,
                          int h, int h_kv, int d, int causal, int has_band, int band,
                          float scale, void* stream) {
  if (bad_shape(b, s_q, s_k, h, h_kv) || b * h_kv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_dkdv, q, k, v, dout, lse, delta, kv_mask, dk, dv, b, s_q, s_k, h,
                 h_kv, causal, has_band, band, scale, st);
}
