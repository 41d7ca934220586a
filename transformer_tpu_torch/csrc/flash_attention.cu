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
// T values with fp32 accumulation (exact products summed in fp32), times the
// scale in fp32; key padding, causality (col > row) and the band
// (col <= row - band) set a score to -1e30, and exp is guarded
// (s > -1e29) so masked entries are exactly 0; the normaliser sums the
// unrounded fp32 p; P.V, dS.K, P^T.dO and (dS*scale)^T.Q take their left
// operand rounded to T and accumulate in fp32. A row with no visible key
// gets out = 0, lse = -1e30 and zero gradients.
//
// Bound on an H100: at long4k (B 4, H 8, S 4095, D 64, causal) the forward
// is 6.9e10 flops against 67 MB of q/k/v/out, far above the ~295 flop/byte
// ridge, so the kernels are bound by operations (a ring hop at C 1024 moves
// its fp32 carry too and sits near the ridge). Each output element is
// written once by one CTA: out/lse and dQ by the CTA of their q tile, dK/dV
// by the CTA of their k tile walking every (group member, q tile) pair, so
// nothing needs atomics and results do not depend on scheduling. Tiles
// above the diagonal or below the band are skipped structurally; the score
// tile, P and dS never leave the chip.
//
// bf16 flash_fwd, flash_ring_step, flash_dq and flash_dkdv run on the
// tensor cores (the bf16 rate is 989 TFLOP/s there, 67 outside), the TPU
// kernels' bf16 x bf16 -> fp32 products taken by `wgmma` (hopper.cuh). A
// CTA is one warpgroup of 128 threads that owns 64 query rows (forward,
// ring step, dQ) or 64 keys (dK/dV), several CTAs resident per SM (two
// warpgroups sharing each streamed tile were slower in the forward and
// dK/dV, PERF.md). The tiles that stay (Q in the forward, Q and dO in dQ,
// K and V in dK/dV) arrive once; the ones that stream (K/V in the forward
// and dQ, Q/dO plus the pair's lse/delta in dK/dV) go through a 2-stage
// ring in shared memory, filled by TMA from one thread, completion counted on an
// mbarrier per stage, the next tile in flight while the current one is
// multiplied. Tiles sit in shared memory in the 128-byte (D 64) or 64-byte
// (D 32) swizzle that the TMA map and the wgmma descriptors both name.
// Forward: S = Q.K^T over tiles of 64 keys (K-major operands from shared
// memory), the online softmax in registers on the accumulator layout (a
// row's 16 columns per thread, 4 threads a row; scores in log2 units so
// that each p is one SFU exp2), P rounded to bf16 and fed straight back as
// the register A operand of O += P.V (V read MN-major through the
// transpose bit). Masks cost nothing where nothing is masked: a ballot of
// each tile's key flags decides per tile, so only the diagonal, the band's
// edge, the ragged end and tiles holding padding take the masked path.
// The ring step is the forward's kernel with its Carry flag set: the
// (m, l, acc) carry is read before the k-tile loop, acc straight into the
// accumulator's registers, and written back after it unnormalised.
// dK/dV: S^T = K.Q^T and dP^T = V.dO^T from shared memory, P^T and
// dS^T in registers, then dV += bf16(P^T).dO and dK += bf16(dS^T.scale).Q
// with A from registers and dO, Q MN-major. dQ: S = Q.K^T and dP = dO.V^T
// from shared memory, dS = P(dP - delta) rounded to bf16 in registers, then
// dQ += dS.K with K MN-major, and the scale applied to the fp32 sum once at
// the end (the TPU kernel's order: dS is rounded before the scale, unlike
// dK's). The tiles of a CTA are on the slow grid axis, longest first.
//
// fp32 stays on CUDA-core loops, on purpose: on the tensor cores fp32 runs
// as TF32, about three decimal digits, and fp32 is this port's checking
// dtype (its 1e-4 kernel limits and the 1e-5 train-step limit against the
// plain versions). Those loops: 64x64 tiles, 256 threads each owning a 4x4
// block of the score tile and a 4 x D/16 block of the output, operands
// staged in shared memory as fp32 and read as float4, so each thread does
// 16 FMAs per two shared loads. The fp32 ring step is that forward loop
// with its Carry flag set.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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
// bf16 forward and dK/dV on the tensor cores (see the note at the top).
//
// Inside a warpgroup, warp w owns accumulator rows 16w..16w+15 of the
// 64-row tile; lane l holds rows g = l/4 and g + 8 and, in each 8-column
// block j, columns 8j + 2(l%4) + {0, 1}: d[4j], d[4j+1] on row g and
// d[4j+2], d[4j+3] on row g + 8. The 16 columns of k-block kb of such an
// accumulator, packed to bf16 pairs, are exactly the A fragment of an
// m64nNk16 wgmma: {d[8kb], d[8kb+1]}, {d[8kb+2], d[8kb+3]}, {d[8kb+4],
// d[8kb+5]}, {d[8kb+6], d[8kb+7]}.

constexpr int kWgRows = 64;  // accumulator rows of one warpgroup; keys or queries of a tile

template <int D>
struct TcTile {
  static constexpr uint32_t kRowBytes = D * 2;
  static constexpr uint32_t kBytes = kWgRows * kRowBytes;  // one [64][D] bf16 tile
  static constexpr uint32_t kLayout = D == 64 ? hopper::kSwizzle128B : hopper::kSwizzle64B;
  static constexpr uint32_t kAtomBytes = 8 * kRowBytes;  // 8 rows: one swizzle pattern

  // A [rows][D] tile as an operand whose reduction runs over d (K-major):
  // 8-row groups kAtomBytes apart; k-step kk (16 columns) starts 32 bytes on.
  static __device__ __forceinline__ uint64_t k_major(const uint8_t* tile, int kk) {
    return hopper::smem_desc(tile + kk * 32, 16, kAtomBytes, kLayout);
  }
  // A [rows][D] tile as the B operand of a product that reduces over its
  // rows (MN-major, the transpose bit set): N = D fits one swizzle pattern,
  // 8-row groups kAtomBytes apart; k-step kk starts 16 rows on.
  static __device__ __forceinline__ uint64_t mn_major(const uint8_t* tile, int kk) {
    return hopper::smem_desc(tile + kk * 16 * kRowBytes, kAtomBytes, kAtomBytes, kLayout);
  }
};

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t{1023});
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Keys per K/V tile of the bf16 forward.
constexpr int kFwdKeys = 64;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
constexpr size_t fwd_tc_smem() {
  // align slack, Q [64][D], K and V [2 stages][kFwdKeys][D], 3 barriers,
  // key flags [2 stages] x kFwdKeys bits
  return 1024 + (kWgRows + 4 * kFwdKeys) * TcTile<D>::kRowBytes + 3 * 8 + kFwdKeys / 4;
}

// The accumulator's k-blocks of 16 columns as A fragments, rounded to bf16.
template <int N>
__device__ __forceinline__ void to_a_frags(const float (&d)[N], uint32_t (&a)[N / 8][4]) {
#pragma unroll
  for (int kb = 0; kb < N / 8; ++kb)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kb][r] = hopper::pack_bf16(d[8 * kb + 2 * r], d[8 * kb + 2 * r + 1]);
}

// Bit t of word t / 32: key k0 + t exists and is not padding. Called by the
// first kFwdKeys threads, whole warps; lane 0 of each stores its word.
__device__ __forceinline__ void key_flags(uint32_t* dst, const uint8_t* mask_row, int s_k,
                                          int k0) {
  const int t = threadIdx.x;
  const int col = k0 + t;
  const bool ok = col < s_k && (mask_row == nullptr || mask_row[col] != 0);
  const uint32_t bits = __ballot_sync(0xffffffffu, ok);
  if (t % 32 == 0) dst[t / 32] = bits;
}

// Forward and ring step: one CTA per (batch * head, 64 query rows). The q
// tiles run last first, on the slow grid axis, so that under causality the
// longest CTAs of every head start first and the tail of the grid is short.
// Scores are kept in log2 units (the scale times log2 e), so that each p
// is one exp2 on the SFU; lse goes back to natural units at the end. The
// forward (Carry = false) starts each row at (m, l, acc) = (-1e30, 0, 0)
// and writes out = acc / l and lse; the ring step (Carry = true) reads the
// carry of its rows first (m in natural units, taken to log2 units; acc
// straight into the accumulator's registers) and writes it back
// unnormalised, m in natural units again. A row whose running maximum the
// hop leaves where it was (every key it sees scores below it, or it sees
// none: a chunk of padding only) writes back the m it read, bit for bit,
// so a padding-only chunk leaves the whole carry as it found it; the
// sentinel m = -1e30 is such a row until it sees a key. Each carry row is
// read and written by the CTA that owns it,
// so the in-place update needs no atomics. A ring CTA that sees no k tile
// returns at once: its carry stays as it is and it issues no TMA.
template <int D, bool Carry>
__global__ void __launch_bounds__(128)
flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const uint8_t* __restrict__ kv_mask, __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, float* __restrict__ m_io,
                       float* __restrict__ l_io, float* __restrict__ acc_io, int s_q, int s_k,
                       int h, int h_kv, int causal, int has_band, int band, float scale) {
  using T = TcTile<D>;
  constexpr int kN = kFwdKeys;
  constexpr uint32_t kKvBytes = kN * T::kRowBytes;  // one K or V tile
  constexpr int kWords = kN / 32;                   // key-flag words per tile
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWgRows;
  const int b = blockIdx.x / h, head = blockIdx.x % h;
  const int hk = head / (h / h_kv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = q0 + warp * 16 + lane / 4;      // this thread's rows r0 and r0 + 8
  const int c0 = 2 * (lane % 4);                 // and columns 8j + c0 + {0, 1}
  const float scale2 = scale * kLog2e;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = align_1024(smem_raw);            // [64][D]
  uint8_t* sk = sq + T::kBytes;                  // [2][kN][D]
  uint8_t* sv = sk + 2 * kKvBytes;               // [2][kN][D]
  uint64_t* bar = reinterpret_cast<uint64_t*>(sv + 2 * kKvBytes);  // q, stage 0, stage 1
  uint32_t* kbits = reinterpret_cast<uint32_t*>(bar + 3);          // [2 stages][kWords]
  const uint8_t* mask_row = kv_mask == nullptr ? nullptr : kv_mask + static_cast<int64_t>(b) * s_k;

  // k tiles: k_tile_range (first row for the band, last row for
  // causality), in tiles of kN keys
  int kt_begin = 0, kt_end = (s_k + kN - 1) / kN;
  if (causal) kt_end = min(kt_end, (q0 + kWgRows - 1) / kN + 1);
  if (has_band) kt_begin = max(0, q0 - band + 1) / kN;
  const int n = max(0, kt_end - kt_begin);
  if (Carry && n == 0) return;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) hopper::mbar_init(&bar[i], 1);
    hopper::fence_barrier_init();
  }
  if (tid < kN && n > 0) key_flags(kbits, mask_row, s_k, kt_begin * kN);
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(&bar[0], T::kBytes);
    hopper::tma_load_4d(sq, &tm_q, &bar[0], 0, head, q0, b);
    if (n > 0) {
      hopper::mbar_expect_tx(&bar[1], 2 * kKvBytes);
      hopper::tma_load_4d(sk, &tm_k, &bar[1], 0, hk, kt_begin * kN, b);
      hopper::tma_load_4d(sv, &tm_v, &bar[1], 0, hk, kt_begin * kN, b);
    }
  }
  __syncwarp();

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};  // m in log2 units
  float m_read[2] = {kMasked, kMasked}, m_read2[2] = {kMasked, kMasked};  // the carry's m, as read and in log2
  const int64_t qs = static_cast<int64_t>(h) * D;
  const int64_t stat_row = (static_cast<int64_t>(b) * h + head) * s_q;  // into (B, H, S_q)
  if (Carry) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 8 * i;
      if (row >= s_q) continue;
      const float mi = m_io[stat_row + row];
      m[i] = mi == kMasked ? kMasked : mi * kLog2e;
      m_read[i] = mi;
      m_read2[i] = m[i];
      l[i] = l_io[stat_row + row];
      const float* arow = acc_io + (static_cast<int64_t>(b) * s_q + row) * qs + head * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float2 a = *reinterpret_cast<const float2*>(arow + 8 * j + c0);
        o[4 * j + 2 * i] = a.x;
        o[4 * j + 2 * i + 1] = a.y;
      }
    }
  }
  hopper::mbar_wait(&bar[0], 0);

  for (int it = 0; it < n; ++it) {
    const int stage = it & 1;
    const int k0 = (kt_begin + it) * kN;
    if (tid == 0 && it + 1 < n) {  // the next tile into the other stage, freed last iteration
      uint64_t* nb = &bar[1 + (stage ^ 1)];
      hopper::mbar_expect_tx(nb, 2 * kKvBytes);
      hopper::tma_load_4d(sk + (stage ^ 1) * kKvBytes, &tm_k, nb, 0, hk, k0 + kN, b);
      hopper::tma_load_4d(sv + (stage ^ 1) * kKvBytes, &tm_v, nb, 0, hk, k0 + kN, b);
    }
    __syncwarp();
    if (tid < kN && it + 1 < n) key_flags(kbits + kWords * (stage ^ 1), mask_row, s_k, k0 + kN);
    hopper::mbar_wait(&bar[1 + stage], (it >> 1) & 1);
    const uint8_t* k_tile = sk + stage * kKvBytes;
    const uint8_t* v_tile = sv + stage * kKvBytes;

    float s[kN / 2];
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) s[i] = 0.f;
    hopper::fence_regs(s);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_ss(s, T::k_major(sq, kk), T::k_major(k_tile, kk), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);

    // Masks only where the tile needs them: a key that is padding or
    // past s_k, the diagonal, the band's edge.
    uint32_t keys[kWords];
    bool all_keys = true;
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      keys[w] = kbits[kWords * stage + w];
      all_keys = all_keys && keys[w] == ~0u;
    }
    const bool pos_mask = (causal && k0 + kN - 1 > q0) ||
                          (has_band && k0 <= q0 + kWgRows - 1 - band);
    const bool need_mask = pos_mask || !all_keys;
    float mx[2] = {kMasked, kMasked};
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = 8 * j + c0 + e;  // in word j / 4, bit t % 32
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float& x = s[4 * j + 2 * i + e];
          const bool ok = !need_mask ||
                          (((keys[j / 4] >> (t % 32)) & 1) != 0 &&
                           (!pos_mask || visible(r0 + 8 * i, k0 + t, causal, has_band, band)));
          x = ok ? x * scale2 : kMasked;
          mx[i] = fmaxf(mx[i], x);
        }
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      corr[i] = hopper::exp2_approx(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * i + e];
          x = x > kMaskGuard ? hopper::exp2_approx(x - m[i]) : 0.f;
          sum[i] += x;
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = corr[i] * l[i] + quad_sum(sum[i]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        o[4 * j + 2 * i] *= corr[i];
        o[4 * j + 2 * i + 1] *= corr[i];
      }

    uint32_t p[kN / 16][4];
    to_a_frags(s, p);
    hopper::fence_regs(o);
    hopper::fence_frags(p);
    hopper::wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < kN / 16; ++kb) hopper::wgmma_rs(o, p[kb], T::mn_major(v_tile, kb));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= s_q) continue;
    if (Carry) {
      float* arow = acc_io + (static_cast<int64_t>(b) * s_q + row) * qs + head * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(arow + 8 * j + c0) =
            make_float2(o[4 * j + 2 * i], o[4 * j + 2 * i + 1]);
      if (lane % 4 == 0) {
        // The running maximum only grows: unchanged means equal.
        m_io[stat_row + row] = m[i] == m_read2[i] ? m_read[i] : m[i] * kLn2;
        l_io[stat_row + row] = l[i];
      }
      continue;
    }
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    __nv_bfloat16* orow = out + (static_cast<int64_t>(b) * s_q + row) * qs + head * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(orow + 8 * j + c0) =
          hopper::pack_bf16(o[4 * j + 2 * i] / l_safe, o[4 * j + 2 * i + 1] / l_safe);
    }
    // A row that saw no key keeps m = -1e30 and l = 0: lse = -1e30 exactly.
    if (lane % 4 == 0)
      lse[stat_row + row] = m[i] == kMasked ? kMasked : (m[i] + log2f(l_safe)) * kLn2;
  }
}

template <int D>
constexpr size_t dkdv_tc_smem() {
  // align slack, K and V [64][D], Q and dO [2 stages][64][D], lse and
  // delta [2 stages][64] fp32, 3 barriers
  return 1024 + 6 * TcTile<D>::kBytes + 4 * kWgRows * 4 + 64;
}

// dK/dV: one CTA per (batch * kv head, 64 keys), walking (group
// member, visible q tile) pairs; k tiles on the slow grid axis, first
// first (under causality the longest). Accumulator rows are keys, columns
// queries.
template <int D>
__global__ void __launch_bounds__(128)
flash_dkdv_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const uint8_t* __restrict__ kv_mask, __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int s_q, int s_k, int h, int h_kv,
                        int causal, int has_band, int band, float scale) {
  using T = TcTile<D>;
  const int k0 = blockIdx.y * kWgRows;
  const int b = blockIdx.x / h_kv, hk = blockIdx.x % h_kv;
  const int group = h / h_kv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kr0 = k0 + warp * 16 + lane / 4;     // this thread's keys kr0 and kr0 + 8
  const int c0 = 2 * (lane % 4);                 // and query columns 8j + c0 + {0, 1}

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sk = align_1024(smem_raw);            // [64][D]
  uint8_t* sv = sk + T::kBytes;                  // [64][D]
  uint8_t* sq = sv + T::kBytes;                  // [2][64][D]
  uint8_t* sdo = sq + 2 * T::kBytes;             // [2][64][D]
  float* s_lse = reinterpret_cast<float*>(sdo + 2 * T::kBytes);  // [2][64]
  float* s_delta = s_lse + 2 * kWgRows;                          // [2][64]
  uint64_t* bar = reinterpret_cast<uint64_t*>(s_delta + 2 * kWgRows);  // k/v, stage 0, stage 1

  // The q tiles that can see the CTA's keys (as the CUDA-core kernel): a
  // band of 0 or less may leave none.
  const int nq = (s_q + kTile - 1) / kTile;
  const int qt_begin = causal ? k0 / kTile : 0;
  int qt_end = nq;
  if (has_band) {
    const int hi = k0 + kWgRows - 2 + band;
    qt_end = hi < 0 ? 0 : min(nq, hi / kTile + 1);
  }
  const int nqt = max(0, qt_end - qt_begin);
  const int npairs = group * nqt;

  // Pair p: query head hk * group + p / nqt, q tile qt_begin + p % nqt.
  auto fetch = [&](int p, int slot) {
    const int head = hk * group + p / nqt, q0 = (qt_begin + p % nqt) * kTile;
    if (tid == 0) {
      hopper::mbar_expect_tx(&bar[1 + slot], 2 * T::kBytes);
      hopper::tma_load_4d(sq + slot * T::kBytes, &tm_q, &bar[1 + slot], 0, head, q0, b);
      hopper::tma_load_4d(sdo + slot * T::kBytes, &tm_do, &bar[1 + slot], 0, head, q0, b);
    }
    __syncwarp();
    const int r = tid % kWgRows;
    const int64_t off = (static_cast<int64_t>(b) * h + head) * s_q + q0 + r;
    const bool in = q0 + r < s_q;
    if (tid < kWgRows) {
      s_lse[slot * kWgRows + r] = in ? lse[off] : 0.f;
    } else {
      s_delta[slot * kWgRows + r] = in ? delta[off] : 0.f;
    }
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) hopper::mbar_init(&bar[i], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(&bar[0], 2 * T::kBytes);
    hopper::tma_load_4d(sk, &tm_k, &bar[0], 0, hk, k0, b);
    hopper::tma_load_4d(sv, &tm_v, &bar[0], 0, hk, k0, b);
  }
  __syncwarp();
  if (npairs > 0) fetch(0, 0);

  bool key_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kr0 + 8 * i;
    key_ok[i] = key < s_k && (kv_mask == nullptr || kv_mask[static_cast<int64_t>(b) * s_k + key] != 0);
  }
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  __syncthreads();  // pair 0's lse and delta
  hopper::mbar_wait(&bar[0], 0);

  for (int p = 0; p < npairs; ++p) {
    const int stage = p & 1;
    const int q0 = (qt_begin + p % nqt) * kTile;
    if (p + 1 < npairs) fetch(p + 1, stage ^ 1);  // into the stage freed last iteration
    hopper::mbar_wait(&bar[1 + stage], (p >> 1) & 1);
    const uint8_t* q_tile = sq + stage * T::kBytes;
    const uint8_t* do_tile = sdo + stage * T::kBytes;

    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_ss(st, T::k_major(sk, kk), T::k_major(q_tile, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_ss(dpt, T::k_major(sv, kk), T::k_major(do_tile, kk), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);

    const bool need_mask = q0 + kTile > s_q || (causal && k0 + kWgRows - 1 > q0) ||
                           (has_band && k0 <= q0 + kTile - 1 - band);
    const float* lse_t = s_lse + stage * kWgRows;
    const float* delta_t = s_delta + stage * kWgRows;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + c0 + e, row = q0 + c;
        const float row_lse = lse_t[c], row_delta = delta_t[c];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int idx = 4 * j + 2 * i + e;
          const bool ok = key_ok[i] && (!need_mask || (row < s_q &&
                                        visible(row, kr0 + 8 * i, causal, has_band, band)));
          const float sv_ = ok ? st[idx] * scale : kMasked;
          const float pv = sv_ > kMaskGuard ? __expf(sv_ - row_lse) : 0.f;
          st[idx] = pv;
          dpt[idx] = pv * (dpt[idx] - row_delta) * scale;
        }
      }
    uint32_t pa[4][4], dsa[4][4];
    to_a_frags(st, pa);
    to_a_frags(dpt, dsa);
    hopper::fence_regs(dv_acc);
    hopper::fence_regs(dk_acc);
    hopper::fence_frags(pa);
    hopper::fence_frags(dsa);
    hopper::wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) hopper::wgmma_rs(dv_acc, pa[kb], T::mn_major(do_tile, kb));
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) hopper::wgmma_rs(dk_acc, dsa[kb], T::mn_major(q_tile, kb));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dv_acc);
    hopper::fence_regs(dk_acc);
    __syncthreads();  // this stage's tiles and rows are free, the next pair's rows are in
  }

  const int64_t ks = static_cast<int64_t>(h_kv) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kr0 + 8 * i;
    if (key >= s_k) continue;
    const int64_t off = (static_cast<int64_t>(b) * s_k + key) * ks + hk * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * j + c0) =
          hopper::pack_bf16(dk_acc[4 * j + 2 * i], dk_acc[4 * j + 2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * j + c0) =
          hopper::pack_bf16(dv_acc[4 * j + 2 * i], dv_acc[4 * j + 2 * i + 1]);
    }
  }
}

template <int D>
constexpr size_t dq_tc_smem() {
  // align slack, Q and dO [64][D], K and V [2 stages][64][D], 3 barriers,
  // key flags [2 stages] x 64 bits
  return 1024 + 6 * TcTile<D>::kBytes + 3 * 8 + kWgRows / 4;
}

// dQ: one CTA per (batch * head, 64 query rows), walking the visible k
// tiles (k_tile_range) through the 2-stage ring; q tiles on the slow grid
// axis, last first, as the forward. Accumulator rows are queries, columns
// keys (S, dP) or d (dQ).
template <int D>
__global__ void __launch_bounds__(128)
flash_dq_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      const uint8_t* __restrict__ kv_mask, __nv_bfloat16* __restrict__ dq,
                      int s_q, int s_k, int h, int h_kv, int causal, int has_band, int band,
                      float scale) {
  using T = TcTile<D>;
  constexpr int kN = kTile;       // keys per K/V tile
  constexpr int kWords = kN / 32;  // key-flag words per tile
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWgRows;
  const int b = blockIdx.x / h, head = blockIdx.x % h;
  const int hk = head / (h / h_kv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = q0 + warp * 16 + lane / 4;      // this thread's rows r0 and r0 + 8
  const int c0 = 2 * (lane % 4);                 // and columns 8j + c0 + {0, 1}

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = align_1024(smem_raw);            // [64][D]
  uint8_t* sdo = sq + T::kBytes;                 // [64][D]
  uint8_t* sk = sdo + T::kBytes;                 // [2][kN][D]
  uint8_t* sv = sk + 2 * T::kBytes;              // [2][kN][D]
  uint64_t* bar = reinterpret_cast<uint64_t*>(sv + 2 * T::kBytes);  // q/dO, stage 0, stage 1
  uint32_t* kbits = reinterpret_cast<uint32_t*>(bar + 3);           // [2 stages][kWords]
  const uint8_t* mask_row = kv_mask == nullptr ? nullptr : kv_mask + static_cast<int64_t>(b) * s_k;

  int kt_begin, kt_end;
  k_tile_range(q0, s_k, causal, has_band, band, &kt_begin, &kt_end);
  const int n = max(0, kt_end - kt_begin);  // 0: a band of 0 or less left no key

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) hopper::mbar_init(&bar[i], 1);
    hopper::fence_barrier_init();
  }
  if (tid < kN && n > 0) key_flags(kbits, mask_row, s_k, kt_begin * kN);
  __syncthreads();
  if (tid == 0 && n > 0) {
    hopper::mbar_expect_tx(&bar[0], 2 * T::kBytes);
    hopper::tma_load_4d(sq, &tm_q, &bar[0], 0, head, q0, b);
    hopper::tma_load_4d(sdo, &tm_do, &bar[0], 0, head, q0, b);
    hopper::mbar_expect_tx(&bar[1], 2 * T::kBytes);
    hopper::tma_load_4d(sk, &tm_k, &bar[1], 0, hk, kt_begin * kN, b);
    hopper::tma_load_4d(sv, &tm_v, &bar[1], 0, hk, kt_begin * kN, b);
  }
  __syncwarp();

  // This thread's rows' lse and delta; rows past s_q read 0 and are never
  // written (their dS touches no other row's dQ).
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    const int64_t off = (static_cast<int64_t>(b) * h + head) * s_q + row;
    row_lse[i] = row < s_q ? lse[off] : 0.f;
    row_delta[i] = row < s_q ? delta[off] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  if (n > 0) hopper::mbar_wait(&bar[0], 0);

  for (int it = 0; it < n; ++it) {
    const int stage = it & 1;
    const int k0 = (kt_begin + it) * kN;
    if (tid == 0 && it + 1 < n) {  // the next tile into the other stage, freed last iteration
      uint64_t* nb = &bar[1 + (stage ^ 1)];
      hopper::mbar_expect_tx(nb, 2 * T::kBytes);
      hopper::tma_load_4d(sk + (stage ^ 1) * T::kBytes, &tm_k, nb, 0, hk, k0 + kN, b);
      hopper::tma_load_4d(sv + (stage ^ 1) * T::kBytes, &tm_v, nb, 0, hk, k0 + kN, b);
    }
    __syncwarp();
    if (tid < kN && it + 1 < n) key_flags(kbits + kWords * (stage ^ 1), mask_row, s_k, k0 + kN);
    hopper::mbar_wait(&bar[1 + stage], (it >> 1) & 1);
    const uint8_t* k_tile = sk + stage * T::kBytes;
    const uint8_t* v_tile = sv + stage * T::kBytes;

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_ss(s, T::k_major(sq, kk), T::k_major(k_tile, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_ss(dp, T::k_major(sdo, kk), T::k_major(v_tile, kk), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);

    // Masks only where the tile needs them (as the forward).
    uint32_t keys[kWords];
    bool all_keys = true;
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      keys[w] = kbits[kWords * stage + w];
      all_keys = all_keys && keys[w] == ~0u;
    }
    const bool pos_mask = (causal && k0 + kN - 1 > q0) ||
                          (has_band && k0 <= q0 + kWgRows - 1 - band);
    const bool need_mask = pos_mask || !all_keys;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = 8 * j + c0 + e;  // in word j / 4, bit t % 32
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int idx = 4 * j + 2 * i + e;
          const bool ok = !need_mask ||
                          (((keys[j / 4] >> (t % 32)) & 1) != 0 &&
                           (!pos_mask || visible(r0 + 8 * i, k0 + t, causal, has_band, band)));
          const float sv_ = ok ? s[idx] * scale : kMasked;
          const float p = sv_ > kMaskGuard ? __expf(sv_ - row_lse[i]) : 0.f;
          s[idx] = p * (dp[idx] - row_delta[i]);  // dS, rounded to bf16 by to_a_frags
        }
      }
    uint32_t ds[kN / 16][4];
    to_a_frags(s, ds);
    hopper::fence_regs(acc);
    hopper::fence_frags(ds);
    hopper::wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < kN / 16; ++kb) hopper::wgmma_rs(acc, ds[kb], T::mn_major(k_tile, kb));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  const int64_t qs = static_cast<int64_t>(h) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= s_q) continue;
    __nv_bfloat16* drow = dq + (static_cast<int64_t>(b) * s_q + row) * qs + head * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(drow + 8 * j + c0) =
          hopper::pack_bf16(acc[4 * j + 2 * i] * scale, acc[4 * j + 2 * i + 1] * scale);
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

// As launch_fwd: Carry = false writes out and lse, Carry = true updates
// m, l and acc in place.
template <int D, bool Carry>
cudaError_t launch_fwd_wgmma(const void* q, const void* k, const void* v, const uint8_t* mask,
                             void* out, float* lse, float* m, float* l, float* acc, int b,
                             int s_q, int s_k, int h, int h_kv, int causal, int has_band,
                             int band, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t e = hopper_host::encode_rows(&tq, q, b, s_q, h, D, kWgRows);
  if (e == cudaSuccess) e = hopper_host::encode_rows(&tk, k, b, s_k, h_kv, D, kFwdKeys);
  if (e == cudaSuccess) e = hopper_host::encode_rows(&tv, v, b, s_k, h_kv, D, kFwdKeys);
  if (e != cudaSuccess) return e;
  auto kernel = flash_fwd_kernel_wgmma<D, Carry>;
  const size_t smem = fwd_tc_smem<D>();
  e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(b * h, (s_q + kWgRows - 1) / kWgRows);
  kernel<<<grid, 128, smem, stream>>>(tq, tk, tv, mask, static_cast<__nv_bfloat16*>(out), lse,
                                      m, l, acc, s_q, s_k, h, h_kv, causal, has_band, band,
                                      scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v, const uint8_t* mask,
                          void* out, float* lse, int b, int s_q, int s_k, int h, int h_kv,
                          int causal, int has_band, int band, float scale, cudaStream_t stream) {
  return launch_fwd_wgmma<D, false>(q, k, v, mask, out, lse, nullptr, nullptr, nullptr, b, s_q,
                                    s_k, h, h_kv, causal, has_band, band, scale, stream);
}

template <int D>
cudaError_t launch_ring_step_tc(const void* q, const void* k, const void* v, const uint8_t* mask,
                                float* m, float* l, float* acc, int b, int s_q, int s_k, int h,
                                int h_kv, int causal, int has_band, int band, float scale,
                                cudaStream_t stream) {
  return launch_fwd_wgmma<D, true>(q, k, v, mask, nullptr, nullptr, m, l, acc, b, s_q, s_k, h,
                                   h_kv, causal, has_band, band, scale, stream);
}

template <int D>
cudaError_t launch_dq_tc(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, const uint8_t* mask, void* dq,
                         int b, int s_q, int s_k, int h, int h_kv, int causal, int has_band,
                         int band, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t e = hopper_host::encode_rows(&tq, q, b, s_q, h, D, kWgRows);
  if (e == cudaSuccess) e = hopper_host::encode_rows(&tdo, dout, b, s_q, h, D, kWgRows);
  if (e == cudaSuccess) e = hopper_host::encode_rows(&tk, k, b, s_k, h_kv, D, kTile);
  if (e == cudaSuccess) e = hopper_host::encode_rows(&tv, v, b, s_k, h_kv, D, kTile);
  if (e != cudaSuccess) return e;
  auto kernel = flash_dq_kernel_wgmma<D>;
  const size_t smem = dq_tc_smem<D>();
  e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(b * h, (s_q + kWgRows - 1) / kWgRows);
  kernel<<<grid, 128, smem, stream>>>(tq, tk, tv, tdo, lse, delta, mask,
                                      static_cast<__nv_bfloat16*>(dq), s_q, s_k, h, h_kv, causal,
                                      has_band, band, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkdv_tc(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, const uint8_t* mask, void* dk,
                           void* dv, int b, int s_q, int s_k, int h, int h_kv, int causal,
                           int has_band, int band, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t e = hopper_host::encode_rows(&tq, q, b, s_q, h, D, kWgRows);
  if (e == cudaSuccess) e = hopper_host::encode_rows(&tdo, dout, b, s_q, h, D, kWgRows);
  if (e == cudaSuccess) e = hopper_host::encode_rows(&tk, k, b, s_k, h_kv, D, kWgRows);
  if (e == cudaSuccess) e = hopper_host::encode_rows(&tv, v, b, s_k, h_kv, D, kWgRows);
  if (e != cudaSuccess) return e;
  auto kernel = flash_dkdv_kernel_wgmma<D>;
  const size_t smem = dkdv_tc_smem<D>();
  e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(b * h_kv, (s_k + kWgRows - 1) / kWgRows);
  kernel<<<grid, 128, smem, stream>>>(tq, tk, tv, tdo, lse, delta, mask,
                                      static_cast<__nv_bfloat16*>(dk),
                                      static_cast<__nv_bfloat16*>(dv), s_q, s_k, h, h_kv, causal,
                                      has_band, band, scale);
  return cudaGetLastError();
}

// Dispatch on (dtype code, head_dim): 0 = float32 to the CUDA-core loop
// FN, 1 = bfloat16 to the tensor-core kernel TC; D 32 or 64.
#define FLASH_DISPATCH_TC(FN, TC, ...)                                           \
  do {                                                                           \
    if (dtype == 0 && d == 32) return FN<float, 32>(__VA_ARGS__);                \
    if (dtype == 0 && d == 64) return FN<float, 64>(__VA_ARGS__);                \
    if (dtype == 1 && d == 32) return TC<32>(__VA_ARGS__);                       \
    if (dtype == 1 && d == 64) return TC<64>(__VA_ARGS__);                       \
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
  FLASH_DISPATCH_TC(launch_plain_fwd, launch_fwd_tc, q, k, v, kv_mask, out, lse, b, s_q, s_k, h,
                    h_kv, causal, has_band, band, scale, st);
}

extern "C" int flash_ring_step(int dtype, const void* q, const void* k, const void* v,
                               const uint8_t* kv_mask, float* m, float* l, float* acc, int b,
                               int s_q, int s_k, int h, int h_kv, int d, int causal,
                               int has_band, int band, float scale, void* stream) {
  if (bad_shape(b, s_q, s_k, h, h_kv)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH_TC(launch_ring_step, launch_ring_step_tc, q, k, v, kv_mask, m, l, acc, b, s_q,
                    s_k, h, h_kv, causal, has_band, band, scale, st);
}

extern "C" int flash_dq(int dtype, const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, const float* delta,
                        const uint8_t* kv_mask, void* dq, int b, int s_q, int s_k, int h,
                        int h_kv, int d, int causal, int has_band, int band, float scale,
                        void* stream) {
  if (bad_shape(b, s_q, s_k, h, h_kv)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH_TC(launch_dq, launch_dq_tc, q, k, v, dout, lse, delta, kv_mask, dq, b, s_q,
                    s_k, h, h_kv, causal, has_band, band, scale, st);
}

extern "C" int flash_dkdv(int dtype, const void* q, const void* k, const void* v,
                          const void* dout, const float* lse, const float* delta,
                          const uint8_t* kv_mask, void* dk, void* dv, int b, int s_q, int s_k,
                          int h, int h_kv, int d, int causal, int has_band, int band,
                          float scale, void* stream) {
  if (bad_shape(b, s_q, s_k, h, h_kv) || b * h_kv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH_TC(launch_dkdv, launch_dkdv_tc, q, k, v, dout, lse, delta, kv_mask, dk, dv, b,
                    s_q, s_k, h, h_kv, causal, has_band, band, scale, st);
}
