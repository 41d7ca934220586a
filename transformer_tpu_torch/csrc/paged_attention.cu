// Paged decode/verify attention over a KV block pool, blocks read in place,
// split over the sequence.
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
// ridge, so it is bound by the bytes of the visible K/V rows (HBM). At
// the serving path's shape (4 slots, 8 kv heads of 64, lengths up to ~1000)
// those are a few MB, about a microsecond at 3.35 TB/s, so what sets the
// time is how many rows are in flight at once and how many dependent steps
// a CTA takes. What the design does about it (a flash-decoding split):
//
// - The grid is (kv head, sequence, split): each CTA owns `split_tokens`
//   consecutive positions (kernels/paged_flash.py `split_plan`: 128 at
//   16-token blocks), so a sequence of length L keeps ceil(L / 128) CTAs
//   busy instead of one. The number of splits comes from the table's width,
//   never from the lengths (reading them on the host would synchronise
//   every decode step): a CTA whose split starts at or past its sequence's
//   length writes an empty partial (m = -1e30, l = 0) and exits, so table
//   entries a sequence does not use are never read.
// - Each of a CTA's 4 warps owns 32-token chunks of the split, one token per
//   lane. It reads its chunk's table entries (one per lane), then issues all
//   of its K/V rows as 16-byte cp.async copies into shared memory,
//   neighbouring lanes on neighbouring addresses of a row, one commit group
//   per chunk: every row of the CTA is in flight before the first chunk is
//   reduced, and a later chunk's rows keep arriving while an earlier one is
//   reduced. A warp folds its chunks on its own (warp shuffles, no CTA
//   barrier): there are two CTA barriers in all, one after the query rows
//   are staged and one before the warps' partials merge in warp order.
//   It takes the query rows 4 at a time when there are several (each K
//   and V element read from shared memory serves 4 rows, and the 4 rows'
//   reductions interleave), one at a time when there is one.
// - All G query heads of a kv head (and all S_q rows) are folded into one
//   CTA, so each K/V row is read from HBM once whatever the GQA group.
// - The CTA's fp32 partial (m, l, acc[G*S_q][D]) goes to scratch that the
//   wrapper allocates; a second kernel merges a sequence's partials in
//   split order (m = max m_i, l = sum exp(m_i - m) l_i, acc likewise, an
//   empty partial weighing exactly 0), one CTA per folded query row, and
//   writes out = acc / l, so the result does not depend on scheduling. One
//   call launches both.
//
// K/V rows are copied as 16-byte vectors, so a row (D times the pool's
// element size) is a multiple of 16 bytes and the pools are 16-byte
// aligned; the wrapper checks both.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e30f;     // flash_attention.py _MASKED
constexpr float kMaskGuard = -1e29f;  // flash_attention.py _MASK_GUARD
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;  // tokens a warp folds at a time: one per lane

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

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

// The pools' element type: the compute dtype T, or int8 codes.
template <typename T, bool Q> struct PoolElem { using type = T; };
template <typename T> struct PoolElem<T, true> { using type = int8_t; };

// 16 bytes of elements of type E as floats.
template <typename E>
__device__ __forceinline__ void unpack16(const uint4& raw, float (&out)[16 / sizeof(E)]) {
  const E* e = reinterpret_cast<const E*>(&raw);
#pragma unroll
  for (int i = 0; i < static_cast<int>(16 / sizeof(E)); ++i) out[i] = to_f(e[i]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most `pending` of this thread's commit groups are in
// flight (a larger count waits for 3, which is stricter and as safe).
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// RG values reduced over the warp at once (independent shuffles interleave).
template <int RG>
__device__ __forceinline__ void warp_max(float (&x)[RG]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < RG; ++i) x[i] = fmaxf(x[i], __shfl_xor_sync(0xffffffffu, x[i], o));
}
template <int RG>
__device__ __forceinline__ void warp_sum(float (&x)[RG]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < RG; ++i) x[i] += __shfl_xor_sync(0xffffffffu, x[i], o);
}

// RG consecutive floats of shared memory (16-byte aligned when RG is 4).
template <int RG>
__device__ __forceinline__ void load_rg(const float* p, float (&o)[RG]) {
#pragma unroll
  for (int i = 0; i < RG; ++i) o[i] = p[i];
}
template <>
__device__ __forceinline__ void load_rg<4>(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

// Row pitch in shared memory: an odd number of 16-byte units, so that the
// 32 lanes reading one 16-byte unit of 32 rows hit every bank once per
// quarter-warp.
__host__ __device__ __forceinline__ int row_pitch(int row_bytes) {
  const int units = row_bytes / 16;
  return 16 * (units % 2 ? units : units + 1);
}

// Partials: m, l (N, H_kv, splits, G*S_q) and acc (N, H_kv, splits, G*S_q, D),
// fp32, written for every CTA. A warp takes the G*S_q query rows RG at a
// time (1 when there is one row, else 4): each K and V element it reads
// from shared memory serves RG rows.
template <typename T, bool Q, int RG>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const T* __restrict__ q, const void* __restrict__ k_pool,
                   const void* __restrict__ v_pool, const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale, const int* __restrict__ table,
                   const int* __restrict__ lengths, float* __restrict__ part_m,
                   float* __restrict__ part_l, float* __restrict__ part_acc, int s_q,
                   int n_heads, int h_kv, int d, int block_tokens, int nmax, int split_tokens,
                   int splits, float scale) {
  using E = typename PoolElem<T, Q>::type;
  constexpr int kE = 16 / sizeof(E);  // elements per 16-byte unit
  const int h = blockIdx.x;           // kv head
  const int n = blockIdx.y;           // sequence
  const int split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int group = n_heads / h_kv;
  const int gs = group * s_q;
  const int64_t pbase = ((static_cast<int64_t>(n) * h_kv + h) * splits + split) * gs;

  const int len = lengths[n];
  const int s0 = split * split_tokens;
  if (s0 >= len) {  // an empty partial, which the merge weighs 0
    for (int idx = tid; idx < gs * d; idx += kThreads) {
      part_acc[pbase * d + idx] = 0.f;
      if (idx < gs) {
        part_m[pbase + idx] = kMasked;
        part_l[pbase + idx] = 0.f;
      }
    }
    return;
  }
  const int end = min(min(len, s0 + split_tokens), nmax * block_tokens);
  const int ntok_split = end - s0;
  const int n_chunks = (ntok_split + kChunk - 1) / kChunk;

  const int row_bytes = d * static_cast<int>(sizeof(E));
  const int units = row_bytes / 16;
  const int pitch = row_pitch(row_bytes);
  const int gs_pad = (gs + RG - 1) / RG * RG;
  const int sc_len = Q ? (split_tokens + 3) / 4 * 4 : 0;

  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* kst = smem;                                    // [split_tokens][pitch]
  uint8_t* vst = kst + split_tokens * pitch;              // [split_tokens][pitch]
  float* ksc = reinterpret_cast<float*>(vst + split_tokens * pitch);  // [split_tokens] (Q)
  float* vsc = ksc + sc_len;                              // [split_tokens] (Q)
  float* qs = vsc + sc_len;                               // [gs_pad][d]
  float* wp = qs + gs_pad * d;                            // [warps][kChunk][RG]: p
  float* wm = wp + kWarps * kChunk * RG;                  // [warps][gs]
  float* wl = wm + kWarps * gs;                           // [warps][gs]
  float* wacc = wl + kWarps * gs;                         // [warps][gs][d]

  // Issue this warp's chunks: table entries first (one per lane), then
  // every row's 16-byte units, one commit group per chunk.
  const int* trow = table + static_cast<int64_t>(n) * nmax;
  const uint8_t* kb = static_cast<const uint8_t*>(k_pool);
  const uint8_t* vb = static_cast<const uint8_t*>(v_pool);
  int mine = 0;
  for (int c = warp; c < n_chunks; c += kWarps, ++mine) {
    const int t0 = c * kChunk;
    const int ntok = min(kChunk, ntok_split - t0);
    long long my_row = 0;
    if (lane < ntok) {
      const int pos = s0 + t0 + lane;
      my_row = (static_cast<long long>(trow[pos / block_tokens]) * block_tokens +
                pos % block_tokens) * h_kv + h;
    }
    for (int base = 0; base < ntok * units; base += 32) {
      const int idx = base + lane;
      const int t = idx / units, u = idx - t * units;
      const long long row = __shfl_sync(0xffffffffu, my_row, t % 32);
      if (idx < ntok * units) {
        const int64_t off = row * row_bytes + u * 16;
        cp_async16(kst + (t0 + t) * pitch + u * 16, kb + off);
        cp_async16(vst + (t0 + t) * pitch + u * 16, vb + off);
      }
    }
    if (Q && lane < ntok) {
      ksc[t0 + lane] = round_t<T>(k_scale[my_row]);
      vsc[t0 + lane] = round_t<T>(v_scale[my_row]);
    }
    cp_async_commit();
  }

  // The G*S_q query rows as fp32 (T values), zero rows up to a multiple of
  // RG; each warp's running state empty.
  for (int idx = tid; idx < gs_pad * d; idx += kThreads) {
    const int r = idx / d, c = idx % d;
    float x = 0.f;
    if (r < gs) {
      const int g = r / s_q, i = r % s_q;
      x = to_f(q[((static_cast<int64_t>(n) * s_q + i) * n_heads + h * group + g) * d + c]);
    }
    qs[idx] = x;
  }
  for (int idx = tid; idx < kWarps * gs; idx += kThreads) {
    wm[idx] = kMasked;
    wl[idx] = 0.f;
  }
  for (int idx = tid; idx < kWarps * gs * d; idx += kThreads) wacc[idx] = 0.f;
  __syncthreads();

  float* my_m = wm + warp * gs;
  float* my_l = wl + warp * gs;
  float* my_acc = wacc + warp * gs * d;
  float* my_p = wp + warp * kChunk * RG;
  int k = 0;
  for (int c = warp; c < n_chunks; c += kWarps, ++k) {
    cp_async_wait(mine - 1 - k);
    __syncwarp();  // every lane's copies of this chunk are visible to the warp
    const int t0 = c * kChunk;
    const int ntok = min(kChunk, ntok_split - t0);
    const int pos = s0 + t0 + lane;
    const int kt = lane < ntok ? lane : 0;  // lanes past the chunk score row 0, masked below
    const uint8_t* krow = kst + (t0 + kt) * pitch;
    const float k_sc = Q ? ksc[t0 + kt] : 1.f;
    for (int r0 = 0; r0 < gs; r0 += RG) {
      // Scores of rows r0.. against this lane's key: fp32 sums of exact T
      // products.
      float dot[RG];
#pragma unroll
      for (int rr = 0; rr < RG; ++rr) dot[rr] = 0.f;
      for (int u = 0; u < units; ++u) {
        float kv[kE];
        unpack16<E>(*reinterpret_cast<const uint4*>(krow + u * 16), kv);
        if (Q) {
#pragma unroll
          for (int e = 0; e < kE; ++e) kv[e] = round_t<T>(kv[e] * k_sc);
        }
#pragma unroll
        for (int rr = 0; rr < RG; ++rr) {
          const float4* q4 = reinterpret_cast<const float4*>(qs + (r0 + rr) * d + u * kE);
#pragma unroll
          for (int e4 = 0; e4 < kE / 4; ++e4) {
            const float4 qv = q4[e4];
            dot[rr] = fmaf(qv.x, kv[4 * e4], dot[rr]);
            dot[rr] = fmaf(qv.y, kv[4 * e4 + 1], dot[rr]);
            dot[rr] = fmaf(qv.z, kv[4 * e4 + 2], dot[rr]);
            dot[rr] = fmaf(qv.w, kv[4 * e4 + 3], dot[rr]);
          }
        }
      }
      float sc[RG], mx[RG], m_prev[RG], p[RG], corr[RG];
#pragma unroll
      for (int rr = 0; rr < RG; ++rr) {
        const int r = r0 + rr;  // past gs: a padding row, masked and never stored
        const bool ok = r < gs && lane < ntok && pos <= len - s_q + r % s_q;
        sc[rr] = ok ? round_t<T>(dot[rr]) * scale : kMasked;
        mx[rr] = sc[rr];
        m_prev[rr] = r < gs ? my_m[r] : kMasked;
      }
      warp_max(mx);
#pragma unroll
      for (int rr = 0; rr < RG; ++rr) {
        mx[rr] = fmaxf(m_prev[rr], mx[rr]);  // the new running max
        p[rr] = sc[rr] > kMaskGuard ? expf(sc[rr] - mx[rr]) : 0.f;
        corr[rr] = expf(m_prev[rr] - mx[rr]);
        my_p[lane * RG + rr] = round_t<T>(p[rr]);
      }
      warp_sum(p);
      __syncwarp();
      // acc = acc * corr + P.V, this lane's columns.
      for (int col = lane; col < d; col += 32) {
        float pv[RG];
#pragma unroll
        for (int rr = 0; rr < RG; ++rr) pv[rr] = 0.f;
        for (int t = 0; t < ntok; ++t) {
          float vv = to_f(reinterpret_cast<const E*>(vst + (t0 + t) * pitch)[col]);
          if (Q) vv = round_t<T>(vv * vsc[t0 + t]);
          float pt[RG];
          load_rg<RG>(my_p + t * RG, pt);
#pragma unroll
          for (int rr = 0; rr < RG; ++rr) pv[rr] = fmaf(pt[rr], vv, pv[rr]);
        }
#pragma unroll
        for (int rr = 0; rr < RG; ++rr) {
          if (r0 + rr < gs) {
            float& a = my_acc[(r0 + rr) * d + col];
            a = a * corr[rr] + pv[rr];
          }
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int rr = 0; rr < RG; ++rr) {
          if (r0 + rr < gs) {
            my_m[r0 + rr] = mx[rr];
            my_l[r0 + rr] = corr[rr] * my_l[r0 + rr] + p[rr];
          }
        }
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // The warps' partials merged in warp (= position) order into the CTA's.
  for (int idx = tid; idx < gs * d; idx += kThreads) {
    const int r = idx / d;
    float m = kMasked;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, wm[w * gs + r]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = wm[w * gs + r];
      const float wt = mw > kMaskGuard ? expf(mw - m) : 0.f;
      l += wt * wl[w * gs + r];
      a += wt * wacc[w * gs * d + idx];
    }
    part_acc[pbase * d + idx] = a;
    if (idx % d == 0) {
      part_m[pbase + r] = m;
      part_l[pbase + r] = l;
    }
  }
}

// One CTA per (kv head, sequence, folded query row): the row's partials
// merged in split order, out = acc / l in the model's (N, S_q, H, D) layout.
// The m and l of every split come in with one load each, in parallel; the
// maximum is a warp reduction (exact in any order), the weights exp(m_i - m)
// are taken in parallel, and l and acc are summed in split order; acc is
// read only up to the last split of non-zero weight (the rest add exactly 0).
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                     const float* __restrict__ part_acc, T* __restrict__ out, int s_q,
                     int n_heads, int h_kv, int d, int splits) {
  const int h = blockIdx.x, n = blockIdx.y, r = blockIdx.z;
  const int tid = threadIdx.x;
  const int group = n_heads / h_kv;
  const int gs = group * s_q;
  const int64_t base = (static_cast<int64_t>(n) * h_kv + h) * splits;  // split 0's partial

  extern __shared__ float cs[];
  float* sm_m = cs;               // [splits]
  float* sm_l = sm_m + splits;    // [splits]
  float* sm_w = sm_l + splits;    // [splits]: exp(m_i - m), 0 for an empty partial
  __shared__ float m_max, l_sum;
  __shared__ int used;
  for (int i = tid; i < splits; i += kThreads) {
    sm_m[i] = part_m[(base + i) * gs + r];
    sm_l[i] = part_l[(base + i) * gs + r];
  }
  __syncthreads();
  if (tid < 32) {
    float m = kMasked;
    for (int i = tid; i < splits; i += 32) m = fmaxf(m, sm_m[i]);
    float mm[1] = {m};
    warp_max(mm);
    if (tid == 0) m_max = mm[0];
  }
  __syncthreads();
  for (int i = tid; i < splits; i += kThreads)
    sm_w[i] = sm_m[i] > kMaskGuard ? expf(sm_m[i] - m_max) : 0.f;  // an empty partial weighs 0
  __syncthreads();
  if (tid == 0) {
    float l = 0.f;
    int last = 0;
    for (int i = 0; i < splits; ++i) {
      l += sm_w[i] * sm_l[i];
      if (sm_w[i] != 0.f) last = i + 1;
    }
    l_sum = l;
    used = last;
  }
  __syncthreads();
  const int g = r / s_q, iq = r % s_q;
  T* orow = out + ((static_cast<int64_t>(n) * s_q + iq) * n_heads + h * group + g) * d;
  const float* arow = part_acc + (base * gs + r) * d;  // split i's row: + i * gs * d
  const int64_t stride = static_cast<int64_t>(gs) * d;
  for (int c = tid; c < d; c += kThreads) {
    float a = 0.f;
#pragma unroll 8
    for (int i = 0; i < used; ++i) a = fmaf(sm_w[i], arow[i * stride + c], a);
    orow[c] = from_f<T>(a / l_sum);
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, bool Q>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ks,
                   const float* vsc, const int* table, const int* lengths, float* part_m,
                   float* part_l, float* part_acc, void* out, int n, int s_q, int n_heads,
                   int h_kv, int d, int block_tokens, int nmax, int split_tokens, int splits,
                   float scale, cudaStream_t stream) {
  using E = typename PoolElem<T, Q>::type;
  const int row_bytes = d * static_cast<int>(sizeof(E));
  if (row_bytes % 16 != 0) return cudaErrorInvalidValue;
  const int gs = (n_heads / h_kv) * s_q;
  const int rg = gs == 1 ? 1 : 4;
  const size_t gs_pad = (gs + rg - 1) / rg * rg;
  const size_t sc_len = Q ? (split_tokens + 3) / 4 * 4 : 0;
  const size_t split_smem =
      2 * static_cast<size_t>(split_tokens) * row_pitch(row_bytes) +
      sizeof(float) * (2 * sc_len + gs_pad * d + kWarps * kChunk * rg +
                       kWarps * static_cast<size_t>(gs) * (2 + d));
  auto split_kernel = rg == 1 ? paged_split_kernel<T, Q, 1> : paged_split_kernel<T, Q, 4>;
  cudaError_t e = set_smem(split_kernel, split_smem);
  if (e != cudaSuccess) return e;
  split_kernel<<<dim3(h_kv, n, splits), kThreads, split_smem, stream>>>(
      static_cast<const T*>(q), k, v, ks, vsc, table, lengths, part_m, part_l, part_acc, s_q,
      n_heads, h_kv, d, block_tokens, nmax, split_tokens, splits, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const size_t combine_smem = sizeof(float) * 3 * static_cast<size_t>(splits);
  auto combine_kernel = paged_combine_kernel<T>;
  e = set_smem(combine_kernel, combine_smem);
  if (e != cudaSuccess) return e;
  if (gs > 65535) return cudaErrorInvalidValue;
  combine_kernel<<<dim3(h_kv, n, gs), kThreads, combine_smem, stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(out), s_q, n_heads, h_kv, d, splits);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the compute dtype of q, out and a
// non-quantised pool). k_scale/v_scale non-null means int8 pools. part_m,
// part_l and part_acc are the fp32 scratch of kernels/paged_flash.py
// `split_plan`, sized for `splits` splits of `split_tokens` positions.
extern "C" int paged_attention(int dtype, const void* q, const void* k_pool,
                               const void* v_pool, const float* k_scale,
                               const float* v_scale, const int* table,
                               const int* lengths, float* part_m, float* part_l,
                               float* part_acc, void* out, int n, int s_q, int n_heads,
                               int h_kv, int d, int block_tokens, int nmax, int split_tokens,
                               int splits, float scale, void* stream) {
  if (n < 1 || n > 65535 || s_q < 1 || h_kv < 1 || n_heads % h_kv != 0 || d < 1 ||
      block_tokens < 1 || nmax < 1 || split_tokens < 1 || splits < 1 || splits > 65535 ||
      static_cast<long long>(splits) * split_tokens < static_cast<long long>(nmax) * block_tokens)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool quant = k_scale != nullptr;
#define PAGED_ARGS                                                                           \
  q, k_pool, v_pool, k_scale, v_scale, table, lengths, part_m, part_l, part_acc, out, n, s_q, \
      n_heads, h_kv, d, block_tokens, nmax, split_tokens, splits, scale, s
  if (dtype == 0) return quant ? launch<float, true>(PAGED_ARGS) : launch<float, false>(PAGED_ARGS);
  if (dtype == 1) {
    return quant ? launch<__nv_bfloat16, true>(PAGED_ARGS)
                 : launch<__nv_bfloat16, false>(PAGED_ARGS);
  }
#undef PAGED_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
