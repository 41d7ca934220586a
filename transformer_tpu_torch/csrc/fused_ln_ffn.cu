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
// (3 matrices when gated). What this design does about it: the grid is
// (dff / 32 column tiles) x (row tiles of 8), so for M <= 8 every weight
// element is read from HBM by exactly one CTA and 64 CTAs stream the
// matrices in parallel. Each CTA produces its (rows, 32) slice of the
// intermediate in shared memory and multiplies it straight into W_out's
// matching 32 rows; the (M, dff) intermediate never reaches global
// memory. The per-tile fp32 partial sums (tiles x M x d, 0.13 MB a row)
// go to a scratch buffer, and the last CTA of each row tile to finish
// (an atomic ticket after a memory fence) reduces them in a fixed order,
// so the result does not depend on CTA scheduling. CUDA-core FMAs and
// plain loads: wgmma/TMA and a wider pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kRows = 8;       // rows per CTA: one warp per row
constexpr int kCols = 32;      // dff columns per CTA: one lane per column

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

// LayerNorm of one row held by one warp in `row` (fp32 values of T), written
// back rounded to T: fp32 mean/variance, affine in fp32.
template <typename T>
__device__ void layernorm_row(float* row, int d, const T* scale, const T* bias, float eps,
                              int lane) {
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s += row[c];
  const float mean = warp_sum(s) / d;
  float v = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float t = row[c] - mean;
    v += t * t;
  }
  const float rstd = rsqrtf(warp_sum(v) / d + eps);
  for (int c = lane; c < d; c += 32)
    row[c] = round_t<T>((row[c] - mean) * rstd * to_f(scale[c]) + to_f(bias[c]));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_ln_ffn_kernel(const T* __restrict__ x, const T* __restrict__ w_in,
                    const T* __restrict__ b_in, const T* __restrict__ w_gate,
                    const T* __restrict__ b_gate, const T* __restrict__ w_out,
                    const T* __restrict__ b_out, const T* __restrict__ ln_scale,
                    const T* __restrict__ ln_bias, T* __restrict__ out,
                    float* __restrict__ partial, unsigned int* __restrict__ tickets,
                    int m, int d, int dff, int act, int pre_ln, float eps) {
  const int tile = blockIdx.x;  // dff column tile
  const int n_tiles = gridDim.x;
  const int row0 = blockIdx.y * kRows;
  const int rows = min(kRows, m - row0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col0 = tile * kCols;

  extern __shared__ float smem[];
  float* hs = smem;               // [kRows][d]  FFN input rows (T values)
  float* ts = hs + kRows * d;     // [kRows][kCols] activated intermediate
  __shared__ bool is_last;

  // 1. FFN input rows: LN(x) for pre-LN, x itself for post-LN.
  {
    float* hr = hs + warp * d;
    const int r = row0 + warp;
    for (int c = lane; c < d; c += 32)
      hr[c] = warp < rows ? to_f(x[static_cast<int64_t>(r) * d + c]) : 0.f;
    if (pre_ln && warp < rows) {
      __syncwarp();
      layernorm_row<T>(hr, d, ln_scale, ln_bias, eps, lane);
    }
  }
  __syncthreads();

  // 2. One (row, column) of the intermediate per thread: warp = row,
  //    lane = column, consecutive lanes read consecutive weight columns.
  {
    const float* hr = hs + warp * d;
    const int col = col0 + lane;
    float z = 0.f, zg = 0.f;
    if (w_gate != nullptr) {
#pragma unroll 4
      for (int k = 0; k < d; ++k) {
        const float hv = hr[k];
        z = fmaf(hv, to_f(w_in[static_cast<int64_t>(k) * dff + col]), z);
        zg = fmaf(hv, to_f(w_gate[static_cast<int64_t>(k) * dff + col]), zg);
      }
      const float u = round_t<T>(round_t<T>(z) + to_f(b_in[col]));
      const float g = round_t<T>(round_t<T>(zg) + to_f(b_gate[col]));
      ts[warp * kCols + lane] = round_t<T>(round_t<T>(activate(g, act)) * u);
    } else {
#pragma unroll 8
      for (int k = 0; k < d; ++k)
        z = fmaf(hr[k], to_f(w_in[static_cast<int64_t>(k) * dff + col]), z);
      const float u = round_t<T>(round_t<T>(z) + to_f(b_in[col]));
      ts[warp * kCols + lane] = round_t<T>(activate(u, act));
    }
  }
  __syncthreads();

  // 3. This tile's fp32 contribution t[:, tile] . W_out[tile, :] -> scratch.
  for (int c = tid; c < d; c += kThreads) {
    float w[kCols];
#pragma unroll
    for (int f = 0; f < kCols; ++f) w[f] = to_f(w_out[static_cast<int64_t>(col0 + f) * d + c]);
    for (int r = 0; r < rows; ++r) {
      const float* tr = ts + r * kCols;
      float s = 0.f;
#pragma unroll
      for (int f = 0; f < kCols; ++f) s = fmaf(tr[f], w[f], s);
      partial[(static_cast<int64_t>(tile) * m + row0 + r) * d + c] = s;
    }
  }

  // 4. The last CTA of this row tile reduces the partials in tile order.
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&tickets[blockIdx.y], 1u) == n_tiles - 1;
  __syncthreads();
  if (!is_last) return;
  if (warp < rows) {
    const int r = row0 + warp;
    float* hr = hs + warp * d;  // reuse: residual sum for this row
    for (int c = lane; c < d; c += 32) {
      float y = 0.f;
      for (int t = 0; t < n_tiles; ++t)
        y += __ldcg(partial + (static_cast<int64_t>(t) * m + r) * d + c);
      const float yb = round_t<T>(round_t<T>(y) + to_f(b_out[c]));
      hr[c] = round_t<T>(to_f(x[static_cast<int64_t>(r) * d + c]) + yb);
    }
    if (!pre_ln) {
      __syncwarp();
      layernorm_row<T>(hr, d, ln_scale, ln_bias, eps, lane);
    }
    __syncwarp();
    for (int c = lane; c < d; c += 32) out[static_cast<int64_t>(r) * d + c] = from_f<T>(hr[c]);
  }
  if (tid == 0) tickets[blockIdx.y] = 0;
}

template <typename T>
cudaError_t launch(const void* x, const void* w_in, const void* b_in, const void* w_gate,
                   const void* b_gate, const void* w_out, const void* b_out,
                   const void* ln_scale, const void* ln_bias, void* out, float* partial,
                   unsigned int* tickets, int m, int d, int dff, int act, int pre_ln,
                   float eps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(kRows) * d + kRows * kCols);
  auto kernel = fused_ln_ffn_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid(dff / kCols, (m + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_in), static_cast<const T*>(b_in),
      static_cast<const T*>(w_gate), static_cast<const T*>(b_gate),
      static_cast<const T*>(w_out), static_cast<const T*>(b_out),
      static_cast<const T*>(ln_scale), static_cast<const T*>(ln_bias),
      static_cast<T*>(out), partial, tickets, m, d, dff, act, pre_ln, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_ln_ffn_tile_cols() { return kCols; }
extern "C" int fused_ln_ffn_tile_rows() { return kRows; }

// dtype: 0 = float32, 1 = bfloat16. act: 0 relu, 1 gelu (tanh), 2 silu;
// w_gate/b_gate non-null selects the gated form. partial holds
// (dff / 32) * m * d floats; tickets ceil(m / 8) zeroed counters.
extern "C" int fused_ln_ffn(int dtype, const void* x, const void* w_in, const void* b_in,
                            const void* w_gate, const void* b_gate, const void* w_out,
                            const void* b_out, const void* ln_scale, const void* ln_bias,
                            void* out, float* partial, unsigned int* tickets, int m, int d,
                            int dff, int act, int pre_ln, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dff % kCols != 0 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(x, w_in, b_in, w_gate, b_gate, w_out, b_out, ln_scale, ln_bias, out,
                         partial, tickets, m, d, dff, act, pre_ln, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w_in, b_in, w_gate, b_gate, w_out, b_out, ln_scale,
                                 ln_bias, out, partial, tickets, m, d, dff, act, pre_ln, eps,
                                 s);
  return static_cast<int>(cudaErrorInvalidValue);
}
