// Row-indexed int8-KV decode attention: one decode step of self-attention
// for one layer under the lazy beam reorder (Hopper, sm_90a).
//
// Replaces the TPU kernel `_indexed_kernel` in
// seamless_communication_tpu/ops/kernels/decode_attention.py:534 (wrapper
// `indexed_decode_self_attention_int8`, :626). The plain PyTorch version of
// the same function is `_indexed_reference` in
// seamless_communication_torch/ops/kernels/decode_attention.py.
//
// The caches are never permuted. Row t of logical beam b lives in physical
// slot s = row_src[b, t]. For each (b, h):
//   logit[t] = (q . k_i8[s,h,t]) * k_scale[s,h,t] / sqrt(Dh)   for t < step
//   lcur     = (q . k_t) / sqrt(Dh)                  (current row, unquantized)
//   m = max(NEG, logit[t<step], lcur), p[t] = exp(logit[t] - m), pc = exp(lcur - m)
//   out = (sum_t round_dtype(p[t] * v_scale[s,h,t]) * v_i8[s,h,t] + pc * v_t)
//         / (sum_t p[t] + pc)
// with true fp32 divisions, as the plain version divides. Nothing is
// written but `out`: the caller quantizes the new row and stores it in place
// at [b, :, step], which is safe because rows t >= step are never read here.
//
// The TPU kernel attends to every physical slot and selects the origin row's
// logit afterwards (a one-hot trick for the matrix unit). Here each (b, h)
// reads row t of slot row_src[b, t] directly: a row is Dh contiguous bytes,
// read with 16-byte vector loads.
//
// Bound on the card: the function must read the distinct (slot, t) rows that
// some beam reads at t < step (k and v rows, 2*Dh bytes, and their two f32
// scales, over H heads) and write out. At the main-path shape (B=5 beams,
// H=16, Dh=64, a T=320 cache) that is at most 5*16*step*136 bytes, about
// 2.2 MB at step 200, or 0.65 us at 3.35 TB/s; the arithmetic (4*B*H*step*Dh
// flops) is negligible, so it is bound by bytes.
//
// Design: as the classic kernel (csrc/decode_attention.cu) without its copy:
// one block of 128 threads per (b, h). Pass 1: one history row per thread,
// 16-byte loads, the logits kept in shared memory; block reductions give the
// max and the denominator. Pass 2: thread = (16-byte chunk, row slice), fp32
// accumulation, the slices summed through shared memory. No TMA or wgmma:
// one query row per (b, h) has no matrix product worth a tensor core.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxDh = 256;
constexpr int kChunk = 16;  // int8 values in one 16-byte vector
constexpr float kNeg = -1e9f;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to the model dtype and widened back to fp32
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Reduction over the block; every thread gets the result.
template <bool kMax>
__device__ float block_reduce(float v, float* scratch) {
  v = kMax ? warp_max(v) : warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // earlier readers of scratch are done
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? scratch[lane] : (kMax ? kNeg : 0.f);
  return kMax ? warp_max(v) : warp_sum(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_attention_indexed_kernel(
    const T* __restrict__ q, const T* __restrict__ k_t,
    const T* __restrict__ v_t, const int8_t* __restrict__ k_cache,
    const int8_t* __restrict__ v_cache, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int32_t* __restrict__ row_src,
    int step, int H, int T_len, int Dh, float sqrt_dh, T* __restrict__ out) {
  extern __shared__ float w_s[];  // step floats: logits, then p * v_scale
  __shared__ float q_s[kMaxDh], vt_s[kMaxDh];
  __shared__ float red_s[kThreads * kChunk];
  __shared__ float scratch[32];

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const size_t bh = (size_t)b * H + h;
  const int32_t* rs = row_src + (size_t)b * T_len;
  const int chunks = Dh / kChunk;

  // ---- current row: lcur ------------------------------------------------
  float dot = 0.f;
  for (int d = tid; d < Dh; d += blockDim.x) {
    const float qd = to_f32<T>(q[bh * Dh + d]);
    q_s[d] = qd;
    vt_s[d] = to_f32<T>(v_t[bh * Dh + d]);
    dot += qd * to_f32<T>(k_t[bh * Dh + d]);
  }
  const float lcur = block_reduce<false>(dot, scratch) / sqrt_dh;  // syncs q_s

  // ---- pass 1: history logits through the row-origin table ---------------
  float mloc = kNeg;
  for (int t = tid; t < step; t += blockDim.x) {
    const size_t sht = ((size_t)rs[t] * H + h) * T_len + t;
    const int4* row = reinterpret_cast<const int4*>(k_cache + sht * Dh);
    float acc = 0.f;
    for (int c = 0; c < chunks; ++c) {
      const int4 v = row[c];
      const int8_t* e = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) acc += q_s[c * kChunk + j] * (float)e[j];
    }
    const float l = (acc * k_scale[sht]) / sqrt_dh;
    w_s[t] = l;
    mloc = fmaxf(mloc, l);
  }
  const float m = fmaxf(block_reduce<true>(mloc, scratch), lcur);

  // ---- softmax numerators, scaled by v_scale and rounded to the model dtype
  float ploc = 0.f;
  for (int t = tid; t < step; t += blockDim.x) {
    const size_t sht = ((size_t)rs[t] * H + h) * T_len + t;
    const float p = expf(w_s[t] - m);
    ploc += p;
    w_s[t] = round_to<T>(p * v_scale[sht]);
  }
  const float pc = expf(lcur - m);
  const float den = block_reduce<false>(ploc, scratch) + pc;  // syncs w_s

  // ---- pass 2: value contraction -----------------------------------------
  const int slices = blockDim.x / chunks;
  const int c = tid % chunks, s = tid / chunks;
  if (s < slices) {
    float acc[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) acc[j] = 0.f;
    for (int t = s; t < step; t += slices) {
      const size_t sht = ((size_t)rs[t] * H + h) * T_len + t;
      const int4 v = reinterpret_cast<const int4*>(v_cache + sht * Dh)[c];
      const float w = w_s[t];
      const int8_t* e = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) acc[j] += w * (float)e[j];
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) red_s[s * Dh + c * kChunk + j] = acc[j];
  }
  __syncthreads();
  for (int d = tid; d < Dh; d += blockDim.x) {
    float o = 0.f;
    for (int s2 = 0; s2 < slices; ++s2) o += red_s[s2 * Dh + d];
    out[bh * Dh + d] = from_f32<T>((o + pc * vt_s[d]) / den);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k_t, v_t and out). Launches on
// `stream` and returns cudaGetLastError() as an int (0 = launched).
int decode_attention_indexed(int dtype, const void* q, const void* k_t,
                             const void* v_t, const int8_t* k_cache,
                             const int8_t* v_cache, const float* k_scale,
                             const float* v_scale, const int32_t* row_src,
                             int B, int H, int T_len, int Dh, int step,
                             float sqrt_dh, void* out, void* stream) {
  const dim3 grid(H, B);
  // at least one float: a zero-byte request is legal, but keep w_s valid
  const size_t smem = (size_t)(step > 0 ? step : 1) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    decode_attention_indexed_kernel<float><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k_t),
        static_cast<const float*>(v_t), k_cache, v_cache, k_scale, v_scale,
        row_src, step, H, T_len, Dh, sqrt_dh, static_cast<float*>(out));
  } else if (dtype == 1) {
    decode_attention_indexed_kernel<__nv_bfloat16>
        <<<grid, kThreads, smem, st>>>(
            static_cast<const __nv_bfloat16*>(q),
            static_cast<const __nv_bfloat16*>(k_t),
            static_cast<const __nv_bfloat16*>(v_t), k_cache, v_cache, k_scale,
            v_scale, row_src, step, H, T_len, Dh, sqrt_dh,
            static_cast<__nv_bfloat16*>(out));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
