// Fused beam-gather + int8 KV-row insert + causal decode attention, one
// decode step of int8-KV self-attention for one layer (Hopper, sm_90a).
//
// Replaces the TPU kernel `_kernel` in
// seamless_communication_tpu/ops/kernels/decode_attention.py:75 (wrapper
// `fused_decode_self_attention_int8`, :676). The plain PyTorch version of
// the same function is `_reference` in
// seamless_communication_torch/ops/kernels/decode_attention.py.
//
// For each (b, h), with s = src[b] the beam this row continues:
//   logit[t] = (q . k_i8[s,h,t]) * k_scale[s,h,t] / sqrt(Dh)   for t < step
//   lcur     = (q . k_t) / sqrt(Dh)                  (current row, unquantized)
//   m = max(NEG, logit[t<step], lcur), p[t] = exp(logit[t] - m), pc = exp(lcur - m)
//   out = (sum_t round_dtype(p[t] * v_scale[s,h,t]) * v_i8[s,h,t] + pc * v_t)
//         / (sum_t p[t] + pc)
//   new_k[b,h] = k_i8[s,h] with row `step` replaced by quantize(k_t), and the
//   same for v and for the scales; quantize(x) = clip(rint(x / sc), -127, 127)
//   with sc = max(absmax(x) / 127, 1e-8), true fp32 division, round half to
//   even as jnp.round / torch.round do.
//
// The new caches go to separate buffers: a beam reads the rows of another
// beam (src may repeat an index), so writing in place would race.
//
// Bound on the card: the function must read both gathered int8 caches and
// their f32 scales once and write them once:
//   bytes ~= 2 * (2*B*H*T*Dh + 2*B*H*T*4)
// which is about 7 MB at the main-path shape B=5 (beam 5), H=16, T=320,
// Dh=64, or about 2.1 us at 3.35 TB/s. Its arithmetic (4*B*H*T*Dh flops) is
// negligible, so it is bound by bytes.
//
// Design: one thread block of 128 threads per (b, h), 80 blocks at the main
// path shape. The block reads src[b] itself. Pass 1 reads each k row with
// 16-byte vector loads (one row per thread), forms the logit, and writes the
// row (or the new quantized row at `step`) to new_k; the logits stay in
// shared memory (4 bytes per row). Block reductions give the max and the
// denominator. Pass 2 reads each v row in 16-byte chunks (thread = chunk x
// row slice), accumulates the value contraction in fp32 and writes the row to
// new_v; the slices are summed through shared memory. So every cache byte is
// read once and written once. This first design makes no use of TMA or
// wgmma: with Dh=64 and one query row per (b, h) there is no matrix product
// worth a tensor core, and at ~7 MB a step the kernel is far below the size
// where the copy engine would pay; launch latency (a few microseconds) is of
// the same order as the bound.

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

__device__ __forceinline__ int8_t quantize(float x, float scale) {
  const float r = fminf(fmaxf(rintf(x / scale), -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(r));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_attention_int8_kernel(
    const T* __restrict__ q, const T* __restrict__ k_t,
    const T* __restrict__ v_t, const int8_t* __restrict__ k_cache,
    const int8_t* __restrict__ v_cache, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int32_t* __restrict__ src,
    int step, int H, int T_len, int Dh, float sqrt_dh, T* __restrict__ out,
    int8_t* __restrict__ new_k, int8_t* __restrict__ new_v,
    float* __restrict__ new_ks, float* __restrict__ new_vs) {
  extern __shared__ float w_s[];  // T_len: logits, then p * v_scale
  __shared__ float q_s[kMaxDh], vt_s[kMaxDh];
  __shared__ __align__(16) int8_t kq_s[kMaxDh];
  __shared__ __align__(16) int8_t vq_s[kMaxDh];
  __shared__ float red_s[kThreads * kChunk];
  __shared__ float scratch[32];

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const size_t bh = (size_t)b * H + h;
  const size_t sbh = (size_t)src[b] * H + h;
  const int chunks = Dh / kChunk;

  // ---- current row: lcur and its quantized k/v rows -----------------------
  float amax_k = 0.f, amax_v = 0.f, dot = 0.f;
  for (int d = tid; d < Dh; d += blockDim.x) {
    const float qd = to_f32<T>(q[bh * Dh + d]);
    const float kd = to_f32<T>(k_t[bh * Dh + d]);
    const float vd = to_f32<T>(v_t[bh * Dh + d]);
    q_s[d] = qd;
    vt_s[d] = vd;
    amax_k = fmaxf(amax_k, fabsf(kd));
    amax_v = fmaxf(amax_v, fabsf(vd));
    dot += qd * kd;
  }
  amax_k = block_reduce<true>(amax_k, scratch);
  amax_v = block_reduce<true>(amax_v, scratch);
  const float lcur = block_reduce<false>(dot, scratch) / sqrt_dh;
  const float sk = fmaxf(amax_k / 127.f, 1e-8f);
  const float sv = fmaxf(amax_v / 127.f, 1e-8f);
  for (int d = tid; d < Dh; d += blockDim.x) {
    kq_s[d] = quantize(to_f32<T>(k_t[bh * Dh + d]), sk);
    vq_s[d] = quantize(vt_s[d], sv);
  }
  __syncthreads();

  // ---- pass 1: history logits; gathered k rows and scales written out -----
  const int8_t* kc = k_cache + sbh * T_len * Dh;
  int8_t* nk = new_k + bh * T_len * Dh;
  // row `step` is always masked, so the max over the masked row set holds NEG
  float mloc = kNeg;
  for (int t = tid; t < T_len; t += blockDim.x) {
    const int4* row = reinterpret_cast<const int4*>(kc + (size_t)t * Dh);
    int4* orow = reinterpret_cast<int4*>(nk + (size_t)t * Dh);
    const int4* qrow = reinterpret_cast<const int4*>(kq_s);
    float acc = 0.f;
    for (int c = 0; c < chunks; ++c) {
      const int4 v = (t == step) ? qrow[c] : row[c];
      orow[c] = v;
      if (t < step) {
        const int8_t* e = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
        for (int j = 0; j < kChunk; ++j) acc += q_s[c * kChunk + j] * (float)e[j];
      }
    }
    const float ks = k_scale[sbh * T_len + t];
    new_ks[bh * T_len + t] = (t == step) ? sk : ks;
    if (t < step) {
      const float l = (acc * ks) / sqrt_dh;
      w_s[t] = l;
      mloc = fmaxf(mloc, l);
    }
  }
  const float m = fmaxf(block_reduce<true>(mloc, scratch), lcur);

  // ---- softmax numerators, scaled by v_scale and rounded to the model dtype
  float ploc = 0.f;
  for (int t = tid; t < T_len; t += blockDim.x) {
    const float vs = v_scale[sbh * T_len + t];
    new_vs[bh * T_len + t] = (t == step) ? sv : vs;
    if (t < step) {
      const float p = expf(w_s[t] - m);
      ploc += p;
      w_s[t] = round_to<T>(p * vs);
    }
  }
  const float pc = expf(lcur - m);
  const float den = block_reduce<false>(ploc, scratch) + pc;  // syncs w_s

  // ---- pass 2: value contraction; gathered v rows written out ------------
  const int8_t* vc = v_cache + sbh * T_len * Dh;
  int8_t* nv = new_v + bh * T_len * Dh;
  const int slices = blockDim.x / chunks;
  const int c = tid % chunks, s = tid / chunks;
  if (s < slices) {
    float acc[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) acc[j] = 0.f;
    for (int t = s; t < T_len; t += slices) {
      const int4 v = (t == step)
                         ? reinterpret_cast<const int4*>(vq_s)[c]
                         : reinterpret_cast<const int4*>(vc + (size_t)t * Dh)[c];
      reinterpret_cast<int4*>(nv + (size_t)t * Dh)[c] = v;
      if (t < step) {
        const float w = w_s[t];
        const int8_t* e = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
        for (int j = 0; j < kChunk; ++j) acc[j] += w * (float)e[j];
      }
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
int decode_attention_int8(int dtype, const void* q, const void* k_t,
                          const void* v_t, const int8_t* k_cache,
                          const int8_t* v_cache, const float* k_scale,
                          const float* v_scale, const int32_t* src, int B,
                          int H, int T_len, int Dh, int step, float sqrt_dh,
                          void* out, int8_t* new_k, int8_t* new_v,
                          float* new_ks, float* new_vs, void* stream) {
  const dim3 grid(H, B);
  const size_t smem = (size_t)T_len * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    decode_attention_int8_kernel<float><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k_t),
        static_cast<const float*>(v_t), k_cache, v_cache, k_scale, v_scale,
        src, step, H, T_len, Dh, sqrt_dh, static_cast<float*>(out), new_k,
        new_v, new_ks, new_vs);
  } else if (dtype == 1) {
    decode_attention_int8_kernel<__nv_bfloat16><<<grid, kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k_t),
        static_cast<const __nv_bfloat16*>(v_t), k_cache, v_cache, k_scale,
        v_scale, src, step, H, T_len, Dh, sqrt_dh,
        static_cast<__nv_bfloat16*>(out), new_k, new_v, new_ks, new_vs);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
