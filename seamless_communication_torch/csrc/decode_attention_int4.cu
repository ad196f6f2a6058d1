// Fused beam-gather + packed-int4 KV-row insert + causal decode attention,
// one decode step of int4-KV self-attention for one layer (Hopper, sm_90a).
//
// Replaces the TPU kernel `_kernel_int4` in
// seamless_communication_tpu/ops/kernels/decode_attention.py:267 (wrapper
// `fused_decode_self_attention_int4`, :412). The plain PyTorch version of
// the same function is `_reference_int4` in
// seamless_communication_torch/ops/kernels/decode_attention.py.
//
// The caches are (B, H, T, Dh/2) bytes in split-half order: byte j of a row
// holds value j in its low nibble and value j + Dh/2 in its high nibble, each
// a signed 4-bit integer in [-7, 7]. For each (b, h), with s = src[b]:
//   logit[t] = (q[:Dh/2] . lo(k[s,h,t]) + q[Dh/2:] . hi(k[s,h,t]))
//              * k_scale[s,h,t] / sqrt(Dh)                       for t < step
//   lcur     = (q . k_t) / sqrt(Dh)                  (current row, unquantized)
//   m = max(NEG, logit[t<step], lcur), p[t] = exp(logit[t] - m), pc = exp(lcur - m)
//   w[t] = round_dtype(p[t] * v_scale[s,h,t])
//   out[:Dh/2] = (sum_t w[t] * lo(v[s,h,t]) + pc * v_t[:Dh/2]) / (sum_t p[t] + pc)
//   out[Dh/2:] = (sum_t w[t] * hi(v[s,h,t]) + pc * v_t[Dh/2:]) / (sum_t p[t] + pc)
//   new_k[b,h] = k[s,h] with row `step` replaced by pack(quantize(k_t)), and
//   the same for v and for the scales; quantize(x) = clip(rint(x / sc), -7, 7)
//   with sc = max(absmax(x) / 7, 1e-8), true fp32 division, round half to
//   even as torch.round does.
//
// The new caches go to separate buffers: a beam reads the rows of another
// beam (src may repeat an index), so writing in place would race.
//
// Bound on the card: the function must read both gathered packed caches and
// their f32 scales once and write them once:
//   bytes ~= 2 * (2*B*H*T*(Dh/2) + 2*B*H*T*4)
// which is about 3.7 MB at the main-path shape B=5 (beam 5), H=16, T=320,
// Dh=64, or about 1.1 us at 3.35 TB/s; half the int8 kernel's cache bytes.
// Its arithmetic (4*B*H*T*Dh flops) is negligible, so it is bound by bytes.
//
// Design: the int8 kernel's, over half-width rows. One thread block of 128
// threads per (b, h), 80 blocks at the main-path shape; the block reads
// src[b] itself. Pass 1 reads each packed k row with 8-byte vector loads (one
// row per thread), sign-extends both nibbles of each byte in registers, forms
// the low-half and the high-half dot, and writes the row (or the new packed
// row at `step`) to new_k; the logits stay in shared memory. Block reductions
// give the max and the denominator. Pass 2 reads each packed v row in 8-byte
// chunks (thread = chunk x row slice); a chunk of 8 bytes feeds 8 low-half and
// 8 high-half output columns, accumulated in fp32, and the slices are summed
// through shared memory. Every cache byte is read once and written once. At
// T=320 the launch latency (a few microseconds) is larger than the bound, so
// no TMA or tensor cores: there is no matrix product worth one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxDh = 256;
constexpr int kChunk = 8;  // packed bytes in one 8-byte vector: 16 values
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

__device__ __forceinline__ int quantize4(float x, float scale) {
  return static_cast<int>(fminf(fmaxf(rintf(x / scale), -7.f), 7.f));
}

// split-half pack: low nibble value j, high nibble value j + Dh/2
__device__ __forceinline__ int8_t pack4(int lo, int hi) {
  return static_cast<int8_t>(static_cast<uint8_t>((lo & 0xF) | ((hi & 0xF) << 4)));
}

// sign-extended nibbles of a packed byte
__device__ __forceinline__ float lo4(int b) { return (float)(((b & 0xF) ^ 8) - 8); }
__device__ __forceinline__ float hi4(int b) { return (float)(b >> 4); }

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_attention_int4_kernel(
    const T* __restrict__ q, const T* __restrict__ k_t,
    const T* __restrict__ v_t, const int8_t* __restrict__ k_cache,
    const int8_t* __restrict__ v_cache, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int32_t* __restrict__ src,
    int step, int H, int T_len, int Dh, float sqrt_dh, T* __restrict__ out,
    int8_t* __restrict__ new_k, int8_t* __restrict__ new_v,
    float* __restrict__ new_ks, float* __restrict__ new_vs) {
  extern __shared__ float w_s[];  // T_len: logits, then p * v_scale
  __shared__ float q_s[kMaxDh], vt_s[kMaxDh];
  __shared__ __align__(16) int8_t kq_s[kMaxDh / 2];
  __shared__ __align__(16) int8_t vq_s[kMaxDh / 2];
  __shared__ float red_s[kThreads * 2 * kChunk];
  __shared__ float scratch[32];

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int dh2 = Dh / 2;
  const size_t bh = (size_t)b * H + h;
  const size_t sbh = (size_t)src[b] * H + h;
  const int chunks = dh2 / kChunk;

  // ---- current row: lcur and its packed quantized k/v rows ----------------
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
  const float sk = fmaxf(amax_k / 7.f, 1e-8f);
  const float sv = fmaxf(amax_v / 7.f, 1e-8f);
  for (int j = tid; j < dh2; j += blockDim.x) {
    kq_s[j] = pack4(quantize4(to_f32<T>(k_t[bh * Dh + j]), sk),
                    quantize4(to_f32<T>(k_t[bh * Dh + j + dh2]), sk));
    vq_s[j] = pack4(quantize4(vt_s[j], sv), quantize4(vt_s[j + dh2], sv));
  }
  __syncthreads();

  // ---- pass 1: history logits; gathered k rows and scales written out -----
  const int8_t* kc = k_cache + sbh * T_len * dh2;
  int8_t* nk = new_k + bh * T_len * dh2;
  // row `step` is always masked, so the max over the masked row set holds NEG
  float mloc = kNeg;
  for (int t = tid; t < T_len; t += blockDim.x) {
    const uint2* row = reinterpret_cast<const uint2*>(kc + (size_t)t * dh2);
    uint2* orow = reinterpret_cast<uint2*>(nk + (size_t)t * dh2);
    const uint2* qrow = reinterpret_cast<const uint2*>(kq_s);
    float acc_lo = 0.f, acc_hi = 0.f;
    for (int c = 0; c < chunks; ++c) {
      const uint2 v = (t == step) ? qrow[c] : row[c];
      orow[c] = v;
      if (t < step) {
        const int8_t* e = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          acc_lo += q_s[c * kChunk + j] * lo4(e[j]);
          acc_hi += q_s[dh2 + c * kChunk + j] * hi4(e[j]);
        }
      }
    }
    const float ks = k_scale[sbh * T_len + t];
    new_ks[bh * T_len + t] = (t == step) ? sk : ks;
    if (t < step) {
      const float l = ((acc_lo + acc_hi) * ks) / sqrt_dh;
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
  const int8_t* vc = v_cache + sbh * T_len * dh2;
  int8_t* nv = new_v + bh * T_len * dh2;
  const int slices = blockDim.x / chunks;
  const int c = tid % chunks, s = tid / chunks;
  if (s < slices) {
    float acc_lo[kChunk], acc_hi[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) acc_lo[j] = acc_hi[j] = 0.f;
    for (int t = s; t < T_len; t += slices) {
      const uint2 v = (t == step)
                          ? reinterpret_cast<const uint2*>(vq_s)[c]
                          : reinterpret_cast<const uint2*>(vc + (size_t)t * dh2)[c];
      reinterpret_cast<uint2*>(nv + (size_t)t * dh2)[c] = v;
      if (t < step) {
        const float w = w_s[t];
        const int8_t* e = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          acc_lo[j] += w * lo4(e[j]);
          acc_hi[j] += w * hi4(e[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      red_s[s * Dh + c * kChunk + j] = acc_lo[j];
      red_s[s * Dh + dh2 + c * kChunk + j] = acc_hi[j];
    }
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

// dtype: 0 = float32, 1 = bfloat16 (q, k_t, v_t and out). Caches are
// (B, H, T_len, Dh/2) packed bytes, 8-byte aligned. Launches on `stream` and
// returns cudaGetLastError() as an int (0 = launched).
int decode_attention_int4(int dtype, const void* q, const void* k_t,
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
    decode_attention_int4_kernel<float><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k_t),
        static_cast<const float*>(v_t), k_cache, v_cache, k_scale, v_scale,
        src, step, H, T_len, Dh, sqrt_dh, static_cast<float*>(out), new_k,
        new_v, new_ks, new_vs);
  } else if (dtype == 1) {
    decode_attention_int4_kernel<__nv_bfloat16><<<grid, kThreads, smem, st>>>(
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
