// Flash attention forward with an additive bias and segment ids, the
// full-sequence attention of the fused-attention option (Hopper, sm_90a).
//
// Replaces the TPU kernel that the JAX package reaches through
// seamless_communication_tpu/ops/fused_attention.py:54 `try_flash`: JAX
// 0.9.0's library kernel jax/experimental/pallas/ops/tpu/flash_attention.py
// (`_flash_attention_kernel` :331, `pallas_call` :758). The plain PyTorch
// version of the same function is `_reference` in
// seamless_communication_torch/ops/kernels/flash_attention.py.
//
// For each (b, h) and query row i, over the keys j < Tk:
//   s[j] = sum_d qs[b,h,i,d] * k[b,h,j,d]          (qs: q already scaled)
//          + ab[b,h,i,j]                           (when ab is given)
//          + (q_seg[b,i] == kv_seg[b,j] ? 0 : mask_value)   (when segments)
//   out[b,h,i] = sum_j round_dtype(exp(s[j] - m)) * v[b,h,j] / sum_j exp(s[j] - m)
// with an fp32 online softmax: m and the denominator are carried from key
// tile to key tile, and the accumulator is rescaled by exp(m_old - m_new)
// when the running maximum grows. The probabilities are rounded to v's
// dtype before the value product, which accumulates in fp32 (library
// :465-474). mask_value is the library's DEFAULT_MASK_VALUE, -0.7 * FLT_MAX,
// handed in by the wrapper. A key tile whose keys are all masked contributes
// exp(-huge) = 0 once any unmasked key has set the maximum, and a row whose
// keys are all masked is the plain softmax's uniform average: no NaN.
//
// Bound on the card: the function reads q, k, v (and ab, the segment ids)
// once and writes out once; it does 4*B*H*Tq*Tk*Dh flops. At the main-path
// shape of the v2-large speech encoder (B=1, H=16, T=500, Dh=64, fp32, with
// ab) that is 1.02 GFLOP, 15.3 us at the 67 TFLOP/s of fp32 outside the
// tensor cores, against 24 MB (7.2 us) of bytes: bound by operations.
//
// Design (simple first; wgmma, TMA and bf16 tensor-core products are later
// work): one block of 128 threads (4 warps) per (b, h, tile of 16 query
// rows), each warp owning 4 rows, which it computes together. The block
// stages each key tile of K and V (64 keys for Dh <= 64, 32 for Dh = 128) in
// shared memory as fp32, K's rows padded by 4 floats so that the 16-byte
// loads of 8 lanes reading 8 keys hit distinct banks. For q.k a lane owns
// keys (lane, lane + 32): each 16-byte K load serves the warp's 4 rows and
// each 16-byte q load is a broadcast, so 6 loads feed 32 FMAs (fp32, no
// TF32). The lane adds ab read from device memory (coalesced along the keys)
// and the segment mask compared in registers; warp shuffles reduce each
// row's maximum and sum. The rounded probabilities go to shared memory, and
// for p.v a lane owns output dimensions (lane, lane + 32): each V value
// serves the 4 rows. Every input byte is read once from device memory;
// ragged tails of Tq and Tk are masked in the kernel, so no operand is
// padded.
//
// Residuals for the backward (K6b, K6c in flash_attention_bwd.cu): where the
// caller passes m and l, the kernel also writes each row's final running
// maximum m and softmax denominator l = sum_j exp(s[j] - m), fp32 (B,H,Tq),
// the two the library saves with save_residuals (_flash_attention_fwd
// :229-245). They are what the online softmax already holds in registers,
// so `out` is computed exactly as without them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows of a block

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

// x rounded to the dtype T and widened back to fp32
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Strides are in elements; the last dimension of q, k and v is contiguous.
struct Strides {
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt;
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ ab,
                       const int32_t* __restrict__ q_seg,
                       const int32_t* __restrict__ kv_seg, Strides st, int H,
                       int Tq, int Tk, float mask_value, T* __restrict__ out,
                       float* __restrict__ m_out, float* __restrict__ l_out) {
  constexpr int R = kRowsPerWarp;
  constexpr int BK = DH <= 64 ? 64 : 32;      // keys of a tile
  constexpr int KPL = BK / 32;                // keys of a lane
  constexpr int DPL = (DH + 31) / 32;         // output dims of a lane
  constexpr int LD = DH + 4;                  // padded K row, 16-byte aligned
  __shared__ __align__(16) float q_s[kRows * DH];
  __shared__ __align__(16) float k_s[BK * LD];
  __shared__ __align__(16) float v_s[BK * DH];
  __shared__ __align__(16) float p_s[kWarps][R][BK];

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = warp * R;                  // the warp's first row in the block
  const T* qb = q + b * st.qb + h * st.qh;
  const T* kb = k + b * st.kb + h * st.kh;
  const T* vb = v + b * st.vb + h * st.vh;
  const size_t bh = (size_t)b * H + h;
  const bool seg = q_seg != nullptr;

  for (int idx = tid; idx < kRows * DH; idx += kThreads) {
    const int r = idx / DH, d = idx % DH, i = q0 + r;
    q_s[idx] = i < Tq ? to_f32<T>(qb[i * st.qt + d]) : 0.f;
  }
  float m[R], l[R], acc[R][DPL];
  int qseg[R];
  bool live_row[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = q0 + row0 + r;
    live_row[r] = i < Tq;
    m[r] = -INFINITY;
    l[r] = 0.f;
    qseg[r] = (seg && live_row[r]) ? q_seg[(size_t)b * Tq + i] : 0;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
  }

  for (int k0 = 0; k0 < Tk; k0 += BK) {
    __syncthreads();  // the previous tile is consumed (and q_s written)
    for (int idx = tid; idx < BK * DH; idx += kThreads) {
      const int j = idx / DH, d = idx % DH, key = k0 + j;
      const bool ok = key < Tk;
      k_s[j * LD + d] = ok ? to_f32<T>(kb[key * st.kt + d]) : 0.f;
      v_s[idx] = ok ? to_f32<T>(vb[key * st.vt + d]) : 0.f;
    }
    __syncthreads();

    // ---- logits of the warp's R rows against the lane's KPL keys
    float s[R][KPL];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < KPL; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 kv[KPL];
#pragma unroll
      for (int c = 0; c < KPL; ++c)
        kv[c] = *reinterpret_cast<const float4*>(&k_s[(lane + 32 * c) * LD + d]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(&q_s[(row0 + r) * DH + d]);
#pragma unroll
        for (int c = 0; c < KPL; ++c) {
          s[r][c] = fmaf(qv.x, kv[c].x, s[r][c]);
          s[r][c] = fmaf(qv.y, kv[c].y, s[r][c]);
          s[r][c] = fmaf(qv.z, kv[c].z, s[r][c]);
          s[r][c] = fmaf(qv.w, kv[c].w, s[r][c]);
        }
      }
    }

    // ---- bias, mask and the online softmax of each row
    int kseg[KPL];
    bool kok[KPL];
#pragma unroll
    for (int c = 0; c < KPL; ++c) {
      const int key = k0 + lane + 32 * c;
      kok[c] = key < Tk;
      kseg[c] = (seg && kok[c]) ? kv_seg[(size_t)b * Tk + key] : 0;
    }
    float alpha[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const T* abr = (ab && live_row[r])
                         ? ab + (bh * Tq + q0 + row0 + r) * (size_t)Tk + k0 : nullptr;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < KPL; ++c) {
        if (kok[c]) {
          float x = s[r][c];
          if (abr) x += to_f32<T>(abr[lane + 32 * c]);
          if (seg) x += (qseg[r] == kseg[c]) ? 0.f : mask_value;
          s[r][c] = x;
          mx = fmaxf(mx, x);
        } else {
          s[r][c] = -INFINITY;
        }
      }
      const float m_new = fmaxf(m[r], warp_max(mx));
      // m_new is finite unless every logit so far is -inf (an ab of -inf)
      const bool live = m_new != -INFINITY;
      alpha[r] = live ? expf(m[r] - m_new) : 1.f;
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < KPL; ++c) {
        const float p = (live && kok[c]) ? expf(s[r][c] - m_new) : 0.f;
        psum += p;
        p_s[warp][r][lane + 32 * c] = round_to<T>(p);
      }
      l[r] = l[r] * alpha[r] + warp_sum(psum);
      m[r] = m_new;
    }
    __syncwarp();

    // ---- p.v: each V value serves the R rows (past-the-end keys: p = 0, v = 0)
    const int nk = min(BK, Tk - k0);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[r][e] *= alpha[r];
    for (int j = 0; j < nk; j += 4) {
      float4 pv[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        pv[r] = *reinterpret_cast<const float4*>(&p_s[warp][r][j]);
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        const int d = lane + 32 * e;
        if (d < DH) {
          const float v0 = v_s[(j + 0) * DH + d], v1 = v_s[(j + 1) * DH + d];
          const float v2 = v_s[(j + 2) * DH + d], v3 = v_s[(j + 3) * DH + d];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float a = acc[r][e];
            a = fmaf(pv[r].x, v0, a);
            a = fmaf(pv[r].y, v1, a);
            a = fmaf(pv[r].z, v2, a);
            a = fmaf(pv[r].w, v3, a);
            acc[r][e] = a;
          }
        }
      }
    }
    __syncwarp();  // p_s is read before the next tile writes it
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!live_row[r]) continue;
    const int i = q0 + row0 + r;
    const float inv = l[r] == 0.f ? 1.f : 1.f / l[r];
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d < DH) out[(bh * Tq + i) * DH + d] = from_f32<T>(acc[r][e] * inv);
    }
    if (m_out != nullptr && lane == 0) {
      m_out[bh * Tq + i] = m[r];
      l_out[bh * Tq + i] = l[r];
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ab,
                   const int32_t* q_seg, const int32_t* kv_seg, Strides st, int B,
                   int H, int Tq, int Tk, float mask_value, void* out, float* m,
                   float* l, cudaStream_t stream) {
  const dim3 grid((Tq + kRows - 1) / kRows, H, B);
  flash_attention_kernel<T, DH><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(ab), q_seg, kv_seg, st, H, Tq, Tk, mask_value,
      static_cast<T*>(out), m, l);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int Dh, const void* q, const void* k, const void* v,
                     const void* ab, const int32_t* q_seg, const int32_t* kv_seg,
                     Strides st, int B, int H, int Tq, int Tk, float mask_value,
                     void* out, float* m, float* l, cudaStream_t stream) {
  switch (Dh) {
    case 16:
      return launch<T, 16>(q, k, v, ab, q_seg, kv_seg, st, B, H, Tq, Tk, mask_value,
                           out, m, l, stream);
    case 32:
      return launch<T, 32>(q, k, v, ab, q_seg, kv_seg, st, B, H, Tq, Tk, mask_value,
                           out, m, l, stream);
    case 64:
      return launch<T, 64>(q, k, v, ab, q_seg, kv_seg, st, B, H, Tq, Tk, mask_value,
                           out, m, l, stream);
    case 128:
      return launch<T, 128>(q, k, v, ab, q_seg, kv_seg, st, B, H, Tq, Tk, mask_value,
                            out, m, l, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, ab and out). q (B,H,Tq,Dh), k
// and v (B,H,Tk,Dh) with the given element strides of their first three
// dimensions; ab (B,H,Tq,Tk) contiguous or null; q_seg (B,Tq) and kv_seg
// (B,Tk) int32, both or neither; out (B,H,Tq,Dh) contiguous; m and l
// (B,H,Tq) fp32, both or neither: the residuals of the backward. Launches on
// `stream` and returns cudaGetLastError() as an int (0 = launched).
int flash_attention(int dtype, const void* q, const void* k, const void* v,
                    const void* ab, const int32_t* q_seg, const int32_t* kv_seg,
                    long long q_sb, long long q_sh, long long q_st, long long k_sb,
                    long long k_sh, long long k_st, long long v_sb, long long v_sh,
                    long long v_st, int B, int H, int Tq, int Tk, int Dh,
                    float mask_value, void* out, float* m, float* l, void* stream) {
  if ((q_seg == nullptr) != (kv_seg == nullptr) || (m == nullptr) != (l == nullptr) ||
      Tq < 1 || Tk < 1)
    return (int)cudaErrorInvalidValue;
  const Strides st{q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<float>(Dh, q, k, v, ab, q_seg, kv_seg, st, B, H, Tq, Tk,
                          mask_value, out, m, l, s);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(Dh, q, k, v, ab, q_seg, kv_seg, st, B, H, Tq, Tk,
                                  mask_value, out, m, l, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
