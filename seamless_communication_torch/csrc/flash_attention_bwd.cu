// Flash attention backward with an additive bias and segment ids: K6b (dK,
// dV) and K6c (dQ and dS, the gradient of the bias), the backward of K6
// (flash_attention.cu) under the fused-attention option (Hopper, sm_90a).
//
// Replace the two TPU kernels of JAX 0.9.0's library flash attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py), the backward half of
// its custom_vjp (`_flash_attention_bwd` :254-316), which the JAX training
// step reaches through seamless_communication_tpu/ops/fused_attention.py:54
// `try_flash` with SEAMLESS_FUSED_ATTN=1:
//   K6b  `_flash_attention_bwd_dkv` :941 (body `_flash_attention_dkv_kernel`
//        :796, `pallas_call` :1121);
//   K6c  `_flash_attention_bwd_dq` :1287 (body `_flash_attention_dq_kernel`
//        :1146, `pallas_call` :1456).
// The plain PyTorch version of both is `_reference_bwd` in
// seamless_communication_torch/ops/kernels/flash_attention.py.
//
// For each (b, h), query row i and key j (qs: q already scaled; no sm_scale):
//   s[i,j]  = sum_d qs[i,d] k[j,d] + ab[i,j] + (q_seg[i] == kv_seg[j] ? 0 : mask)
//   p[i,j]  = exp(s[i,j] - m[i]) * (1 / l[i])    (m, l: K6's residuals)
//   dp[i,j] = sum_d dO[i,d] v[j,d]
//   dS[i,j] = (dp[i,j] - di[i]) * p[i,j]          (di[i] = sum_d o[i,d] dO[i,d])
//   K6b: dV[j] = sum_i round(p[i,j]) dO[i];  dK[j] = sum_i round(dS[i,j]) qs[i]
//   K6c: dQ[i] = sum_j round(dS[i,j]) k[j];  dab[i,j] = round(dS[i,j])
// where round() is to the operands' dtype (the library's casts to dO's, k's
// and ab's dtype, all the same here) and every product accumulates in fp32
// (FMAs, no TF32). A masked logit has p = 0, so its dS and dab are exactly 0;
// a row whose m is -inf (every logit -inf) gets p = 0 everywhere. Ragged
// tails of Tq and Tk are masked in the kernels, so nothing is padded.
//
// The TPU kernels carry the dK/dV (and dQ) sums from one sequential grid step
// to the next in VMEM scratch. Blocks on Hopper run in no order, so each
// block owns its outputs outright and loops over the other axis itself,
// which is the library's own split: K6b's block owns a tile of keys and
// loops over all query tiles; K6c's block owns a tile of query rows and
// loops over all key tiles. No atomics: the results are the same from run to
// run.
//
// Bound on the card (`bound_bwd`): both kernels together recompute the logits
// and do the dV, dP, dK and dQ products, 10*Dh flops an unmasked pair; they
// read q, k, v, o, dO, m, l and ab once and write dq, dk, dv and dab once. At
// the v2-large encoder's 10 s shape (B=1, H=16, T=512 with 499 valid keys,
// Dh=64, with ab) that is 2.6 GFLOP, 39 us at the 67 TFLOP/s of fp32 outside
// the tensor cores (bound by operations); in bf16 about 25 MB, 7.5 us (bound
// by bytes). Each kernel recomputes the logits and dP, so together they do
// 14*Dh flops a pair, 1.4x the function's.
//
// Design (simple first; wgmma, TMA and bf16 tensor-core products are later
// work). Both kernels keep their tiles in shared memory as fp32 and use the
// access pattern of K6's forward: a product whose lanes read different rows
// reads rows padded by 4 floats with 16-byte loads (conflict-free), a product
// whose lanes read one row reads it as a broadcast.
//   K6b: 128 threads (4 warps) own BK keys (8 a warp for Dh <= 64, 4 for 128),
//   loaded once. For each tile of 32 query rows (q, dO, m, 1/l, di staged in
//   shared memory) a lane owns one row and computes s and dp against the
//   warp's keys, then p and dS (ab read from device memory, each lane its
//   row's consecutive keys); the rounded p and dS go to shared memory, and a
//   lane then owns output dimensions (lane, lane + 32, ...) and accumulates
//   dV and dK of the warp's keys in registers over the 32 rows.
//   K6c: 128 threads own 16 query rows (4 a warp, computed together), as in
//   K6's forward; for each tile of BK keys (64 for Dh <= 64, 32 for 128) a
//   lane owns keys (lane, lane + 32) and computes s and dp for the warp's 4
//   rows, then p and dS, writes dab coalesced along the keys, and stages the
//   rounded dS; a lane then owns output dimensions and accumulates dQ.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

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

// Strides are in elements; the last dimension of q, k and v is contiguous.
// dO, m, l, di and every output are contiguous.
struct Strides {
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt;
};

// Per-row values of the backward: m, 1/l (0 for a row past Tq or whose m is
// -inf, so that its p is 0), di and the row's segment id.
__device__ __forceinline__ void row_values(const float* m, const float* l,
                                           const float* di, const int32_t* q_seg,
                                           size_t bh, int b, int i, int Tq, float& mi,
                                           float& il, float& dii, int& seg) {
  mi = 0.f;
  il = 0.f;
  dii = 0.f;
  seg = 0;
  if (i < Tq) {
    const float mm = m[bh * Tq + i];
    if (mm != -INFINITY) {
      mi = mm;
      il = 1.f / l[bh * Tq + i];
    }
    dii = di[bh * Tq + i];
    if (q_seg != nullptr) seg = q_seg[(size_t)b * Tq + i];
  }
}

// ---------------------------------------------------------------------------
// K6b: dK, dV. A block owns BK = 4 * KW keys of one (b, h).
// ---------------------------------------------------------------------------

template <int DH>
struct DkvShape {
  static constexpr int KW = DH <= 64 ? 8 : 4;   // keys of a warp
  static constexpr int BK = kWarps * KW;        // keys of a block
  static constexpr int BQ = 32;                 // query rows of a tile (= lanes)
  static constexpr int LDQ = DH + 4;            // padded q / dO row
  static constexpr int DPL = (DH + 31) / 32;    // output dims of a lane
  // floats: q_s, do_s, k_s, v_s, p_s, ds_s, m_s, il_s, di_s (+ int seg_s)
  static constexpr int kSmemFloats =
      2 * BQ * LDQ + 2 * BK * DH + 2 * kWarps * KW * BQ + 3 * BQ;
  static constexpr size_t kSmemBytes = (size_t)kSmemFloats * 4 + BQ * 4;
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const T* __restrict__ ab,
                               const int32_t* __restrict__ q_seg,
                               const int32_t* __restrict__ kv_seg,
                               const T* __restrict__ dout, const float* __restrict__ m,
                               const float* __restrict__ l,
                               const float* __restrict__ di, Strides st, int H, int Tq,
                               int Tk, float mask_value, T* __restrict__ dk,
                               T* __restrict__ dv) {
  using S = DkvShape<DH>;
  constexpr int KW = S::KW, BK = S::BK, BQ = S::BQ, LDQ = S::LDQ, DPL = S::DPL;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                    // [BQ][LDQ]
  float* do_s = q_s + BQ * LDQ;         // [BQ][LDQ]
  float* k_s = do_s + BQ * LDQ;         // [BK][DH]
  float* v_s = k_s + BK * DH;           // [BK][DH]
  float* p_s = v_s + BK * DH;           // [kWarps][KW][BQ]
  float* ds_s = p_s + kWarps * KW * BQ; // [kWarps][KW][BQ]
  float* m_s = ds_s + kWarps * KW * BQ; // [BQ]
  float* il_s = m_s + BQ;               // [BQ]
  float* di_s = il_s + BQ;              // [BQ]
  int* seg_s = reinterpret_cast<int*>(di_s + BQ);  // [BQ]

  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* qb = q + b * st.qb + h * st.qh;
  const T* kb = k + b * st.kb + h * st.kh;
  const T* vb = v + b * st.vb + h * st.vh;
  const size_t bh = (size_t)b * H + h;
  const T* dob = dout + bh * Tq * DH;
  const bool seg = q_seg != nullptr;

  for (int idx = tid; idx < BK * DH; idx += kThreads) {
    const int j = idx / DH, d = idx % DH, key = k0 + j;
    const bool ok = key < Tk;
    k_s[idx] = ok ? to_f32<T>(kb[key * st.kt + d]) : 0.f;
    v_s[idx] = ok ? to_f32<T>(vb[key * st.vt + d]) : 0.f;
  }
  // the warp's keys: k0 + warp * KW + c
  int kseg[KW];
  bool kok[KW];
#pragma unroll
  for (int c = 0; c < KW; ++c) {
    const int key = k0 + warp * KW + c;
    kok[c] = key < Tk;
    kseg[c] = (seg && kok[c]) ? kv_seg[(size_t)b * Tk + key] : 0;
  }
  float acc_dk[KW][DPL], acc_dv[KW][DPL];
#pragma unroll
  for (int c = 0; c < KW; ++c)
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc_dk[c][e] = acc_dv[c][e] = 0.f;

  float* p_w = p_s + warp * KW * BQ;
  float* ds_w = ds_s + warp * KW * BQ;

  for (int q0 = 0; q0 < Tq; q0 += BQ) {
    __syncthreads();  // the previous tile is consumed (and k_s, v_s written)
    for (int idx = tid; idx < BQ * DH; idx += kThreads) {
      const int r = idx / DH, d = idx % DH, i = q0 + r;
      const bool ok = i < Tq;
      q_s[r * LDQ + d] = ok ? to_f32<T>(qb[i * st.qt + d]) : 0.f;
      do_s[r * LDQ + d] = ok ? to_f32<T>(dob[(size_t)i * DH + d]) : 0.f;
    }
    if (tid < BQ) {
      row_values(m, l, di, q_seg, bh, b, q0 + tid, Tq, m_s[tid], il_s[tid], di_s[tid],
                 seg_s[tid]);
    }
    __syncthreads();

    // ---- s and dp of the lane's row against the warp's KW keys
    const int i = q0 + lane;
    float s[KW], dp[KW];
#pragma unroll
    for (int c = 0; c < KW; ++c) s[c] = dp[c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(&q_s[lane * LDQ + d]);
      const float4 gv = *reinterpret_cast<const float4*>(&do_s[lane * LDQ + d]);
#pragma unroll
      for (int c = 0; c < KW; ++c) {
        const float4 kv = *reinterpret_cast<const float4*>(&k_s[(warp * KW + c) * DH + d]);
        const float4 vv = *reinterpret_cast<const float4*>(&v_s[(warp * KW + c) * DH + d]);
        s[c] = fmaf(qv.x, kv.x, s[c]);
        s[c] = fmaf(qv.y, kv.y, s[c]);
        s[c] = fmaf(qv.z, kv.z, s[c]);
        s[c] = fmaf(qv.w, kv.w, s[c]);
        dp[c] = fmaf(gv.x, vv.x, dp[c]);
        dp[c] = fmaf(gv.y, vv.y, dp[c]);
        dp[c] = fmaf(gv.z, vv.z, dp[c]);
        dp[c] = fmaf(gv.w, vv.w, dp[c]);
      }
    }

    // ---- p and dS of the lane's row; a row past Tq has 1/l = 0, so p = 0
    const float mi = m_s[lane], il = il_s[lane], dii = di_s[lane];
    const int qseg = seg_s[lane];
    const T* abr = (ab && i < Tq) ? ab + (bh * Tq + i) * (size_t)Tk + k0 + warp * KW
                                  : nullptr;
#pragma unroll
    for (int c = 0; c < KW; ++c) {
      float p = 0.f, ds = 0.f;
      if (kok[c] && il != 0.f) {
        float x = s[c];
        if (abr) x += to_f32<T>(abr[c]);
        if (seg) x += (qseg == kseg[c]) ? 0.f : mask_value;
        p = expf(x - mi) * il;
        ds = (dp[c] - dii) * p;
      }
      p_w[c * BQ + lane] = round_to<T>(p);
      ds_w[c * BQ + lane] = round_to<T>(ds);
    }
    __syncwarp();

    // ---- dV += p^T dO, dK += dS^T q over the tile's rows; a lane owns dims
    for (int r = 0; r < BQ; r += 4) {
      float gq[4][DPL], qq[4][DPL];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          const int d = lane + 32 * e;
          gq[u][e] = d < DH ? do_s[(r + u) * LDQ + d] : 0.f;
          qq[u][e] = d < DH ? q_s[(r + u) * LDQ + d] : 0.f;
        }
#pragma unroll
      for (int c = 0; c < KW; ++c) {
        const float4 pv = *reinterpret_cast<const float4*>(&p_w[c * BQ + r]);
        const float4 sv = *reinterpret_cast<const float4*>(&ds_w[c * BQ + r]);
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          float a = acc_dv[c][e];
          a = fmaf(pv.x, gq[0][e], a);
          a = fmaf(pv.y, gq[1][e], a);
          a = fmaf(pv.z, gq[2][e], a);
          a = fmaf(pv.w, gq[3][e], a);
          acc_dv[c][e] = a;
          float g = acc_dk[c][e];
          g = fmaf(sv.x, qq[0][e], g);
          g = fmaf(sv.y, qq[1][e], g);
          g = fmaf(sv.z, qq[2][e], g);
          g = fmaf(sv.w, qq[3][e], g);
          acc_dk[c][e] = g;
        }
      }
    }
  }

#pragma unroll
  for (int c = 0; c < KW; ++c) {
    if (!kok[c]) continue;
    const size_t row = bh * Tk + k0 + warp * KW + c;
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d < DH) {
        dk[row * DH + d] = from_f32<T>(acc_dk[c][e]);
        dv[row * DH + d] = from_f32<T>(acc_dv[c][e]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K6c: dQ and dab. A block owns 16 query rows of one (b, h), 4 a warp.
// ---------------------------------------------------------------------------

template <int DH>
struct DqShape {
  static constexpr int R = 4;                   // rows of a warp
  static constexpr int ROWS = kWarps * R;       // rows of a block
  static constexpr int BK = DH <= 64 ? 64 : 32; // keys of a tile
  static constexpr int KPL = BK / 32;           // keys of a lane
  static constexpr int LD = DH + 4;             // padded K / V row
  static constexpr int DPL = (DH + 31) / 32;    // output dims of a lane
  // floats: q_s, do_s, k_s, v_s, ds_s
  static constexpr int kSmemFloats = 2 * ROWS * DH + 2 * BK * LD + kWarps * R * BK;
  static constexpr size_t kSmemBytes = (size_t)kSmemFloats * 4;
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ ab,
                              const int32_t* __restrict__ q_seg,
                              const int32_t* __restrict__ kv_seg,
                              const T* __restrict__ dout, const float* __restrict__ m,
                              const float* __restrict__ l, const float* __restrict__ di,
                              Strides st, int H, int Tq, int Tk, float mask_value,
                              T* __restrict__ dq, T* __restrict__ dab) {
  using S = DqShape<DH>;
  constexpr int R = S::R, ROWS = S::ROWS, BK = S::BK, KPL = S::KPL, LD = S::LD,
                DPL = S::DPL;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                // [ROWS][DH]
  float* do_s = q_s + ROWS * DH;    // [ROWS][DH]
  float* k_s = do_s + ROWS * DH;    // [BK][LD]
  float* v_s = k_s + BK * LD;       // [BK][LD]
  float* ds_s = v_s + BK * LD;      // [kWarps][R][BK]

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = warp * R;        // the warp's first row in the block
  const T* qb = q + b * st.qb + h * st.qh;
  const T* kb = k + b * st.kb + h * st.kh;
  const T* vb = v + b * st.vb + h * st.vh;
  const size_t bh = (size_t)b * H + h;
  const T* dob = dout + bh * Tq * DH;
  const bool seg = q_seg != nullptr;
  float* ds_w = ds_s + warp * R * BK;

  for (int idx = tid; idx < ROWS * DH; idx += kThreads) {
    const int r = idx / DH, d = idx % DH, i = q0 + r;
    const bool ok = i < Tq;
    q_s[idx] = ok ? to_f32<T>(qb[i * st.qt + d]) : 0.f;
    do_s[idx] = ok ? to_f32<T>(dob[(size_t)i * DH + d]) : 0.f;
  }
  float mi[R], il[R], dii[R], acc[R][DPL];
  int qseg[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    row_values(m, l, di, q_seg, bh, b, q0 + row0 + r, Tq, mi[r], il[r], dii[r], qseg[r]);
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
  }

  for (int k0 = 0; k0 < Tk; k0 += BK) {
    __syncthreads();  // the previous tile is consumed (and q_s, do_s written)
    for (int idx = tid; idx < BK * DH; idx += kThreads) {
      const int j = idx / DH, d = idx % DH, key = k0 + j;
      const bool ok = key < Tk;
      k_s[j * LD + d] = ok ? to_f32<T>(kb[key * st.kt + d]) : 0.f;
      v_s[j * LD + d] = ok ? to_f32<T>(vb[key * st.vt + d]) : 0.f;
    }
    __syncthreads();

    // ---- s and dp of the warp's R rows against the lane's KPL keys
    float s[R][KPL], dp[R][KPL];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < KPL; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 kv[KPL], vv[KPL];
#pragma unroll
      for (int c = 0; c < KPL; ++c) {
        kv[c] = *reinterpret_cast<const float4*>(&k_s[(lane + 32 * c) * LD + d]);
        vv[c] = *reinterpret_cast<const float4*>(&v_s[(lane + 32 * c) * LD + d]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(&q_s[(row0 + r) * DH + d]);
        const float4 gv = *reinterpret_cast<const float4*>(&do_s[(row0 + r) * DH + d]);
#pragma unroll
        for (int c = 0; c < KPL; ++c) {
          s[r][c] = fmaf(qv.x, kv[c].x, s[r][c]);
          s[r][c] = fmaf(qv.y, kv[c].y, s[r][c]);
          s[r][c] = fmaf(qv.z, kv[c].z, s[r][c]);
          s[r][c] = fmaf(qv.w, kv[c].w, s[r][c]);
          dp[r][c] = fmaf(gv.x, vv[c].x, dp[r][c]);
          dp[r][c] = fmaf(gv.y, vv[c].y, dp[r][c]);
          dp[r][c] = fmaf(gv.z, vv[c].z, dp[r][c]);
          dp[r][c] = fmaf(gv.w, vv[c].w, dp[r][c]);
        }
      }
    }

    // ---- p and dS of each (row, key); dab written along the keys
    int kseg[KPL];
    bool kok[KPL];
#pragma unroll
    for (int c = 0; c < KPL; ++c) {
      const int key = k0 + lane + 32 * c;
      kok[c] = key < Tk;
      kseg[c] = (seg && kok[c]) ? kv_seg[(size_t)b * Tk + key] : 0;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = q0 + row0 + r;
      const size_t rowoff = (bh * Tq + i) * (size_t)Tk + k0;
#pragma unroll
      for (int c = 0; c < KPL; ++c) {
        const int j = lane + 32 * c;
        float ds = 0.f;
        if (kok[c] && il[r] != 0.f) {
          float x = s[r][c];
          if (ab) x += to_f32<T>(ab[rowoff + j]);
          if (seg) x += (qseg[r] == kseg[c]) ? 0.f : mask_value;
          const float p = expf(x - mi[r]) * il[r];
          ds = (dp[r][c] - dii[r]) * p;
        }
        if (dab != nullptr && kok[c] && i < Tq) dab[rowoff + j] = from_f32<T>(ds);
        ds_w[r * BK + j] = round_to<T>(ds);
      }
    }
    __syncwarp();

    // ---- dQ += dS k: each K value serves the R rows (past-the-end keys: 0)
    const int nk = min(BK, Tk - k0);
    for (int j = 0; j < nk; j += 4) {
      float4 sv[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        sv[r] = *reinterpret_cast<const float4*>(&ds_w[r * BK + j]);
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        const int d = lane + 32 * e;
        if (d < DH) {
          const float x0 = k_s[(j + 0) * LD + d], x1 = k_s[(j + 1) * LD + d];
          const float x2 = k_s[(j + 2) * LD + d], x3 = k_s[(j + 3) * LD + d];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float a = acc[r][e];
            a = fmaf(sv[r].x, x0, a);
            a = fmaf(sv[r].y, x1, a);
            a = fmaf(sv[r].z, x2, a);
            a = fmaf(sv[r].w, x3, a);
            acc[r][e] = a;
          }
        }
      }
    }
    __syncwarp();  // ds_s is read before the next tile writes it
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = q0 + row0 + r;
    if (i >= Tq) continue;
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d < DH) dq[(bh * Tq + i) * DH + d] = from_f32<T>(acc[r][e]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *ab;
  const int32_t *q_seg, *kv_seg;
  const void* dout;
  const float *m, *l, *di;
  Strides st;
  int B, H, Tq, Tk;
  float mask_value;
  void *out0, *out1;   // dk, dv (K6b) or dq, dab (K6c)
  cudaStream_t stream;
};

// Above 48 KB a kernel's dynamic shared memory must be allowed first (only
// the Dh = 128 instantiations ask for more); once per instantiation.
template <typename T, int DH, bool DKV, typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  static bool done = false;
  if (done || bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  done = err == cudaSuccess;
  return err;
}

template <typename T, int DH>
cudaError_t launch_dkv(const Args& a) {
  using S = DkvShape<DH>;
  auto kernel = flash_attention_bwd_dkv_kernel<T, DH>;
  cudaError_t err = allow_smem<T, DH, true>(kernel, S::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tk + S::BK - 1) / S::BK, a.H, a.B);
  kernel<<<grid, kThreads, S::kSmemBytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.ab), a.q_seg, a.kv_seg, static_cast<const T*>(a.dout), a.m,
      a.l, a.di, a.st, a.H, a.Tq, a.Tk, a.mask_value, static_cast<T*>(a.out0),
      static_cast<T*>(a.out1));
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_dq(const Args& a) {
  using S = DqShape<DH>;
  auto kernel = flash_attention_bwd_dq_kernel<T, DH>;
  cudaError_t err = allow_smem<T, DH, false>(kernel, S::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + S::ROWS - 1) / S::ROWS, a.H, a.B);
  kernel<<<grid, kThreads, S::kSmemBytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.ab), a.q_seg, a.kv_seg, static_cast<const T*>(a.dout), a.m,
      a.l, a.di, a.st, a.H, a.Tq, a.Tk, a.mask_value, static_cast<T*>(a.out0),
      static_cast<T*>(a.out1));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(bool dkv, int Dh, const Args& a) {
  switch (Dh) {
    case 16: return dkv ? launch_dkv<T, 16>(a) : launch_dq<T, 16>(a);
    case 32: return dkv ? launch_dkv<T, 32>(a) : launch_dq<T, 32>(a);
    case 64: return dkv ? launch_dkv<T, 64>(a) : launch_dq<T, 64>(a);
    case 128: return dkv ? launch_dkv<T, 128>(a) : launch_dq<T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

int run(bool dkv, int dtype, const Args& a, int Dh) {
  if ((a.q_seg == nullptr) != (a.kv_seg == nullptr) || a.Tq < 1 || a.Tk < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)dispatch<float>(dkv, Dh, a);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(dkv, Dh, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, ab, dout and the gradients). q
// (B,H,Tq,Dh), k and v (B,H,Tk,Dh) with the given element strides of their
// first three dimensions; ab (B,H,Tq,Tk) contiguous or null; q_seg (B,Tq) and
// kv_seg (B,Tk) int32, both or neither; dout (B,H,Tq,Dh) contiguous; m, l
// and di (B,H,Tq) fp32 contiguous. Launch on `stream` and return
// cudaGetLastError() as an int (0 = launched).

// K6b: dk and dv (B,H,Tk,Dh) contiguous.
int flash_attention_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                            const void* ab, const int32_t* q_seg, const int32_t* kv_seg,
                            const void* dout, const float* m, const float* l,
                            const float* di, long long q_sb, long long q_sh,
                            long long q_st, long long k_sb, long long k_sh,
                            long long k_st, long long v_sb, long long v_sh,
                            long long v_st, int B, int H, int Tq, int Tk, int Dh,
                            float mask_value, void* dk, void* dv, void* stream) {
  const Args a{q, k, v, ab, q_seg, kv_seg, dout, m, l, di,
               Strides{q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st},
               B, H, Tq, Tk, mask_value, dk, dv, static_cast<cudaStream_t>(stream)};
  return run(true, dtype, a, Dh);
}

// K6c: dq (B,H,Tq,Dh) contiguous; dab (B,H,Tq,Tk) contiguous, or null when
// the bias needs no gradient.
int flash_attention_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                           const void* ab, const int32_t* q_seg, const int32_t* kv_seg,
                           const void* dout, const float* m, const float* l,
                           const float* di, long long q_sb, long long q_sh,
                           long long q_st, long long k_sb, long long k_sh,
                           long long k_st, long long v_sb, long long v_sh,
                           long long v_st, int B, int H, int Tq, int Tk, int Dh,
                           float mask_value, void* dq, void* dab, void* stream) {
  const Args a{q, k, v, ab, q_seg, kv_seg, dout, m, l, di,
               Strides{q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st},
               B, H, Tq, Tk, mask_value, dq, dab, static_cast<cudaStream_t>(stream)};
  return run(false, dtype, a, Dh);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
