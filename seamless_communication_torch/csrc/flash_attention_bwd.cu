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
// K6b and K6c each have one kernel per dtype, chosen by `dtype` in the C
// entry: the SIMT kernels in fp32, the tensor-core kernels in bf16.
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
// K6b in bf16 (flash_attention_bwd_dkv_tc_kernel): dV and dK on the tensor
// cores (wgmma, bf16 operands, fp32 accumulators), the tiles fed by TMA. A
// block owns 64 keys of one (b, h): a producer warp loads their K and V
// once, then streams the Q and dO tiles of every query tile (64 rows, 32 at
// Dh = 128, where the accumulators would not fit the registers), the ab tile
// (128-byte swizzled) and the rows' m, 1/l, di and segment ids through a
// ring of 3 shared-memory stages guarded by mbarriers. A warpgroup computes
// transposed, keys as wgmma's M. S^T = K Q^T and dP^T = V dO^T are fp32 FMAs
// from fp32 copies of the tiles, one term after another in the order of d,
// the order of the plain version's fp32 products: p and dS are rounded to
// bf16 before dV and dK, and a logit or dP summed in any other order (the
// tensor cores' among them) moves the p or dS next to a rounding boundary to
// the other bf16 neighbour, which an element of dk or dv that cancels to near
// 0 shows as many of its own ulps. Two warps sum S^T and two dP^T, a lane
// 8 keys x 8 rows (16 shared loads a 256 FMAs: the shared-memory pipe keeps
// pace with the FMAs), and the sums pass through shared memory into the
// m64nBQ accumulator layout, where p and dS (expf, as the plain version)
// are computed and, rounded to bf16, are the A operands of dV += P^T dO and
// dK += dS^T Q, whose B operands dO and Q are read MN-major from the ring.
// No atomics: the block owns its keys. At the 10 s shape that is 128
// blocks, one wave, one a multiprocessor (about 200 KB of shared memory at
// Dh = 64). The bias and the segment ids are template arguments, so the
// element loop holds no branch. What holds it back now: the two fp32
// products, 4 Dh FMAs a (key, row) pair, and expf, each on one warpgroup a
// block with nothing to overlap them.
//
// K6c in bf16 (flash_attention_bwd_dq_tc_kernel): dQ on the tensor cores
// (wgmma, bf16 operands, fp32 accumulator), the key tiles fed by TMA. A
// block owns 64 query rows of one (b, h), wgmma's M, and their dQ: no
// atomics. Their Q and dO (bf16, in padded rows) and m, 1/l, di and segment
// ids are loaded once. With segment ids the block first marks the key tiles
// it must take, the rule of `skippable_tiles` (ops/kernels/flash_attention.py):
// a tile none of whose keys has a segment id within [min, max] of the rows'
// is left out, unless a row's m is at the mask level (all its keys masked:
// its p is not 0); such a tile's p are exactly 0, so leaving it out changes
// no bit of dq, and its dab is written as zeros. A producer warp streams the
// K, V and ab tiles and the key segment ids of the taken tiles through a
// ring of mbarrier-guarded stages (4 at Dh <= 64). Two consumer warpgroups
// take every other tile. In a group, two warps sum S = Q K^T and two dP =
// dO V^T with fp32 FMAs, one term after another in the order of d (the
// order of cuBLAS's fp32 GEMM, which the one-ulp check of dq and dab needs),
// a lane 8 keys x 8 rows, both operands bf16 from shared memory widened in
// registers; the sums pass through shared memory into the m64n64
// accumulator layout, where p (expf, as the plain version) and dS are
// computed and rounded to bf16: dS is dab (staged in shared memory for
// 16-byte stores) and the register A operand of dQ += dS K (wgmma, K read
// MN-major from the ring). At Dh <= 64 a group's dQ waits in shared memory
// between its products, which leaves the 168 registers of a 288-thread
// block to the fp32 products. At the end the two groups' dQ are added and
// dq rounded once. The bias and the segment ids are template arguments.
// What holds it back (chip_smoke.py --k6c-parts): the two fp32 products,
// whose shared-memory loads (16 8-byte loads a 256 FMAs a lane) the two
// warps a scheduler do not hide; then expf, the ab reads and dab's stores.
//
// Design of the SIMT kernels (fp32). Both keep their tiles in shared memory
// as fp32 and use the access pattern of K6's forward: a product whose lanes
// read different rows reads rows padded by 4 floats with 16-byte loads
// (conflict-free), a product whose lanes read one row reads it as a
// broadcast.
//   K6b: 128 threads (4 warps) own BK keys (8 a warp for Dh <= 64, 4 for 128),
//   loaded once. For each tile of 32 query rows (q, dO, m, 1/l, di staged in
//   shared memory) a lane owns one row and computes s and dp against the
//   warp's keys, then p and dS (ab read from device memory, each lane its
//   row's consecutive keys); p and dS go to shared memory, and a
//   lane then owns output dimensions (lane, lane + 32, ...) and accumulates
//   dV and dK of the warp's keys in registers over the 32 rows.
//   K6c: 128 threads own 16 query rows (4 a warp, computed together), as in
//   K6's forward; for each tile of BK keys (64 for Dh <= 64, 32 for 128) a
//   lane owns keys (lane, lane + 32) and computes s and dp for the warp's 4
//   rows, then p and dS, writes dab coalesced along the keys, and stages the
//   rounded dS; a lane then owns output dimensions and accumulates dQ.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// Strides are in elements; the last dimension of q, k and v is contiguous.
// The bias's rows are `abt` apart and dab's `dabt` (their last dimension
// contiguous). dO, m, l, di and the other outputs are contiguous.
struct Strides {
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt, abt, dabt;
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

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ ab,
                               const int32_t* __restrict__ q_seg,
                               const int32_t* __restrict__ kv_seg,
                               const float* __restrict__ dout, const float* __restrict__ m,
                               const float* __restrict__ l,
                               const float* __restrict__ di, Strides st, int H, int Tq,
                               int Tk, float mask_value, float* __restrict__ dk,
                               float* __restrict__ dv) {
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
  const float* qb = q + b * st.qb + h * st.qh;
  const float* kb = k + b * st.kb + h * st.kh;
  const float* vb = v + b * st.vb + h * st.vh;
  const size_t bh = (size_t)b * H + h;
  const float* dob = dout + bh * Tq * DH;
  const bool seg = q_seg != nullptr;

  for (int idx = tid; idx < BK * DH; idx += kThreads) {
    const int j = idx / DH, d = idx % DH, key = k0 + j;
    const bool ok = key < Tk;
    k_s[idx] = ok ? kb[key * st.kt + d] : 0.f;
    v_s[idx] = ok ? vb[key * st.vt + d] : 0.f;
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
      q_s[r * LDQ + d] = ok ? qb[i * st.qt + d] : 0.f;
      do_s[r * LDQ + d] = ok ? dob[(size_t)i * DH + d] : 0.f;
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
    const float* abr =
        (ab && i < Tq) ? ab + (bh * Tq + i) * (size_t)st.abt + k0 + warp * KW : nullptr;
#pragma unroll
    for (int c = 0; c < KW; ++c) {
      float p = 0.f, ds = 0.f;
      if (kok[c] && il != 0.f) {
        float x = s[c];
        if (abr) x += abr[c];
        if (seg) x += (qseg == kseg[c]) ? 0.f : mask_value;
        p = expf(x - mi) * il;
        ds = (dp[c] - dii) * p;
      }
      p_w[c * BQ + lane] = p;
      ds_w[c * BQ + lane] = ds;
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
        dk[row * DH + d] = acc_dk[c][e];
        dv[row * DH + d] = acc_dv[c][e];
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

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ ab,
                              const int32_t* __restrict__ q_seg,
                              const int32_t* __restrict__ kv_seg,
                              const float* __restrict__ dout, const float* __restrict__ m,
                              const float* __restrict__ l, const float* __restrict__ di,
                              Strides st, int H, int Tq, int Tk, float mask_value,
                              float* __restrict__ dq, float* __restrict__ dab) {
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
  const float* qb = q + b * st.qb + h * st.qh;
  const float* kb = k + b * st.kb + h * st.kh;
  const float* vb = v + b * st.vb + h * st.vh;
  const size_t bh = (size_t)b * H + h;
  const float* dob = dout + bh * Tq * DH;
  const bool seg = q_seg != nullptr;
  float* ds_w = ds_s + warp * R * BK;

  for (int idx = tid; idx < ROWS * DH; idx += kThreads) {
    const int r = idx / DH, d = idx % DH, i = q0 + r;
    const bool ok = i < Tq;
    q_s[idx] = ok ? qb[i * st.qt + d] : 0.f;
    do_s[idx] = ok ? dob[(size_t)i * DH + d] : 0.f;
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
      k_s[j * LD + d] = ok ? kb[key * st.kt + d] : 0.f;
      v_s[j * LD + d] = ok ? vb[key * st.vt + d] : 0.f;
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
      const size_t rowoff = (bh * Tq + i) * (size_t)st.dabt + k0; // dab
      const size_t aboff = (bh * Tq + i) * (size_t)st.abt + k0;   // ab
#pragma unroll
      for (int c = 0; c < KPL; ++c) {
        const int j = lane + 32 * c;
        float ds = 0.f;
        if (kok[c] && il[r] != 0.f) {
          float x = s[r][c];
          if (ab) x += ab[aboff + j];
          if (seg) x += (qseg[r] == kseg[c]) ? 0.f : mask_value;
          const float p = expf(x - mi[r]) * il[r];
          ds = (dp[r][c] - dii[r]) * p;
        }
        if (dab != nullptr && kok[c] && i < Tq) dab[rowoff + j] = ds;
        ds_w[r * BK + j] = ds;
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
      if (d < DH) dq[(bh * Tq + i) * DH + d] = acc[r][e];
    }
  }
}

// ---------------------------------------------------------------------------
// K6b in bf16: tensor cores (wgmma) fed by TMA. A block owns 64 keys.
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kConsumers = 128;               // one warpgroup: the products
constexpr int kThreadsTc = kConsumers + 32;   // and one producer warp: TMA

template <int DH>
struct DkvShape {
  static constexpr int BK = 64;                        // keys of a block (wgmma M)
  static constexpr int BQ = DH <= 64 ? 64 : 32;        // query rows of a tile
  static constexpr int kStages = 3;                    // ring of Q, dO, ab tiles
  static constexpr int kSwz = DH >= 64 ? 128 : DH * 2; // bytes of a swizzled row
  static constexpr int kCols = kSwz / 2;               // its columns (TMA box)
  static constexpr int kHalves = DH / kCols;           // 2 at Dh = 128, else 1
  static constexpr int kKvBytes = BK * DH * 2;         // K or V, loaded once
  static constexpr int kRowBytes = BQ * DH * 2;        // one Q or dO tile
  static constexpr int kAbBytes = BQ * 64 * 2;         // one ab tile
  static constexpr int kValBytes = 1024;               // m, 1/l, di, q_seg of BQ rows
  static constexpr int kStageBytes = 2 * kRowBytes + kAbBytes + kValBytes;
  static constexpr int LD = DH + 4;                    // padded fp32 row
  static constexpr int QPL = BQ / 8;                   // query rows of a lane (dots)
  static constexpr int LT = BQ + 8;                    // padded row of S^T, dP^T
  // fp32 copies of K, V (once) and of the tile's Q, dO for the logits and
  // dP; then S^T and dP^T on their way to the accumulator layout
  static constexpr int kF32Offset = 2 * kKvBytes + kStages * kStageBytes;
  static constexpr int kTrOffset = kF32Offset + (2 * BK + 2 * BQ) * LD * 4;
  static constexpr int kBarOffset = kTrOffset + 2 * BK * LT * 4;
  // 1024 bytes of slack align the tiles (the swizzle atom)
  static constexpr size_t kSmemBytes = 1024 + kBarOffset + 8 * (2 * kStages + 1);
};

// ab[row][col] of a tile of 64-key rows stored with the 128-byte swizzle
__device__ __forceinline__ float ab_at(const uint8_t* tile, int row, int col) {
  const int off = hopper::swizzled(row, col >> 3, 128) + (col & 7) * 2;
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(tile + off));
}

// A bf16 tile of ROWS x DH as TMA stored it (kHalves column halves, each
// ROWS rows of kSwz bytes, swizzled) widened into fp32 rows of LD floats;
// the consumer warpgroup's threads share the work, consecutive lanes on
// consecutive rows (conflict-free on both sides).
template <int DH, int ROWS>
__device__ __forceinline__ void widen(const uint8_t* src, float* dst, int tid) {
  using S = DkvShape<DH>;
  constexpr int CPR = DH / 8, CPH = S::kSwz / 16;   // 16-byte chunks of a row, a half's row
  for (int c = tid; c < ROWS * CPR; c += kConsumers) {
    const int row = c % ROWS, ch = c / ROWS;
    const uint4 x = *reinterpret_cast<const uint4*>(
        src + (ch / CPH) * ROWS * S::kSwz + hopper::swizzled(row, ch % CPH, S::kSwz));
    float4* o = reinterpret_cast<float4*>(dst + row * S::LD + 8 * ch);
    const auto lo = [](uint32_t w) { return __uint_as_float(w << 16); };
    const auto hi = [](uint32_t w) { return __uint_as_float(w & 0xffff0000u); };
    o[0] = make_float4(lo(x.x), hi(x.x), lo(x.y), hi(x.y));
    o[1] = make_float4(lo(x.z), hi(x.z), lo(x.w), hi(x.w));
  }
}

// One warp's half of S^T = K Q^T (or of dP^T = V dO^T): the 64 keys against
// query rows h BQ / 2 .. (h + 1) BQ / 2 - 1, from fp32 rows of LD floats,
// one fp32 FMA a term in the order d = 0, 1, ..., Dh - 1: the order in which
// the plain version's fp32 products (cuBLAS) sum, so that p and dS round to
// bf16 exactly where the plain version's do. Lane (kg, qg) = (lane / 4,
// lane % 4) sums keys kg + 8 a (a < 8) against the row pairs 8 i + 2 qg +
// {0, 1} of the half: 8 + QPL 16-byte loads (conflict-free) a 32 QPL FMAs,
// so that at Dh <= 64 the shared-memory pipe keeps pace with the FMAs of
// the four warps. The sums go to tr[key][row] (rows of LT floats).
template <int DH, int BQ>
__device__ __forceinline__ void dots(const float* a_s, const float* b_s, float* tr, int h,
                                     int lane) {
  using S = DkvShape<DH>;
  constexpr int LD = S::LD, QPL = S::QPL;
  const int kg = lane / 4, q0 = h * BQ / 2 + 2 * (lane % 4);
  const float* a0 = a_s + kg * LD;
  const float* b0 = b_s + q0 * LD;
  float acc[8][QPL];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int i = 0; i < QPL; ++i) acc[r][i] = 0.f;
#pragma unroll 1
  for (int d = 0; d < DH; d += 4) {
    float4 x[8], y[QPL];
#pragma unroll
    for (int r = 0; r < 8; ++r) x[r] = *reinterpret_cast<const float4*>(a0 + 8 * r * LD + d);
#pragma unroll
    for (int i = 0; i < QPL; ++i)
      y[i] = *reinterpret_cast<const float4*>(b0 + (8 * (i / 2) + i % 2) * LD + d);
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int i = 0; i < QPL; ++i) {
        float t = acc[r][i];
        t = fmaf(y[i].x, x[r].x, t);
        t = fmaf(y[i].y, x[r].y, t);
        t = fmaf(y[i].z, x[r].z, t);
        t = fmaf(y[i].w, x[r].w, t);
        acc[r][i] = t;
      }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int i = 0; i < QPL; i += 2)
      *reinterpret_cast<float2*>(tr + (kg + 8 * r) * S::LT + q0 + 4 * i) =
          make_float2(acc[r][i], acc[r][i + 1]);
}

struct DkvArgs {
  const int32_t* q_seg;
  const int32_t* kv_seg;
  const float* m;
  const float* l;
  const float* di;
  int H, Tq, Tk;
  float mask_value;
  bool q_swap, k_swap, v_swap;  // th_swap of each map (dO is contiguous)
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
};

// One block: 64 keys of one (b, h), their K and V loaded once. Warps 0-3
// (one warpgroup) compute; warp 4 streams the Q, dO and ab tiles of every
// query tile, with the rows' m, 1/l, di and segment ids, through a ring of
// kStages stages. Transposed, so that the keys are wgmma's M: S^T = K Q^T
// and dP^T = V dO^T by fp32 FMAs (``dots``) from fp32 copies of the tiles,
// then dV += P^T dO and dK += dS^T Q by wgmma with P^T and dS^T rounded to
// bf16 in registers as the A operands and dO, Q read MN-major from the
// ring. HAS_AB and SEG (a bias; segment ids) are template arguments, so
// that the element loop holds no branch.
template <int DH, bool HAS_AB, bool SEG>
__global__ void __launch_bounds__(kThreadsTc, 1)
flash_attention_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                                  const __grid_constant__ CUtensorMap k_map,
                                  const __grid_constant__ CUtensorMap v_map,
                                  const __grid_constant__ CUtensorMap do_map,
                                  const __grid_constant__ CUtensorMap ab_map,
                                  const DkvArgs a) {
  using S = DkvShape<DH>;
  constexpr int BK = S::BK, BQ = S::BQ, NS = S::kStages, SWZ = S::kSwz, COLS = S::kCols,
                LD = S::LD;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* k_s = smem;
  uint8_t* v_s = smem + S::kKvBytes;
  uint8_t* stages = smem + 2 * S::kKvBytes;
  float* k32 = reinterpret_cast<float*>(smem + S::kF32Offset);   // [BK][LD]
  float* v32 = k32 + BK * LD;                                     // [BK][LD]
  float* q32 = v32 + BK * LD;                                     // [BQ][LD]
  float* do32 = q32 + BQ * LD;                                    // [BQ][LD]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::kBarOffset);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;        // [NS]: the stage's tiles have landed
  uint64_t* empty = bars + 1 + NS;  // [NS]: the consumers are done with it

  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_tiles = (a.Tq + BQ - 1) / BQ;
  const size_t bh = (size_t)b * a.H + h;

  if (tid == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // ---- producer warp
    if (lane == 0) {
      hopper::prefetch_map(&q_map);
      hopper::prefetch_map(&do_map);
      hopper::mbar_arrive_expect_tx(kv_full, 2 * S::kKvBytes);
      for (int half = 0; half < S::kHalves; ++half) {
        hopper::load_rows(k_s + half * BK * SWZ, &k_map, kv_full, half * COLS, k0, h, b,
                          a.k_swap);
        hopper::load_rows(v_s + half * BK * SWZ, &v_map, kv_full, half * COLS, k0, h, b,
                          a.v_swap);
      }
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % NS, i0 = t * BQ;
      if (t >= NS) hopper::mbar_wait(&empty[s], ((t / NS) - 1) & 1);
      uint8_t* st = stages + s * S::kStageBytes;
      float* m_s = reinterpret_cast<float*>(st + 2 * S::kRowBytes + S::kAbBytes);
      for (int r = lane; r < BQ; r += 32)
        row_values(a.m, a.l, a.di, a.q_seg, bh, b, i0 + r, a.Tq, m_s[r], m_s[BQ + r],
                   m_s[2 * BQ + r], reinterpret_cast<int*>(m_s + 3 * BQ)[r]);
      __syncwarp();
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(
            &full[s], 2 * S::kRowBytes + (HAS_AB ? S::kAbBytes : 0));
        for (int half = 0; half < S::kHalves; ++half) {
          hopper::load_rows(st + half * BQ * SWZ, &q_map, &full[s], half * COLS, i0, h, b,
                            a.q_swap);
          hopper::load_rows(st + S::kRowBytes + half * BQ * SWZ, &do_map, &full[s],
                            half * COLS, i0, h, b, false);
        }
        if (HAS_AB)
          hopper::tma_load_4d(st + 2 * S::kRowBytes, &ab_map, &full[s], k0, i0, h, b);
      }
    }
    return;
  }

  // ---- consumer warpgroup: thread (warp, lane) holds key rows r0 and r0 + 8
  // of every accumulator, and in its 8-column chunk j the columns 8 j + kc + {0, 1}
  const int r0 = 16 * warp + lane / 4, kc = 2 * (lane % 4);
  const int key0 = k0 + r0, key1 = key0 + 8;
  // S^T and dP^T: [BK][LT] each
  float* tr_s = reinterpret_cast<float*>(smem + S::kTrOffset);
  float* tr_d = tr_s + BK * S::LT;
  const bool kok0 = key0 < a.Tk, kok1 = key1 < a.Tk;
  const int kseg0 = (SEG && kok0) ? a.kv_seg[(size_t)b * a.Tk + key0] : 0;
  const int kseg1 = (SEG && kok1) ? a.kv_seg[(size_t)b * a.Tk + key1] : 0;
  float dk[DH / 2], dv[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dk[i] = dv[i] = 0.f;
  float sc[BQ / 2], dp[BQ / 2];
  uint32_t pa[BQ / 16][4], da[BQ / 16][4];

  // keys past Tk come zero-filled from TMA; they are selected away below
  hopper::mbar_wait(kv_full, 0);
  widen<DH, BK>(k_s, k32, tid);
  widen<DH, BK>(v_s, v32, tid);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % NS;
    const uint8_t* st = stages + s * S::kStageBytes;
    hopper::mbar_wait(&full[s], (t / NS) & 1);

    // ---- S^T = K Q^T, dP^T = V dO^T in fp32, summed as the plain version sums
    widen<DH, BQ>(st, q32, tid);
    widen<DH, BQ>(st + S::kRowBytes, do32, tid);
    hopper::named_sync(1, kConsumers);   // the fp32 tiles are written
    // warps 0, 1: the halves of S^T; warps 2, 3: the halves of dP^T
    if (warp < 2)
      dots<DH, BQ>(k32, q32, tr_s, warp, lane);
    else
      dots<DH, BQ>(v32, do32, tr_d, warp - 2, lane);
    hopper::named_sync(1, kConsumers);   // S^T, dP^T written; the fp32 tiles read
    // the accumulator layout: key rows r0 and r0 + 8, columns 8 j + kc + {0, 1}
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int o = (r0 + 8 * u) * S::LT + 8 * j + kc;
        const float2 x = *reinterpret_cast<const float2*>(tr_s + o);
        const float2 y = *reinterpret_cast<const float2*>(tr_d + o);
        sc[4 * j + 2 * u] = x.x;
        sc[4 * j + 2 * u + 1] = x.y;
        dp[4 * j + 2 * u] = y.x;
        dp[4 * j + 2 * u + 1] = y.y;
      }

    // ---- p and dS of each (key, row); a row past Tq, or whose logits are all
    // -inf, has m = 0 and 1/l = 0, so p = 0 (its logits are 0 or below); a
    // key past Tk is selected away
    const uint8_t* ab_s = st + 2 * S::kRowBytes;
    const float* m_s = reinterpret_cast<const float*>(ab_s + S::kAbBytes);
    const int* qseg_s = reinterpret_cast<const int*>(m_s + 3 * BQ);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + kc + e;
        const float mi = m_s[c], il = m_s[BQ + c], dii = m_s[2 * BQ + c];
        const int qs = qseg_s[c];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int idx = 4 * j + 2 * u + e;
          float x = sc[idx];
          if (HAS_AB) x += ab_at(ab_s, c, r0 + 8 * u);
          if (SEG) x += (qs == (u ? kseg1 : kseg0)) ? 0.f : a.mask_value;
          // expf of every element, kept or not (no branch around it), so
          // that the exponentials of a thread overlap
          const float ex = expf(x - mi);
          const float p = (u ? kok1 : kok0) ? ex * il : 0.f;
          sc[idx] = p;
          dp[idx] = (dp[idx] - dii) * p;
        }
      }
    }
    // P^T and dS^T rounded to bf16: the register A fragments
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = hopper::pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
        da[kk][r] = hopper::pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
      }
    }

    // ---- dV += P^T dO, dK += dS^T Q (dO and Q MN-major from shared memory)
    hopper::fence_regs(dv);
    hopper::fence_regs(dk);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      hopper::Wgmma<DH>::rs(
          dv, pa[kk],
          hopper::make_desc(st + S::kRowBytes + kk * 16 * SWZ, BQ * SWZ, 8 * SWZ, SWZ), 1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      hopper::Wgmma<DH>::rs(
          dk, da[kk], hopper::make_desc(st + kk * 16 * SWZ, BQ * SWZ, 8 * SWZ, SWZ), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dv);
    hopper::fence_regs(dk);
    hopper::mbar_arrive(&empty[s]);
  }

  // ---- epilogue: dK and dV of the block's keys in bf16
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int d = 8 * j + kc;
    if (kok0) {
      const size_t o = (bh * a.Tk + key0) * DH + d;
      *reinterpret_cast<uint32_t*>(&a.dk[o]) = hopper::pack_bf16(dk[4 * j], dk[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(&a.dv[o]) = hopper::pack_bf16(dv[4 * j], dv[4 * j + 1]);
    }
    if (kok1) {
      const size_t o = (bh * a.Tk + key1) * DH + d;
      *reinterpret_cast<uint32_t*>(&a.dk[o]) =
          hopper::pack_bf16(dk[4 * j + 2], dk[4 * j + 3]);
      *reinterpret_cast<uint32_t*>(&a.dv[o]) =
          hopper::pack_bf16(dv[4 * j + 2], dv[4 * j + 3]);
    }
  }
}


// ---------------------------------------------------------------------------
// K6c in bf16: dQ on the tensor cores (wgmma) fed by TMA. A block owns 64
// query rows.
// ---------------------------------------------------------------------------

constexpr int kGroupsDq = 2;                    // consumer warpgroups
constexpr int kConsumersDq = 128 * kGroupsDq;
constexpr int kThreadsDq = kConsumersDq + 32;   // and one producer warp: TMA
constexpr int kSkipTiles = 512;                 // key tiles the skip rule sees

template <int DH>
struct DqShape {
  static constexpr int BM = 64;                        // query rows of a block (wgmma M)
  static constexpr int BK = 64;                        // keys of a tile
  static constexpr int kStages = DH <= 64 ? 4 : 2;     // ring of K, V, ab tiles
  // Dh <= 64: each group's dQ waits in shared memory between its products,
  // so that the fp32 products have the registers (168 a thread) to
  // themselves; at Dh = 128 it stays in registers (no room)
  static constexpr bool kDqShared = DH <= 64;
  static constexpr int kSwz = DH >= 64 ? 128 : DH * 2; // bytes of a swizzled row
  static constexpr int kCols = kSwz / 2;               // its columns (TMA box)
  static constexpr int kHalves = DH / kCols;           // 2 at Dh = 128, else 1
  static constexpr int kKvBytes = BK * DH * 2;         // one K or V tile
  static constexpr int kAbBytes = BM * BK * 2;         // one ab tile
  static constexpr int kSegBytes = 1024;               // the tile's key segment ids
  static constexpr int kStageBytes = 2 * kKvBytes + kAbBytes + kSegBytes;
  static constexpr int LDB = DH + 8;                   // padded bf16 row of Q, dO
  static constexpr int LT = BK + 4;                    // padded fp32 row of S, dP
                                                       // (the stores conflict-free)
  // the block's Q and dO rows (once, in padded rows); each group's S and dP
  // on their way to the accumulator layout; the live key tiles; barriers
  static constexpr int kRowsOffset = kStages * kStageBytes;
  static constexpr int kTrOffset = kRowsOffset + 2 * BM * LDB * 2;
  static constexpr int kLiveOffset = kTrOffset + kGroupsDq * 2 * BM * LT * 4;
  static constexpr int kDqOffset = kLiveOffset + kSkipTiles + 16;
  static constexpr int kBarOffset = kDqOffset + (kDqShared ? kGroupsDq * BM * DH * 4 : 0);
  // 1024 bytes of slack align the tiles (the swizzle atom)
  static constexpr size_t kSmemBytes = 1024 + kBarOffset + 8 * (2 * kStages);
};

// One warp's half of S = Q K^T (or of dP = dO V^T): query rows 32 hf ..
// 32 hf + 31 (bf16, rows of LDB elements) against the tile's 64 keys, read
// as TMA stored them (bf16, swizzled), both widened in registers, one fp32
// FMA a term in the order d = 0, 1, ..., Dh - 1: the order in which the
// plain version's fp32 products (cuBLAS) sum, so that p and dS round to
// bf16 exactly where the plain version's do. Lane (kg, qg) = (lane / 4,
// lane % 4) sums keys kg + 8 a (a < 8) against the row pairs 8 i + 2 qg +
// {0, 1} of the half: per 4 values of d, 16 8-byte loads (conflict-free)
// feed 256 FMAs, the rows in two halves of 4 (the 8-byte loads and the
// halves keep the live registers within the 168 a thread of a 288-thread
// block, and the bytes read from shared memory a third below fp32 rows').
// The sums go to tr[row][key] (rows of LT floats).
template <int DH>
__device__ __forceinline__ void dots_dq(const __nv_bfloat16* rows, const uint8_t* keys,
                                        float* tr, int hf, int lane) {
  using S = DqShape<DH>;
  constexpr int LDB = S::LDB, LT = S::LT, SWZ = S::kSwz, CPH = SWZ / 16, BK = S::BK;
  const int kg = lane / 4, q0 = 32 * hf + 2 * (lane % 4);
  const __nv_bfloat16* b0 = rows + q0 * LDB;
  const auto lo = [](uint32_t w) { return __uint_as_float(w << 16); };
  const auto hi = [](uint32_t w) { return __uint_as_float(w & 0xffff0000u); };
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[r][i] = 0.f;
#pragma unroll 1
  for (int c = 0; c < DH / 8; ++c) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      // 4 values of d (8 bytes) of each of the lane's keys
      uint2 kr[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        kr[r] = *reinterpret_cast<const uint2*>(
            keys + (c / CPH) * BK * SWZ + hopper::swizzled(kg + 8 * r, c % CPH, SWZ) + 8 * hh);
#pragma unroll
      for (int ih = 0; ih < 2; ++ih) {
        float4 y[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint2 w = *reinterpret_cast<const uint2*>(
              b0 + (8 * (2 * ih + i / 2) + i % 2) * LDB + 8 * c + 4 * hh);
          y[i] = make_float4(lo(w.x), hi(w.x), lo(w.y), hi(w.y));
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float x0 = lo(kr[r].x), x1 = hi(kr[r].x), x2 = lo(kr[r].y), x3 = hi(kr[r].y);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float t = acc[r][4 * ih + i];
            t = fmaf(y[i].x, x0, t);
            t = fmaf(y[i].y, x1, t);
            t = fmaf(y[i].z, x2, t);
            t = fmaf(y[i].w, x3, t);
            acc[r][4 * ih + i] = t;
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int i = 0; i < 8; ++i) tr[(q0 + 8 * (i / 2) + i % 2) * LT + kg + 8 * r] = acc[r][i];
}

// ab[row][col], ab[row][col + 1] (col even) of a 64 x 64 bf16 tile stored
// with the 128-byte swizzle
__device__ __forceinline__ float2 ab_pair(const uint8_t* tile, int row, int col) {
  const int off = hopper::swizzled(row, col >> 3, 128) + (col & 7) * 2;
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(tile + off));
}

struct DqArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* dout;
  const int32_t* q_seg;
  const int32_t* kv_seg;
  const float* m;
  const float* l;
  const float* di;
  long long qb, qh, qt;   // q's element strides
  long long dab_st;       // dab's row stride (a multiple of 8)
  int H, Tq, Tk;
  float mask_value;
  bool k_swap, v_swap;    // th_swap of each map
  __nv_bfloat16* dq;
  __nv_bfloat16* dab;
};

// One block: 64 query rows of one (b, h), their Q and dO loaded and widened
// to fp32 once, with their m, 1/l, di and segment ids. The block first
// marks the key tiles it must take (with segment ids, the skip rule of
// ``skippable_tiles`` in ops/kernels/flash_attention.py; without, all).
// Warp 8 streams the K, V and ab tiles and the key segment ids of every
// live key tile through a ring of kStages stages; two warpgroups take every
// other live tile. A group computes S = Q K^T and dP = dO V^T by fp32 FMAs
// (``dots_dq``: two warps each) into shared memory, takes them in the
// m64n64 accumulator layout, where p (expf) and dS are computed and, rounded
// to bf16, written as dab and used as the register A operand of
// dQ += dS K (wgmma, K read MN-major from the ring). At the end the second
// group's dQ joins the first's through shared memory and dq is rounded
// once; the skipped tiles' dab is written as zeros. HAS_AB and SEG (a bias;
// segment ids) are template arguments, so that the element loop holds no
// branch.
template <int DH, bool HAS_AB, bool SEG>
__global__ void __launch_bounds__(kThreadsDq, 1)
flash_attention_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap k_map,
                                 const __grid_constant__ CUtensorMap v_map,
                                 const __grid_constant__ CUtensorMap ab_map,
                                 const DqArgs a) {
  using S = DqShape<DH>;
  constexpr int BM = S::BM, BK = S::BK, NS = S::kStages, SWZ = S::kSwz, COLS = S::kCols,
                LDB = S::LDB, LT = S::LT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* stages = smem;
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + S::kRowsOffset);  // [BM][LDB]
  __nv_bfloat16* do_s = q_s + BM * LDB;                                            // [BM][LDB]
  float* tr = reinterpret_cast<float*>(smem + S::kTrOffset);     // [group][S, dP][BM][LT]
  uint8_t* live = smem + S::kLiveOffset;                          // [kSkipTiles]
  int* rows_info = reinterpret_cast<int*>(live + kSkipTiles);     // min, max seg; a row at the mask
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::kBarOffset);
  uint64_t* full = bars;            // [NS]: the stage's tiles have landed
  uint64_t* empty = bars + NS;      // [NS]: the group that took it is done with it

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_tiles = (a.Tk + BK - 1) / BK;
  const size_t bh = (size_t)b * a.H + h;
  const int marked = n_tiles < kSkipTiles ? n_tiles : kSkipTiles;

  // ---- the skip rule: a key tile none of whose keys has a segment id in
  // [min, max] of the block's rows' is skipped, unless a row's m is at the
  // mask level (every key masked: its p is not 0). Tiles past kSkipTiles are
  // always taken.
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 128);
    }
    hopper::fence_barrier_init();
    rows_info[0] = INT_MAX;
    rows_info[1] = INT_MIN;
    rows_info[2] = 0;
  }
  for (int t = tid; t < marked; t += kThreadsDq) live[t] = SEG ? 0 : 1;
  __syncthreads();
  if (SEG) {
    if (tid < BM && q0 + tid < a.Tq) {
      const int i = q0 + tid;
      const int sg = a.q_seg[(size_t)b * a.Tq + i];
      atomicMin(&rows_info[0], sg);
      atomicMax(&rows_info[1], sg);
      if (!(a.m[bh * a.Tq + i] > 0.5f * a.mask_value)) atomicOr(&rows_info[2], 1);
    }
    __syncthreads();
    const int rmin = rows_info[0], rmax = rows_info[1];
    if (rows_info[2]) {
      for (int t = tid; t < marked; t += kThreadsDq) live[t] = 1;
    } else {
      for (int j = tid; j < marked * BK && j < a.Tk; j += kThreadsDq) {
        const int ks = a.kv_seg[(size_t)b * a.Tk + j];
        if (ks >= rmin && ks <= rmax) live[j / BK] = 1;
      }
    }
    __syncthreads();
  }
  const auto is_live = [&](int t) { return t >= kSkipTiles || live[t] != 0; };

  if (warp == kConsumersDq / 32) {
    // ---- producer warp
    if (lane == 0) {
      hopper::prefetch_map(&k_map);
      hopper::prefetch_map(&v_map);
    }
    int it = 0;
    for (int t = 0; t < n_tiles; ++t) {
      if (!is_live(t)) continue;
      const int s = it % NS, k0 = t * BK;
      if (it >= NS) hopper::mbar_wait(&empty[s], ((it / NS) - 1) & 1);
      uint8_t* st = stages + s * S::kStageBytes;
      if (SEG) {
        int32_t* kseg = reinterpret_cast<int32_t*>(st + 2 * S::kKvBytes + S::kAbBytes);
        for (int j = lane; j < BK; j += 32)
          kseg[j] = k0 + j < a.Tk ? a.kv_seg[(size_t)b * a.Tk + k0 + j] : 0;
        __syncwarp();
      }
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(&full[s],
                                      2 * S::kKvBytes + (HAS_AB ? S::kAbBytes : 0));
        for (int half = 0; half < S::kHalves; ++half) {
          hopper::load_rows(st + half * BK * SWZ, &k_map, &full[s], half * COLS, k0, h, b,
                            a.k_swap);
          hopper::load_rows(st + S::kKvBytes + half * BK * SWZ, &v_map, &full[s],
                            half * COLS, k0, h, b, a.v_swap);
        }
        if (HAS_AB)
          hopper::tma_load_4d(st + 2 * S::kKvBytes, &ab_map, &full[s], k0, q0, h, b);
      }
      ++it;
    }
    return;
  }

  // ---- consumer warpgroup wg: thread (warp, lane) holds rows r0 and r0 + 8
  // of every accumulator, and in its 8-column chunk j the columns
  // 8 j + kc + {0, 1}
  const int wg = warp / 4, wl = warp % 4, gt = tid % 128;
  const int r0 = 16 * wl + lane / 4, kc = 2 * (lane % 4);
  const int i0 = q0 + r0, i1 = i0 + 8;
  float* tr_s = tr + wg * 2 * BM * LT;
  float* tr_d = tr_s + BM * LT;

  // the fixed operands: Q and dO of the block's rows (zeros past Tq)
  for (int e = tid; e < BM * DH / 8; e += kConsumersDq) {
    const int row = e / (DH / 8), ch = e % (DH / 8), i = q0 + row;
    uint4 qv = make_uint4(0u, 0u, 0u, 0u), gv = qv;
    if (i < a.Tq) {
      qv = *reinterpret_cast<const uint4*>(a.q + b * a.qb + h * a.qh + i * a.qt + 8 * ch);
      gv = *reinterpret_cast<const uint4*>(a.dout + (bh * a.Tq + i) * DH + 8 * ch);
    }
    *reinterpret_cast<uint4*>(q_s + row * LDB + 8 * ch) = qv;
    *reinterpret_cast<uint4*>(do_s + row * LDB + 8 * ch) = gv;
  }
  // a row past Tq, or whose logits are all -inf, has m = 0 and 1/l = 0, so
  // p = 0 (its logits are 0 or below)
  float mi[2], il[2], dii[2];
  int qs[2];
  row_values(a.m, a.l, a.di, a.q_seg, bh, b, i0, a.Tq, mi[0], il[0], dii[0], qs[0]);
  row_values(a.m, a.l, a.di, a.q_seg, bh, b, i1, a.Tq, mi[1], il[1], dii[1], qs[1]);
  // the group's dQ in shared memory (kDqShared), thread gt's 4 j-th values
  // at float4 j * 128 + gt, or in registers
  float4* dq_s = reinterpret_cast<float4*>(smem + S::kDqOffset) + wg * (DH / 8) * 128;
  float dq[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dq[i] = 0.f;
  if (S::kDqShared) {
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) dq_s[j * 128 + gt] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float sc[BK / 2], dp[BK / 2];
  uint32_t da[BK / 16][4];
  hopper::named_sync(1, kConsumersDq);   // q_s, do_s written

  int it = 0;
  for (int t = 0; t < n_tiles; ++t) {
    if (!is_live(t)) continue;
    if (it++ % kGroupsDq != wg) continue;
    const int s = (it - 1) % NS, k0 = t * BK;
    const uint8_t* st = stages + s * S::kStageBytes;
    hopper::mbar_wait(&full[s], ((it - 1) / NS) & 1);

    // ---- S = Q K^T, dP = dO V^T in fp32, summed as the plain version sums
    hopper::named_sync(2 + wg, 128);   // the group's previous S, dP are read
    if (wl < 2)
      dots_dq<DH>(q_s, st, tr_s, wl, lane);
    else
      dots_dq<DH>(do_s, st + S::kKvBytes, tr_d, wl - 2, lane);
    hopper::named_sync(2 + wg, 128);   // S, dP written
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int o = (r0 + 8 * u) * LT + 8 * j + kc;
        const float2 x = *reinterpret_cast<const float2*>(tr_s + o);
        const float2 y = *reinterpret_cast<const float2*>(tr_d + o);
        sc[4 * j + 2 * u] = x.x;
        sc[4 * j + 2 * u + 1] = x.y;
        dp[4 * j + 2 * u] = y.x;
        dp[4 * j + 2 * u + 1] = y.y;
      }

    // ---- p and dS of each (row, key); a key past Tk is selected away
    const uint8_t* ab_s = st + 2 * S::kKvBytes;
    const int* kseg = reinterpret_cast<const int*>(ab_s + S::kAbBytes);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const int col = 8 * j + kc;
      float2 ab0 = make_float2(0.f, 0.f), ab1 = ab0;
      if (HAS_AB) {
        ab0 = ab_pair(ab_s, r0, col);
        ab1 = ab_pair(ab_s, r0 + 8, col);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool kok = k0 + col + e < a.Tk;
        const int ks = SEG ? kseg[col + e] : 0;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int idx = 4 * j + 2 * u + e;
          float x = sc[idx];
          if (HAS_AB) x += u ? (e ? ab1.y : ab1.x) : (e ? ab0.y : ab0.x);
          if (SEG) x += (qs[u] == ks) ? 0.f : a.mask_value;
          const float p = kok ? expf(x - mi[u]) * il[u] : 0.f;
          dp[idx] = (dp[idx] - dii[u]) * p;
        }
      }
    }
    // dS rounded to bf16: the register A fragments, and dab
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        da[kk][r] = hopper::pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
    // dab: the rounded dS staged in the S buffer (rows of 72 bf16), so that
    // it leaves in 16-byte stores along dab's rows (padded to 8 elements)
    uint32_t* stage_d = reinterpret_cast<uint32_t*>(tr_s);
    if (a.dab != nullptr) {
      hopper::named_sync(2 + wg, 128);   // the group's S, dP are read
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u)
          stage_d[(r0 + 8 * u) * 36 + 4 * j + kc / 2] = da[j / 2][2 * (j % 2) + u];
      hopper::named_sync(2 + wg, 128);   // staged
    }

    // ---- dQ += dS K (K MN-major from shared memory)
    if (S::kDqShared) {
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const float4 x = dq_s[j * 128 + gt];
        dq[4 * j] = x.x;
        dq[4 * j + 1] = x.y;
        dq[4 * j + 2] = x.z;
        dq[4 * j + 3] = x.w;
      }
    }
    hopper::fence_regs(dq);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hopper::Wgmma<DH>::rs(dq, da[kk],
                            hopper::make_desc(st + kk * 16 * SWZ, BK * SWZ, 8 * SWZ, SWZ), 1);
    hopper::wgmma_commit();
    if (a.dab != nullptr) {
      // while the product runs
#pragma unroll
      for (int e = gt; e < BM * BK / 8; e += 128) {
        const int row = e / (BK / 8), ch = e % (BK / 8), i = q0 + row, col = k0 + 8 * ch;
        if (i < a.Tq && col < a.Tk)
          *reinterpret_cast<uint4*>(a.dab + (bh * a.Tq + i) * a.dab_st + col) =
              *reinterpret_cast<const uint4*>(stage_d + row * 36 + 4 * ch);
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dq);
    if (S::kDqShared) {
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        dq_s[j * 128 + gt] = make_float4(dq[4 * j], dq[4 * j + 1], dq[4 * j + 2], dq[4 * j + 3]);
    }
    hopper::mbar_arrive(&empty[s]);
  }

  // ---- the skipped tiles' dab: exact zeros (16 bytes a store: dab's rows
  // are padded to 8 elements)
  if (SEG && a.dab != nullptr) {
    for (int t = 0; t < marked; ++t) {
      if (live[t]) continue;
      for (int e = tid; e < BM * BK / 8; e += kConsumersDq) {
        const int i = q0 + e / (BK / 8), col = t * BK + 8 * (e % (BK / 8));
        if (i < a.Tq && col < a.Tk)
          *reinterpret_cast<uint4*>(a.dab + (bh * a.Tq + i) * a.dab_st + col) =
              make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }

  // ---- merge: group 1 hands its dQ to group 0 through shared memory (the
  // S, dP buffers where dQ stays in registers)
  float4* xch = S::kDqShared   // group 1's dQ, [DH / 8][128]
                    ? reinterpret_cast<float4*>(smem + S::kDqOffset) + (DH / 8) * 128
                    : reinterpret_cast<float4*>(tr);
  hopper::named_sync(1, kConsumersDq);
  if (wg == 1) {
    if (!S::kDqShared) {
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        xch[j * 128 + gt] = make_float4(dq[4 * j], dq[4 * j + 1], dq[4 * j + 2], dq[4 * j + 3]);
    }
  } else if (S::kDqShared) {
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const float4 x = dq_s[j * 128 + gt];
      dq[4 * j] = x.x;
      dq[4 * j + 1] = x.y;
      dq[4 * j + 2] = x.z;
      dq[4 * j + 3] = x.w;
    }
  }
  hopper::named_sync(1, kConsumersDq);
  if (wg == 1) return;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int d = 8 * j + kc;
    const float4 x = xch[j * 128 + gt];
    const float a0 = dq[4 * j] + x.x, a1 = dq[4 * j + 1] + x.y;
    const float a2 = dq[4 * j + 2] + x.z, a3 = dq[4 * j + 3] + x.w;
    if (i0 < a.Tq)
      *reinterpret_cast<uint32_t*>(&a.dq[(bh * a.Tq + i0) * DH + d]) = hopper::pack_bf16(a0, a1);
    if (i1 < a.Tq)
      *reinterpret_cast<uint32_t*>(&a.dq[(bh * a.Tq + i1) * DH + d]) = hopper::pack_bf16(a2, a3);
  }
}

}  // namespace tc

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
template <int DH, bool DKV, typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  static bool done = false;
  if (done || bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  done = err == cudaSuccess;
  return err;
}

template <int DH>
cudaError_t launch_dkv(const Args& a) {
  using S = DkvShape<DH>;
  auto kernel = flash_attention_bwd_dkv_kernel<DH>;
  cudaError_t err = allow_smem<DH, true>(kernel, S::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tk + S::BK - 1) / S::BK, a.H, a.B);
  kernel<<<grid, kThreads, S::kSmemBytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
      static_cast<const float*>(a.ab), a.q_seg, a.kv_seg, static_cast<const float*>(a.dout), a.m,
      a.l, a.di, a.st, a.H, a.Tq, a.Tk, a.mask_value, static_cast<float*>(a.out0),
      static_cast<float*>(a.out1));
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dq(const Args& a) {
  using S = DqShape<DH>;
  auto kernel = flash_attention_bwd_dq_kernel<DH>;
  cudaError_t err = allow_smem<DH, false>(kernel, S::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + S::ROWS - 1) / S::ROWS, a.H, a.B);
  kernel<<<grid, kThreads, S::kSmemBytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.ab), a.q_seg, a.kv_seg,
      static_cast<const float*>(a.dout), a.m, a.l, a.di, a.st, a.H, a.Tq, a.Tk,
      a.mask_value, static_cast<float*>(a.out0), static_cast<float*>(a.out1));
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dkv_tc(const Args& a) {
  using S = tc::DkvShape<DH>;
  tc::DkvArgs d{a.q_seg, a.kv_seg, a.m, a.l, a.di, a.H, a.Tq, a.Tk, a.mask_value,
                false, false, false,
                static_cast<__nv_bfloat16*>(a.out0), static_cast<__nv_bfloat16*>(a.out1)};
  const Strides& st = a.st;
  const long long do_sh = (long long)a.Tq * DH;
  CUtensorMap qm, km, vm, dom, abm;
  bool do_swap = false;
  cudaError_t err = hopper::map_rows(&qm, a.q, st.qb, st.qh, st.qt, a.B, a.H, a.Tq, DH,
                                     S::kCols, S::BQ, S::kSwz, &d.q_swap);
  if (err == cudaSuccess)
    err = hopper::map_rows(&km, a.k, st.kb, st.kh, st.kt, a.B, a.H, a.Tk, DH, S::kCols,
                           S::BK, S::kSwz, &d.k_swap);
  if (err == cudaSuccess)
    err = hopper::map_rows(&vm, a.v, st.vb, st.vh, st.vt, a.B, a.H, a.Tk, DH, S::kCols,
                           S::BK, S::kSwz, &d.v_swap);
  if (err == cudaSuccess)
    err = hopper::map_rows(&dom, a.dout, a.H * do_sh, do_sh, DH, a.B, a.H, a.Tq, DH,
                           S::kCols, S::BQ, S::kSwz, &do_swap);
  if (err == cudaSuccess && do_swap) err = cudaErrorInvalidValue;
  if (err == cudaSuccess) {
    if (a.ab != nullptr)
      err = hopper::map_bias(&abm, a.ab, st.abt, a.B, a.H, a.Tq, a.Tk, S::BQ);
    else
      abm = qm;  // not read
  }
  if (err != cudaSuccess) return err;
  const bool has_ab = a.ab != nullptr, seg = a.q_seg != nullptr;
  auto kernel = has_ab ? (seg ? tc::flash_attention_bwd_dkv_tc_kernel<DH, true, true>
                              : tc::flash_attention_bwd_dkv_tc_kernel<DH, true, false>)
                       : (seg ? tc::flash_attention_bwd_dkv_tc_kernel<DH, false, true>
                              : tc::flash_attention_bwd_dkv_tc_kernel<DH, false, false>);
  static bool smem_allowed[4] = {false, false, false, false};
  const int variant = 2 * has_ab + seg;
  if (!smem_allowed[variant]) {
    err = hopper::allow_smem(kernel, S::kSmemBytes);
    if (err != cudaSuccess) return err;
    smem_allowed[variant] = true;
  }
  const dim3 grid((a.Tk + S::BK - 1) / S::BK, a.H, a.B);
  kernel<<<grid, tc::kThreadsTc, S::kSmemBytes, a.stream>>>(qm, km, vm, dom, abm, d);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dq_tc(const Args& a) {
  using S = tc::DqShape<DH>;
  const Strides& st = a.st;
  tc::DqArgs d{static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.dout),
               a.q_seg, a.kv_seg, a.m, a.l, a.di, st.qb, st.qh, st.qt, st.dabt, a.H, a.Tq,
               a.Tk, a.mask_value, false, false,
               static_cast<__nv_bfloat16*>(a.out0), static_cast<__nv_bfloat16*>(a.out1)};
  // the fixed operands are read with 16-byte loads, dab written 16 bytes a
  // store where a tile is skipped
  if ((a.Tq > 1 && st.qt % 8) || (a.H > 1 && st.qh % 8) || (a.B > 1 && st.qb % 8) ||
      reinterpret_cast<uintptr_t>(a.q) % 16 ||
      reinterpret_cast<uintptr_t>(a.dout) % 16 ||
      (a.out1 != nullptr && (st.dabt % 8 || st.dabt < a.Tk ||
                             reinterpret_cast<uintptr_t>(a.out1) % 16)))
    return cudaErrorInvalidValue;
  CUtensorMap km, vm, abm;
  cudaError_t err = hopper::map_rows(&km, a.k, st.kb, st.kh, st.kt, a.B, a.H, a.Tk, DH,
                                     S::kCols, S::BK, S::kSwz, &d.k_swap);
  if (err == cudaSuccess)
    err = hopper::map_rows(&vm, a.v, st.vb, st.vh, st.vt, a.B, a.H, a.Tk, DH, S::kCols,
                           S::BK, S::kSwz, &d.v_swap);
  if (err == cudaSuccess) {
    if (a.ab != nullptr)
      err = hopper::map_bias(&abm, a.ab, st.abt, a.B, a.H, a.Tq, a.Tk, S::BM);
    else
      abm = km;  // not read
  }
  if (err != cudaSuccess) return err;
  const bool has_ab = a.ab != nullptr, seg = a.q_seg != nullptr;
  auto kernel = has_ab ? (seg ? tc::flash_attention_bwd_dq_tc_kernel<DH, true, true>
                              : tc::flash_attention_bwd_dq_tc_kernel<DH, true, false>)
                       : (seg ? tc::flash_attention_bwd_dq_tc_kernel<DH, false, true>
                              : tc::flash_attention_bwd_dq_tc_kernel<DH, false, false>);
  static bool smem_allowed[4] = {false, false, false, false};
  const int variant = 2 * has_ab + seg;
  if (!smem_allowed[variant]) {
    err = hopper::allow_smem(kernel, S::kSmemBytes);
    if (err != cudaSuccess) return err;
    smem_allowed[variant] = true;
  }
  const dim3 grid((a.Tq + S::BM - 1) / S::BM, a.H, a.B);
  kernel<<<grid, tc::kThreadsDq, S::kSmemBytes, a.stream>>>(km, vm, abm, d);
  return cudaGetLastError();
}

// K6b: fp32 SIMT (dtype 0) or bf16 tensor cores (dtype 1)
cudaError_t dispatch_dkv(int dtype, int Dh, const Args& a) {
  switch (Dh) {
    case 16: return dtype == 0 ? launch_dkv<16>(a) : launch_dkv_tc<16>(a);
    case 32: return dtype == 0 ? launch_dkv<32>(a) : launch_dkv_tc<32>(a);
    case 64: return dtype == 0 ? launch_dkv<64>(a) : launch_dkv_tc<64>(a);
    case 128: return dtype == 0 ? launch_dkv<128>(a) : launch_dkv_tc<128>(a);
    default: return cudaErrorInvalidValue;
  }
}

// K6c: fp32 SIMT (dtype 0) or bf16 tensor cores (dtype 1)
cudaError_t dispatch_dq(int dtype, int Dh, const Args& a) {
  switch (Dh) {
    case 16: return dtype == 0 ? launch_dq<16>(a) : launch_dq_tc<16>(a);
    case 32: return dtype == 0 ? launch_dq<32>(a) : launch_dq_tc<32>(a);
    case 64: return dtype == 0 ? launch_dq<64>(a) : launch_dq_tc<64>(a);
    case 128: return dtype == 0 ? launch_dq<128>(a) : launch_dq_tc<128>(a);
    default: return cudaErrorInvalidValue;
  }
}

int run(bool dkv, int dtype, const Args& a, int Dh) {
  if ((a.q_seg == nullptr) != (a.kv_seg == nullptr) || a.Tq < 1 || a.Tk < 1 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return (int)(dkv ? dispatch_dkv(dtype, Dh, a) : dispatch_dq(dtype, Dh, a));
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, ab, dout and the gradients). q
// (B,H,Tq,Dh), k and v (B,H,Tk,Dh) with the given element strides of their
// first three dimensions (bf16: multiples of 8, 16-byte aligned bases); ab
// (B,H,Tq,Tk) with rows ab_st elements apart (bf16: a multiple of 8) and a
// contiguous last dimension, or null; q_seg (B,Tq) and
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
                            long long v_st, long long ab_st, int B, int H, int Tq,
                            int Tk, int Dh, float mask_value, void* dk, void* dv,
                            void* stream) {
  const Args a{q, k, v, ab, q_seg, kv_seg, dout, m, l, di,
               Strides{q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, ab_st, 0},
               B, H, Tq, Tk, mask_value, dk, dv, static_cast<cudaStream_t>(stream)};
  return run(true, dtype, a, Dh);
}

// K6c: dq (B,H,Tq,Dh) contiguous; dab (B,H,Tq,Tk) with rows dab_st elements
// apart (bf16: a multiple of 8, 16-byte aligned) and a contiguous last
// dimension, or null when the bias needs no gradient.
int flash_attention_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                           const void* ab, const int32_t* q_seg, const int32_t* kv_seg,
                           const void* dout, const float* m, const float* l,
                           const float* di, long long q_sb, long long q_sh,
                           long long q_st, long long k_sb, long long k_sh,
                           long long k_st, long long v_sb, long long v_sh,
                           long long v_st, long long ab_st, int B, int H, int Tq,
                           int Tk, int Dh, float mask_value, void* dq, void* dab,
                           long long dab_st, void* stream) {
  const Args a{q, k, v, ab, q_seg, kv_seg, dout, m, l, di,
               Strides{q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, ab_st, dab_st},
               B, H, Tq, Tk, mask_value, dq, dab, static_cast<cudaStream_t>(stream)};
  return run(false, dtype, a, Dh);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
