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
// fp32 K6b and K6c (f32::, below): SIMT FMAs, no TF32 and no tensor
// cores, fed by TMA as the fp32 forward (flash_attention.cu f32::) is. Their
// first design (blocks of 128 threads owning 32 keys or 16 rows, plain tile
// loads between two barriers, nothing skipped) took 149.63-151.34 us (K6b)
// and 112.30-112.76 us (K6c) at the 10 s shape, against 77.60-79.80 and
// 76.48-78.56 now (chip_smoke.py phase 2, an H100 80GB HBM3 at 700 W). Now each block has 288 threads: a producer warp and two groups of
// four consumer warps. The producer loads the block's fixed operands once
// and streams every other tile (fp32 rows in 128-byte boxes, 128-byte
// swizzled; the bias in 32-key boxes) through a ring of mbarrier-guarded
// stages; it alone decides which tiles are taken, so each stage carries its
// tile's index and an index of -1 ends the consumers' loop.
//   Tile skipping: under segment ids the producer leaves out the pairs of
//   `skippable_tiles` (ops/kernels/flash_attention.py) on the card, from m
//   and the segment ids of the pair's 64-row and 64-key tiles (a block whose
//   tiles are smaller takes the decision of the 64 x 64 tile that holds it):
//   no key of the key tile has a segment id in [min, max] of the row tile's
//   rows', and no row's m is at the mask level. Such a pair's p are exact
//   zeros, so its terms add exact zeros: leaving it out changes no bit.
//   Every sum keeps its order: each logit and dP is one FMA a term in the
//   order of d; each dK and dV element sums over the query rows in ascending
//   order, each dQ element over the keys in ascending order, one chain each.
//   The reduction axis is never split: a group owns its outputs outright.
//   K6b: a block owns BK keys (64, or 32 where 64-key blocks would fill at
//   most half of the SMs: flash_attention.py fp32_block_rows); their K and V
//   are loaded once, and the producer streams the Q and dO tiles of each
//   query tile taken (64 rows, 32 at Dh = 128), its ab tile and the rows' m,
//   1/l, di and segment ids. Group g owns keys g BK / 2 .. (g + 1) BK / 2 - 1:
//   two of its warps compute S^T (a thread 4 keys x 8 rows, 16-byte loads)
//   and p, which go to shared memory, then dV += p^T dO; its other two
//   compute dP^T, then dS = (dP - di) p from the shared p, then dK += dS^T Q
//   (a thread 4 keys x Dh / 8 columns of dV or dK in registers).
//   K6c: a block owns BM query rows (64, or 32 by the same rule) with their
//   Q and dO loaded once; the producer streams the K, V and ab tiles and the
//   key segment ids of each key tile taken (64 keys, 32 at Dh = 128), and
//   writes zeros to the skipped tiles' dab. Group g owns rows g BM / 2 ..
//   (g + 1) BM / 2 - 1: two warps compute S (a thread 8 keys x 4 rows) and
//   p, the other two dP and then dS in place of p; the four write dab from
//   there in 16-byte stores along the keys (rows padded as empty_bias makes
//   them) and add dS K to their rows' dQ in registers.
//   What holds them back (chip_smoke.py --k6b-parts fp32, --k6c-parts fp32,
//   on an H100 80GB HBM3 at 700 W): at the 10 s shape K6b takes 77.7 us, of
//   which leaving out S^T and dP^T saves 27.3, dV and dK 28.7, expf 7.5 and
//   the ab reads 5.1; K6c 78.4 us, of which S and dP save 27.6, dQ 20.4, the
//   dab stores 9.3, the ab reads 6.0 and expf 4.5. The products' time
//   follows the bytes they load from shared memory: a 4 x 8 register tile
//   loads 1.5 bytes a FMA (K6c's 4 x 4 dQ tile 2), against the SM's 128
//   bytes and 128 FMAs a cycle. An 8 x 8 tile (one byte a FMA) needs one
//   warp a product in this block, and was slower: a block of nine warps
//   gets 168 registers a thread, so K6c spilled, and a lone warp ran its
//   product at under half the issue rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

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
// fp32 K6b and K6c: register-blocked SIMT FMAs fed by TMA
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kGroups = 2;                      // consumer groups of four warps
constexpr int kGroupThreads = 128;
constexpr int kConsumers = kGroups * kGroupThreads;
constexpr int kThreads = kConsumers + 32;       // and one producer warp: TMA
constexpr int kSkipTile = 64;                   // the skip rule's row and key tiles
constexpr int kMaxSkipTiles = 512;              // key tiles past these are always taken
constexpr int kRuleBatch = 4;                   // rule tiles whose loads go out together
constexpr int kSmemBudget = 227 * 1024 - 2048;  // dynamic; the rest is the static arrays'

// fp32 rows of DH floats as TMA stores them: cut in boxes of kSwz bytes
// (part p of every row, then part p + 1), each box row swizzled
template <int DH>
struct Rows {
  static constexpr int kSwz = DH * 4 < 128 ? DH * 4 : 128;  // bytes of a swizzled row
  static constexpr int kCols = kSwz / 4;                    // its floats (a TMA box row)
  static constexpr int kParts = DH / kCols;                 // boxes of a row
};

// The term TMA's swizzle of `SWZ`-byte rows XORs into the 16-byte chunk
// index of row `row` (hopper::swizzled)
template <int SWZ>
__device__ __forceinline__ int swz_term(int row) {
  return SWZ == 128 ? (row & 7) : SWZ == 64 ? ((row >> 1) & 3) : ((row >> 2) & 1);
}

// ab[row][key] of an fp32 bias tile of ROWS rows, stored as TMA writes it:
// boxes of 32 keys (128-byte rows, 128-byte swizzled), one after another
template <int ROWS>
__device__ __forceinline__ float ab_at(const uint8_t* tile, int row, int key) {
  return *reinterpret_cast<const float*>(tile + (key / 32) * ROWS * 128 + row * 128 +
                                         ((((key % 32) / 4) ^ (row & 7)) << 4) +
                                         (key % 4) * 4);
}

// The thread's N columns of every row of a DH-wide tile of ROWS rows stored
// as TMA writes it: the 16-byte chunks cg + NG u (u < N / 4), or (N = 2)
// the columns 2 cg, 2 cg + 1. The byte offsets of rows 0..7 are computed once (the swizzle repeats every 8 rows): a row costs its
// loads alone where its index modulo 8 is known at compile time (`at`).
template <int DH, int ROWS, int N, int NG>
struct ColReader {
  static constexpr int SWZ = Rows<DH>::kSwz, kChunks = SWZ / 16;
  static constexpr int kPartStep = NG / kChunks * ROWS * SWZ;   // chunk u to u + 1
  static_assert(N <= 4 || NG % kChunks == 0, "a thread's chunks share their swizzle");
  const uint8_t* base;  // the tile and the part of the thread's first chunk
  int off[8];
  __device__ __forceinline__ ColReader(const uint8_t* tile, int cg) {
    const int c = N >= 4 ? cg : cg / 2;
    base = tile + c / kChunks * ROWS * SWZ + (N >= 4 ? 0 : (cg % 2) * 8);
#pragma unroll
    for (int rr = 0; rr < 8; ++rr) off[rr] = rr * SWZ + (((c % kChunks) ^ swz_term<SWZ>(rr)) << 4);
  }
  // row 8 r8 + RR
  template <int RR>
  __device__ __forceinline__ void at(int r8, float (&x)[N]) const {
    const uint8_t* p = base + r8 * 8 * SWZ + off[RR];
    if constexpr (N >= 4) {
#pragma unroll
      for (int u = 0; u < N / 4; ++u) {
        const float4 v = *reinterpret_cast<const float4*>(p + u * kPartStep);
        x[4 * u] = v.x;
        x[4 * u + 1] = v.y;
        x[4 * u + 2] = v.z;
        x[4 * u + 3] = v.w;
      }
    } else {
      const float2 v = *reinterpret_cast<const float2*>(p);
      x[0] = v.x;
      x[1] = v.y;
    }
  }
};

// Calls f(r, Int<r % 8>) for r = 0 .. n - 1 in order, 8 rows at a time
template <int RR>
struct Int {
  static constexpr int value = RR;
};
template <typename F>
__device__ __forceinline__ void rows_in_order(int n, F&& f) {
  int r8 = 0;
  for (; 8 * r8 + 8 <= n; ++r8) {
    f(r8, Int<0>()); f(r8, Int<1>()); f(r8, Int<2>()); f(r8, Int<3>());
    f(r8, Int<4>()); f(r8, Int<5>()); f(r8, Int<6>()); f(r8, Int<7>());
  }
  const int rest = n - 8 * r8;
  if (rest > 0) f(r8, Int<0>());
  if (rest > 1) f(r8, Int<1>());
  if (rest > 2) f(r8, Int<2>());
  if (rest > 3) f(r8, Int<3>());
  if (rest > 4) f(r8, Int<4>());
  if (rest > 5) f(r8, Int<5>());
  if (rest > 6) f(r8, Int<6>());
}

// The same columns of a row of a (B, H, T, DH) output, written
template <int DH, int N, int NG>
__device__ __forceinline__ void store_cols(float* row, int cg, const float (&x)[N]) {
  if constexpr (N >= 4) {
#pragma unroll
    for (int u = 0; u < N / 4; ++u)
      *reinterpret_cast<float4*>(row + 4 * (cg + NG * u)) =
          make_float4(x[4 * u], x[4 * u + 1], x[4 * u + 2], x[4 * u + 3]);
  } else {
    *reinterpret_cast<float2*>(row + 2 * cg) = make_float2(x[0], x[1]);
  }
}

struct Args {
  const int32_t* q_seg;
  const int32_t* kv_seg;
  const float* m;
  const float* l;
  const float* di;
  int H, Tq, Tk;
  float mask_value;
  bool has_ab;
  bool q_swap, k_swap, v_swap;  // th_swap of each map (dO is contiguous)
  float* out0;                  // dk (K6b) or dq (K6c)
  float* out1;                  // dv (K6b) or dab (K6c; null: no bias gradient)
  long long dab_st;             // dab's row stride (a multiple of 4)
};

// The rows' half of the skip rule (flash_attention.py skippable_tiles) for
// the kRuleBatch 64-row tiles from rt0 of (b, h), by one warp: each tile's
// [lo, hi] of the segment ids of its rows below Tq, and whether one of those
// rows has m at the mask level (all its keys masked: its p is not 0). Every
// load goes out before the reductions.
__device__ __forceinline__ void rule_rows(const Args& a, int b, size_t bh, int rt0, int lane,
                                          int (&lo)[kRuleBatch], int (&hi)[kRuleBatch],
                                          bool (&at_mask)[kRuleBatch]) {
  int sg[kRuleBatch][2];
  float mm[kRuleBatch][2];
#pragma unroll
  for (int x = 0; x < kRuleBatch; ++x)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int row = (rt0 + x) * kSkipTile + lane + 32 * u;
      const bool in = row < a.Tq;
      sg[x][u] = in ? a.q_seg[(size_t)b * a.Tq + row] : 0;
      mm[x][u] = in ? a.m[bh * a.Tq + row] : 0.f;   // 0: not at the mask level
    }
#pragma unroll
  for (int x = 0; x < kRuleBatch; ++x) {
    int l0 = INT_MAX, h0 = INT_MIN;
    bool am = false;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if ((rt0 + x) * kSkipTile + lane + 32 * u < a.Tq) {
        l0 = min(l0, sg[x][u]);
        h0 = max(h0, sg[x][u]);
      }
      am = am || !(mm[x][u] > 0.5f * a.mask_value);
    }
    lo[x] = __reduce_min_sync(0xffffffffu, l0);
    hi[x] = __reduce_max_sync(0xffffffffu, h0);
    at_mask[x] = __any_sync(0xffffffffu, am);
  }
}

// ---- K6b ---------------------------------------------------------------------

// acc[k][e] += w[r][k] x[r][e] over the rows r = 0 .. n - 1 in order, one
// FMA chain an element: w, the thread's VK weights of each row (p or dS,
// rows of PLD floats), x its VD columns of a DH-wide tile of ROWS rows (dO
// or Q) as TMA stored it
template <int DH, int ROWS, int VK, int VD, int PLD>
__device__ __forceinline__ void accumulate_rows(const float* w, const uint8_t* x, int dg,
                                                int n, float (&acc)[VK][VD]) {
  const ColReader<DH, ROWS, VD, 8> cols(x, dg);
  rows_in_order(n, [&](int r8, auto rr) {
    constexpr int RR = decltype(rr)::value;
    const int r = 8 * r8 + RR;
    float wv[VK], xv[VD];
    if constexpr (VK == 4) {
      const float4 t = *reinterpret_cast<const float4*>(w + r * PLD);
      wv[0] = t.x; wv[1] = t.y; wv[2] = t.z; wv[3] = t.w;
    } else {
      const float2 t = *reinterpret_cast<const float2*>(w + r * PLD);
      wv[0] = t.x; wv[1] = t.y;
    }
    cols.template at<RR>(r8, xv);
#pragma unroll
    for (int k = 0; k < VK; ++k)
#pragma unroll
      for (int e = 0; e < VD; ++e) acc[k][e] = fmaf(wv[k], xv[e], acc[k][e]);
  });
}

template <int DH, int BK>
struct DkvShape {
  static constexpr int BQ = DH <= 64 ? 64 : 32;        // query rows of a tile
  static constexpr int GK = BK / kGroups;              // keys of a group
  static constexpr int LK = GK >= 32 ? 8 : 4;          // S^T, dP^T: lanes along the keys
  static constexpr int LR = 32 / LK;                   //   and along the rows
  static constexpr int KT = GK / LK;                   //   keys of a thread
  static constexpr int RT = BQ / (2 * LR);             //   rows of a thread
  static constexpr int VK = GK / 8;                    // dV, dK: keys of a thread
  static constexpr int VD = DH / 8;                    //   and columns
  static constexpr int kPld = GK + GK / 4;             // a row of p or dS, padded
  static constexpr int kKvBytes = BK * DH * 4;         // K or V, loaded once
  static constexpr int kRowBytes = BQ * DH * 4;        // one Q or dO tile
  static constexpr int kAbParts = BK / 32;             // 32-key boxes of an ab tile
  static constexpr int kAbBytes = BQ * BK * 4;
  static constexpr int kValBytes = 1024;               // m, 1/l, di, segment ids of BQ rows
  static constexpr int kStageBytes = 2 * kRowBytes + kAbBytes + kValBytes;
  static constexpr int kPBytes = kGroups * 3 * BQ * kPld * 4;   // p (two buffers), dS
  static constexpr int kFixed = 1024 + 2 * kKvBytes + kPBytes + 8 * 9;
  static constexpr int kFit = (kSmemBudget - kFixed) / kStageBytes;
  static constexpr int kStages = kFit < 4 ? kFit : 4;  // ring of Q, dO, ab tiles
  static constexpr int kPOffset = 2 * kKvBytes + kStages * kStageBytes;
  static constexpr int kBarOffset = kPOffset + kPBytes;
  // 1024 bytes of slack align the tiles (the swizzle atom)
  static constexpr size_t kSmemBytes = 1024 + kBarOffset + 8 * (2 * kStages + 1);
  static_assert(kStages >= 2, "the ring needs two stages");
  static_assert(KT * LK == GK && 2 * LR * RT == BQ && 16 * BQ <= kValBytes, "shape");
};

// One block: BK keys of one (b, h), their K and V loaded once. The last warp
// streams the Q, dO and ab tiles of every query tile that the skip rule
// takes, with the rows' m, 1/l, di and segment ids, through a ring of
// kStages stages, each stage marked with its tile's index (-1 ends the
// loop). Group wg owns keys wg GK .. wg GK + GK - 1: warps 0, 1 of the group
// compute S^T and p, then dV += p^T dO; warps 2, 3 compute dP^T, then dS from
// p, then dK += dS^T Q. p goes through two buffers, so that one tile's p can
// be written while the other warps still read the last one's.
template <int DH, int BK>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dkv_f32_kernel(const __grid_constant__ CUtensorMap q_map,
                                   const __grid_constant__ CUtensorMap k_map,
                                   const __grid_constant__ CUtensorMap v_map,
                                   const __grid_constant__ CUtensorMap do_map,
                                   const __grid_constant__ CUtensorMap ab_map, const Args a) {
  using S = DkvShape<DH, BK>;
  using R = Rows<DH>;
  constexpr int BQ = S::BQ, GK = S::GK, LK = S::LK, LR = S::LR, KT = S::KT, RT = S::RT,
                VK = S::VK, VD = S::VD, PLD = S::kPld, NS = S::kStages, SWZ = R::kSwz,
                COLS = R::kCols;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int tile_s[NS];    // the query tile in each stage; -1: no more
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* k_s = smem;
  uint8_t* v_s = smem + S::kKvBytes;
  uint8_t* stages = smem + 2 * S::kKvBytes;
  float* p_all = reinterpret_cast<float*>(smem + S::kPOffset);  // [group][p, p, dS][BQ][PLD]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::kBarOffset);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;        // [NS]: the stage's tiles have landed
  uint64_t* empty = bars + 1 + NS;  // [NS]: the consumers are done with it

  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t bh = (size_t)b * a.H + h;
  const bool seg = a.q_seg != nullptr;

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
      for (int part = 0; part < R::kParts; ++part) {
        hopper::load_rows(k_s + part * BK * SWZ, &k_map, kv_full, part * COLS, k0, h, b,
                          a.k_swap);
        hopper::load_rows(v_s + part * BK * SWZ, &v_map, kv_full, part * COLS, k0, h, b,
                          a.v_swap);
      }
    }
    // the segment ids of the rule's 64-key tile that holds the block's keys,
    // two a lane
    const int kt = k0 / kSkipTile;
    const bool rule = seg && kt < kMaxSkipTiles;
    int ks[2];
    bool kin[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int key = kt * kSkipTile + lane + 32 * u;
      kin[u] = rule && key < a.Tk;
      ks[u] = kin[u] ? a.kv_seg[(size_t)b * a.Tk + key] : 0;
    }
    const int n_rule = (a.Tq + kSkipTile - 1) / kSkipTile;
    int n = 0;  // tiles issued
    for (int rt0 = 0; rt0 < n_rule; rt0 += kRuleBatch) {
      bool live[kRuleBatch];
      if (rule) {
        int lo[kRuleBatch], hi[kRuleBatch];
        bool at_mask[kRuleBatch];
        rule_rows(a, b, bh, rt0, lane, lo, hi, at_mask);
#pragma unroll
        for (int x = 0; x < kRuleBatch; ++x) {
          const bool inside = (kin[0] && ks[0] >= lo[x] && ks[0] <= hi[x]) ||
                              (kin[1] && ks[1] >= lo[x] && ks[1] <= hi[x]);
          const bool any = __any_sync(0xffffffffu, inside);
          live[x] = at_mask[x] || any;
        }
      } else {
#pragma unroll
        for (int x = 0; x < kRuleBatch; ++x) live[x] = true;
      }
#pragma unroll 1
      for (int x = 0; x < kRuleBatch && rt0 + x < n_rule; ++x) {
        if (!live[x]) continue;
        const int rt = rt0 + x;
        for (int t = rt * (kSkipTile / BQ); t < (rt + 1) * (kSkipTile / BQ) && t * BQ < a.Tq;
             ++t) {
          const int s = n % NS, i0 = t * BQ;
          if (n >= NS) hopper::mbar_wait(&empty[s], ((n / NS) - 1) & 1);
          ++n;
          uint8_t* st = stages + s * S::kStageBytes;
          float* vals = reinterpret_cast<float*>(st + 2 * S::kRowBytes + S::kAbBytes);
          for (int r = lane; r < BQ; r += 32)
            row_values(a.m, a.l, a.di, a.q_seg, bh, b, i0 + r, a.Tq, vals[r], vals[BQ + r],
                       vals[2 * BQ + r], reinterpret_cast<int*>(vals + 3 * BQ)[r]);
          __syncwarp();
          if (lane == 0) {
            tile_s[s] = t;
            hopper::mbar_arrive_expect_tx(&full[s],
                                          2 * S::kRowBytes + (a.has_ab ? S::kAbBytes : 0));
            for (int part = 0; part < R::kParts; ++part) {
              hopper::load_rows(st + part * BQ * SWZ, &q_map, &full[s], part * COLS, i0, h, b,
                                a.q_swap);
              hopper::load_rows(st + S::kRowBytes + part * BQ * SWZ, &do_map, &full[s],
                                part * COLS, i0, h, b, false);
            }
            if (a.has_ab)
              for (int part = 0; part < S::kAbParts; ++part)
                hopper::tma_load_4d(st + 2 * S::kRowBytes + part * BQ * 128, &ab_map, &full[s],
                                    k0 + 32 * part, i0, h, b);
          }
        }
      }
    }
    // the end of the tiles
    const int s = n % NS;
    if (n >= NS) hopper::mbar_wait(&empty[s], ((n / NS) - 1) & 1);
    if (lane == 0) {
      tile_s[s] = -1;
      hopper::mbar_arrive(&full[s]);
    }
    return;
  }

  // ---- consumer group wg: role 0 (warps 0, 1 of the group) computes S^T, p
  // and dV, role 1 (warps 2, 3) dP^T, dS and dK. On S^T and dP^T thread
  // (kq, rq) of warp wr holds keys kq + LK c (c < KT) of the group's and
  // rows g + 2 LR i (i < RT), g = LR wr + rq, of the tile: for each 16-byte
  // chunk of d, RT loads of Q (dO) and KT of K (V) feed 4 KT RT FMAs. The
  // rows of one load are consecutive and a thread's rows share one swizzle
  // term, so a warp's loads are conflict-free. On dV and dK thread (kg, dg)
  // holds keys VK kg .. VK kg + VK - 1 of the group's and the columns of the
  // 16-byte chunks dg + 8 u (Dh = 16: the columns 2 dg, 2 dg + 1).
  // group 1's roles are group 0's swapped, so that each of the SM's four
  // schedulers (warp % 4) holds one warp of each role
  const int wg = warp / 4, wr = warp % 2, role = (warp % 4 / 2) ^ wg;
  const int kq = lane % LK, g = LR * wr + lane / LK;
  const int kg = 4 * wr + lane / 8, dg = lane % 8;
  const int kgrp = wg * GK;                 // the group's first key in the block
  float* p_grp = p_all + wg * 3 * BQ * PLD;
  float* ds_s = p_grp + 2 * BQ * PLD;
  const int xq = swz_term<SWZ>(g);          // the swizzle term of the thread's rows
  int xk[KT], kseg[KT];                     // of its keys; their segment ids
  bool kok[KT];
#pragma unroll
  for (int c = 0; c < KT; ++c) {
    const int key = kgrp + kq + LK * c;
    xk[c] = swz_term<SWZ>(key);
    kok[c] = k0 + key < a.Tk;
    kseg[c] = (seg && kok[c]) ? a.kv_seg[(size_t)b * a.Tk + k0 + key] : 0;
  }
  float acc[VK][VD];
#pragma unroll
  for (int k = 0; k < VK; ++k)
#pragma unroll
    for (int e = 0; e < VD; ++e) acc[k][e] = 0.f;
  const uint8_t* kv_s = role == 0 ? k_s : v_s;

  // keys past Tk come zero-filled from TMA; their p is selected away below
  hopper::mbar_wait(kv_full, 0);
  for (int n = 0;; ++n) {
    const int s = n % NS;
    hopper::mbar_wait(&full[s], (n / NS) & 1);
    const int t = tile_s[s];
    if (t < 0) break;
    const uint8_t* q_t = stages + s * S::kStageBytes;
    const uint8_t* do_t = q_t + S::kRowBytes;
    const uint8_t* ab_t = q_t + 2 * S::kRowBytes;
    const float* vals = reinterpret_cast<const float*>(ab_t + S::kAbBytes);
    const int* qseg = reinterpret_cast<const int*>(vals + 3 * BQ);
    float* p_s = p_grp + (n & 1) * BQ * PLD;
    const int nrows = min(BQ, a.Tq - t * BQ);

    // ---- S^T = K Q^T (role 0) or dP^T = V dO^T (role 1), each sum one FMA
    // a term in the order of d (no TF32)
    float sc[KT][RT];
#pragma unroll
    for (int c = 0; c < KT; ++c)
#pragma unroll
      for (int i = 0; i < RT; ++i) sc[c][i] = 0.f;
    const uint8_t* rows_t = role == 0 ? q_t : do_t;
    // not unrolled whole: the offsets of every chunk held at once would take
    // the registers of the tiles
#pragma unroll 2
    for (int d4 = 0; d4 < DH / 4; ++d4) {
      constexpr int kChunks = SWZ / 16;
      const int part = d4 / kChunks, cc = d4 % kChunks;
      const uint8_t* r_at = rows_t + part * BQ * SWZ + g * SWZ + ((cc ^ xq) << 4);
      const uint8_t* k_at = kv_s + part * BK * SWZ + (kgrp + kq) * SWZ;
      float4 rv[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
        rv[i] = *reinterpret_cast<const float4*>(r_at + 2 * LR * i * SWZ);
#pragma unroll
      for (int c = 0; c < KT; ++c) {
        const float4 kv =
            *reinterpret_cast<const float4*>(k_at + LK * c * SWZ + ((cc ^ xk[c]) << 4));
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          sc[c][i] = fmaf(rv[i].x, kv.x, sc[c][i]);
          sc[c][i] = fmaf(rv[i].y, kv.y, sc[c][i]);
          sc[c][i] = fmaf(rv[i].z, kv.z, sc[c][i]);
          sc[c][i] = fmaf(rv[i].w, kv.w, sc[c][i]);
        }
      }
    }

    if (role == 0) {
      // ---- p = exp(s - m) / l; a row past Tq, or whose logits are all
      // -inf, has m = 0 and 1/l = 0 (its logits are 0 or below), so p = 0; a
      // key past Tk is selected away
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int r = g + 2 * LR * i;
        const float mi = vals[r], il = vals[BQ + r];
        const int qs = qseg[r];
#pragma unroll
        for (int c = 0; c < KT; ++c) {
          const int j = kq + LK * c;
          float x = sc[c][i];
          if (a.has_ab) x += ab_at<BQ>(ab_t, r, kgrp + j);
          if (seg) x += (qs == kseg[c]) ? 0.f : a.mask_value;
          p_s[r * PLD + j] = kok[c] ? expf(x - mi) * il : 0.f;
        }
      }
      hopper::named_sync(1 + wg, kGroupThreads);   // p written
      // ---- dV += p^T dO over the tile's rows in order
      accumulate_rows<DH, BQ, VK, VD, PLD>(p_s + VK * kg, do_t, dg, nrows, acc);
    } else {
      hopper::named_sync(1 + wg, kGroupThreads);   // p written
      // ---- dS = (dP - di) p
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int r = g + 2 * LR * i;
        const float dii = vals[2 * BQ + r];
#pragma unroll
        for (int c = 0; c < KT; ++c) {
          const int o = r * PLD + kq + LK * c;
          ds_s[o] = (sc[c][i] - dii) * p_s[o];
        }
      }
      hopper::named_sync(3 + wg, 64);   // dS written (the two warps of role 1)
      // ---- dK += dS^T Q over the tile's rows in order
      accumulate_rows<DH, BQ, VK, VD, PLD>(ds_s + VK * kg, q_t, dg, nrows, acc);
    }
    hopper::mbar_arrive(&empty[s]);
  }

  // ---- epilogue: dV (role 0) or dK (role 1) of the thread's keys
  float* out = role == 0 ? a.out1 : a.out0;
#pragma unroll
  for (int k = 0; k < VK; ++k) {
    const int key = k0 + kgrp + VK * kg + k;
    if (key < a.Tk) store_cols<DH, VD, 8>(out + (bh * a.Tk + key) * DH, dg, acc[k]);
  }
}

// ---- K6c ---------------------------------------------------------------------

template <int DH, int BM>
struct DqShape {
  static constexpr int BK = DH <= 64 ? 64 : 32;        // keys of a tile
  static constexpr int GR = BM / kGroups;              // rows of a group
  static constexpr int KT = BK / 8;                    // S, dP: keys of a thread
  static constexpr int RT = GR / 8;                    //   and rows
  static constexpr int kOuts = GR * DH / kGroupThreads;  // dQ: values of a thread,
  static constexpr int DPT = kOuts >= 16 ? kOuts / 4 : kOuts < 4 ? kOuts : 4;  // columns
  static constexpr int RPT = kOuts / DPT;              //   rows
  static constexpr int NDG = DH / DPT;                 //   column groups
  static constexpr int NRG = GR / RPT;                 //   row groups
  static constexpr int kRowBytes = BM * DH * 4;        // Q or dO, loaded once
  static constexpr int kKvBytes = BK * DH * 4;         // one K or V tile
  static constexpr int kAbParts = BK / 32;             // 32-key boxes of an ab tile
  static constexpr int kAbBytes = BM * BK * 4;
  static constexpr int kSegBytes = 1024;               // BK key segment ids
  static constexpr int kStageBytes = 2 * kKvBytes + kAbBytes + kSegBytes;
  static constexpr int kPld = BK + 8;                  // a row of p / dS, padded
  static constexpr int kPBytes = kGroups * 2 * GR * kPld * 4;   // p, then dS: two buffers
  static constexpr int kFixed = 1024 + 2 * kRowBytes + kPBytes + 8 * 9;
  static constexpr int kFit = (kSmemBudget - kFixed) / kStageBytes;
  static constexpr int kStages = kFit < 4 ? kFit : 4;  // ring of K, V, ab tiles
  static constexpr int kPOffset = 2 * kRowBytes + kStages * kStageBytes;
  static constexpr int kBarOffset = kPOffset + kPBytes;
  // 1024 bytes of slack align the tiles (the swizzle atom)
  static constexpr size_t kSmemBytes = 1024 + kBarOffset + 8 * (2 * kStages + 1);
  static_assert(kStages >= 2, "the ring needs two stages");
  static_assert(RT * 8 == GR && NDG * NRG == kGroupThreads && RPT * DPT == kOuts, "shape");
};

// One block: BM query rows of one (b, h), their Q and dO loaded once, with
// their m, 1/l, di and segment ids. The last warp streams the K, V and ab
// tiles and the key segment ids of every key tile that the skip rule takes
// through a ring of kStages stages, each marked with its tile's index (-1
// ends the loop), and writes zeros to the dab of the tiles it leaves out.
// Group wg owns rows wg GR .. wg GR + GR - 1: warps 0, 1 of the group compute
// S and p, warps 2, 3 dP and then dS in place of p; then all four write the
// tile's dab and add dS K to their rows' dQ. The p / dS tile has two
// buffers, so that one tile's p can be written while the last one's dS is
// still read.
template <int DH, int BM>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dq_f32_kernel(const __grid_constant__ CUtensorMap q_map,
                                  const __grid_constant__ CUtensorMap k_map,
                                  const __grid_constant__ CUtensorMap v_map,
                                  const __grid_constant__ CUtensorMap do_map,
                                  const __grid_constant__ CUtensorMap ab_map, const Args a) {
  using S = DqShape<DH, BM>;
  using R = Rows<DH>;
  constexpr int BK = S::BK, GR = S::GR, KT = S::KT, RT = S::RT, DPT = S::DPT, RPT = S::RPT,
                NDG = S::NDG, NRG = S::NRG, PLD = S::kPld, NS = S::kStages, SWZ = R::kSwz,
                COLS = R::kCols;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int tile_s[NS];    // the key tile in each stage; -1: no more
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = smem;
  uint8_t* do_s = smem + S::kRowBytes;
  uint8_t* stages = smem + 2 * S::kRowBytes;
  float* p_all = reinterpret_cast<float*>(smem + S::kPOffset);  // [group][2][GR][PLD]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::kBarOffset);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;        // [NS]: the stage's tiles have landed
  uint64_t* empty = bars + 1 + NS;  // [NS]: the consumers are done with it

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_tiles = (a.Tk + BK - 1) / BK;
  const size_t bh = (size_t)b * a.H + h;
  const bool seg = a.q_seg != nullptr;

  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
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
      hopper::prefetch_map(&k_map);
      hopper::prefetch_map(&v_map);
      hopper::mbar_arrive_expect_tx(q_full, 2 * S::kRowBytes);
      for (int part = 0; part < R::kParts; ++part) {
        hopper::load_rows(q_s + part * BM * SWZ, &q_map, q_full, part * COLS, q0, h, b,
                          a.q_swap);
        hopper::load_rows(do_s + part * BM * SWZ, &do_map, q_full, part * COLS, q0, h, b,
                          false);
      }
    }
    // the rows' half of the rule: the 64-row tile that holds the block's rows
    int lo[kRuleBatch], hi[kRuleBatch];
    bool at_mask[kRuleBatch];
    if (seg) rule_rows(a, b, bh, q0 / kSkipTile, lane, lo, hi, at_mask);
    int n = 0;  // tiles issued
    for (int t0 = 0; t0 < n_tiles; t0 += kRuleBatch) {
      bool live[kRuleBatch];
      if (seg && !at_mask[0]) {
        // the segment ids of each tile's 64-key rule tile, two a lane
        int ks[kRuleBatch][2];
#pragma unroll
        for (int x = 0; x < kRuleBatch; ++x)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int key = (t0 + x) * BK / kSkipTile * kSkipTile + lane + 32 * u;
            ks[x][u] = key < a.Tk ? a.kv_seg[(size_t)b * a.Tk + key] : 0;
          }
#pragma unroll
        for (int x = 0; x < kRuleBatch; ++x) {
          const int kbase = (t0 + x) * BK / kSkipTile * kSkipTile;
          bool inside = false;
#pragma unroll
          for (int u = 0; u < 2; ++u)
            inside = inside || (kbase + lane + 32 * u < a.Tk && ks[x][u] >= lo[0] &&
                                ks[x][u] <= hi[0]);
          const bool any = __any_sync(0xffffffffu, inside);
          live[x] = any || kbase / kSkipTile >= kMaxSkipTiles;
        }
      } else {
#pragma unroll
        for (int x = 0; x < kRuleBatch; ++x) live[x] = true;
      }
#pragma unroll 1
      for (int x = 0; x < kRuleBatch && t0 + x < n_tiles; ++x) {
        const int t = t0 + x, k0 = t * BK;
        if (!live[x]) {
          // a skipped tile's dS is exactly 0: its dab, zeros in 16-byte stores
          if (a.out1 != nullptr)
            for (int e = lane; e < BM * BK / 4; e += 32) {
              const int i = q0 + e / (BK / 4), col = k0 + 4 * (e % (BK / 4));
              if (i < a.Tq && col < a.Tk)
                *reinterpret_cast<float4*>(a.out1 + (bh * a.Tq + i) * a.dab_st + col) =
                    make_float4(0.f, 0.f, 0.f, 0.f);
            }
          continue;
        }
        const int s = n % NS;
        if (n >= NS) hopper::mbar_wait(&empty[s], ((n / NS) - 1) & 1);
        ++n;
        uint8_t* st = stages + s * S::kStageBytes;
        if (seg) {
          int32_t* kseg = reinterpret_cast<int32_t*>(st + 2 * S::kKvBytes + S::kAbBytes);
          for (int j = lane; j < BK; j += 32)
            kseg[j] = k0 + j < a.Tk ? a.kv_seg[(size_t)b * a.Tk + k0 + j] : 0;
          __syncwarp();
        }
        if (lane == 0) {
          tile_s[s] = t;
          hopper::mbar_arrive_expect_tx(&full[s],
                                        2 * S::kKvBytes + (a.has_ab ? S::kAbBytes : 0));
          for (int part = 0; part < R::kParts; ++part) {
            hopper::load_rows(st + part * BK * SWZ, &k_map, &full[s], part * COLS, k0, h, b,
                              a.k_swap);
            hopper::load_rows(st + S::kKvBytes + part * BK * SWZ, &v_map, &full[s],
                              part * COLS, k0, h, b, a.v_swap);
          }
          if (a.has_ab)
            for (int part = 0; part < S::kAbParts; ++part)
              hopper::tma_load_4d(st + 2 * S::kKvBytes + part * BM * 128, &ab_map, &full[s],
                                  k0 + 32 * part, q0, h, b);
        }
      }
    }
    // the end of the tiles
    const int s = n % NS;
    if (n >= NS) hopper::mbar_wait(&empty[s], ((n / NS) - 1) & 1);
    if (lane == 0) {
      tile_s[s] = -1;
      hopper::mbar_arrive(&full[s]);
    }
    return;
  }

  // ---- consumer group wg: role 0 (warps 0, 1 of the group) computes S and
  // p, role 1 (warps 2, 3) dP and dS. On S and dP thread (kq, rq) of warp wr
  // holds keys kq + 8 c (c < KT) of the tile and rows g + 8 i (i < RT), g =
  // 4 wr + rq, of the group's: for each 16-byte chunk of d, RT loads of Q
  // (dO) and KT of K (V) feed 4 KT RT FMAs, conflict-free under the swizzle
  // (a thread's rows share a swizzle term, and so do its keys). On dQ thread
  // (rg, cg) of the group holds rows rg + NRG i (i < RPT) of the group's
  // and the columns of the 16-byte chunks cg + NDG u (DPT = 2: the columns
  // 2 cg, 2 cg + 1).
  // group 1's roles are group 0's swapped, so that each of the SM's four
  // schedulers (warp % 4) holds one warp of each role
  const int wg = warp / 4, wr = warp % 2, role = (warp % 4 / 2) ^ wg, gt = tid % kGroupThreads;
  const int kq = lane % 8, g = 4 * wr + lane / 8;
  const int cg = gt % NDG, rg = gt / NDG;
  const int rgrp = wg * GR;                  // the group's first row in the block
  const int xq = swz_term<SWZ>(rgrp + g), xk = swz_term<SWZ>(kq);
  float* ps_grp = p_all + wg * 2 * GR * PLD;
  // the thread's rows of S and dP: m, 1/l, di and segment ids (a row past
  // Tq, or whose logits are all -inf, has m = 0 and 1/l = 0, so p = 0)
  float mi[RT], il[RT], dii[RT];
  int qsg[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
    row_values(a.m, a.l, a.di, a.q_seg, bh, b, q0 + rgrp + g + 8 * i, a.Tq, mi[i], il[i],
               dii[i], qsg[i]);
  float acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;
  const uint8_t* rows_s = role == 0 ? q_s : do_s;

  hopper::mbar_wait(q_full, 0);
  for (int n = 0;; ++n) {
    const int s = n % NS;
    hopper::mbar_wait(&full[s], (n / NS) & 1);
    const int t = tile_s[s];
    if (t < 0) break;
    const int k0 = t * BK;
    const uint8_t* k_t = stages + s * S::kStageBytes;
    const uint8_t* v_t = k_t + S::kKvBytes;
    const uint8_t* ab_t = k_t + 2 * S::kKvBytes;
    const int* kseg = reinterpret_cast<const int*>(ab_t + S::kAbBytes);
    float* ps = ps_grp + (n & 1) * GR * PLD;

    // ---- S = Q K^T (role 0) or dP = dO V^T (role 1), each sum one FMA a
    // term in the order of d (no TF32)
    float sc[RT][KT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int c = 0; c < KT; ++c) sc[i][c] = 0.f;
    const uint8_t* kv_t = role == 0 ? k_t : v_t;
    // not unrolled whole: the offsets of every chunk held at once would take
    // the registers of the tiles
#pragma unroll 2
    for (int d4 = 0; d4 < DH / 4; ++d4) {
      constexpr int kChunks = SWZ / 16;
      const int part = d4 / kChunks, cc = d4 % kChunks;
      const uint8_t* r_at = rows_s + part * BM * SWZ + (rgrp + g) * SWZ + ((cc ^ xq) << 4);
      const uint8_t* k_at = kv_t + part * BK * SWZ + kq * SWZ + ((cc ^ xk) << 4);
      float4 rv[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) rv[i] = *reinterpret_cast<const float4*>(r_at + 8 * i * SWZ);
#pragma unroll
      for (int c = 0; c < KT; ++c) {
        const float4 kv = *reinterpret_cast<const float4*>(k_at + 8 * c * SWZ);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          sc[i][c] = fmaf(rv[i].x, kv.x, sc[i][c]);
          sc[i][c] = fmaf(rv[i].y, kv.y, sc[i][c]);
          sc[i][c] = fmaf(rv[i].z, kv.z, sc[i][c]);
          sc[i][c] = fmaf(rv[i].w, kv.w, sc[i][c]);
        }
      }
    }

    if (role == 0) {
      // ---- p = exp(s - m) / l; a key past Tk is selected away
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int r = g + 8 * i;
#pragma unroll
        for (int c = 0; c < KT; ++c) {
          const int j = kq + 8 * c;
          float x = sc[i][c];
          if (a.has_ab) x += ab_at<BM>(ab_t, rgrp + r, j);
          if (seg) x += (qsg[i] == kseg[j]) ? 0.f : a.mask_value;
          const float ex = expf(x - mi[i]);
          ps[r * PLD + j] = k0 + j < a.Tk ? ex * il[i] : 0.f;
        }
      }
      hopper::named_sync(1 + wg, kGroupThreads);   // p written
      hopper::named_sync(3 + wg, kGroupThreads);   // dS written
    } else {
      hopper::named_sync(1 + wg, kGroupThreads);   // p written
      // ---- dS = (dP - di) p, in place of p
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int c = 0; c < KT; ++c) {
          const int o = (g + 8 * i) * PLD + kq + 8 * c;
          ps[o] = (sc[i][c] - dii[i]) * ps[o];
        }
      hopper::named_sync(3 + wg, kGroupThreads);   // dS written
    }

    // ---- dab: the group's rows of the tile, 16-byte stores along the keys
    // (a row's last store may reach into its padding, past Tk)
    if (a.out1 != nullptr) {
      for (int e = gt; e < GR * BK / 4; e += kGroupThreads) {
        const int r = e / (BK / 4), ch = e % (BK / 4);
        const int i = q0 + rgrp + r, col = k0 + 4 * ch;
        if (i < a.Tq && col < a.Tk)
          *reinterpret_cast<float4*>(a.out1 + (bh * a.Tq + i) * a.dab_st + col) =
              *reinterpret_cast<const float4*>(ps + r * PLD + 4 * ch);
      }
    }
    // ---- dQ += dS K, each key in order (past Tk: dS = 0, k = 0)
    {
      const ColReader<DH, BK, DPT, NDG> cols(k_t, cg);
      float4 sv[RPT];
      rows_in_order(4 * ((min(BK, a.Tk - k0) + 3) / 4), [&](int r8, auto jr) {
        constexpr int JR = decltype(jr)::value;
        if constexpr (JR % 4 == 0) {
#pragma unroll
          for (int i = 0; i < RPT; ++i)
            sv[i] = *reinterpret_cast<const float4*>(ps + (rg + NRG * i) * PLD + 8 * r8 + JR);
        }
        float kv[DPT];
        cols.template at<JR>(r8, kv);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          constexpr int jj = JR % 4;
          const float sj = jj == 0 ? sv[i].x : jj == 1 ? sv[i].y : jj == 2 ? sv[i].z : sv[i].w;
#pragma unroll
          for (int e = 0; e < DPT; ++e) acc[i][e] = fmaf(sj, kv[e], acc[i][e]);
        }
      });
    }
    hopper::mbar_arrive(&empty[s]);
  }

  // ---- epilogue: dQ of the thread's rows
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + rgrp + rg + NRG * i;
    if (row < a.Tq) store_cols<DH, DPT, NDG>(a.out0 + (bh * a.Tq + row) * DH, cg, acc[i]);
  }
}

}  // namespace f32


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
  int block;           // fp32: keys (K6b) or query rows (K6c) of a block, 64 or 32
  void *out0, *out1;   // dk, dv (K6b) or dq, dab (K6c)
  cudaStream_t stream;
};

// fp32 K6b (DKV) or K6c with BLOCK keys (K6b) or query rows (K6c) a block
template <bool DKV, int DH, int BLOCK>
cudaError_t launch_f32(const Args& a) {
  using R = f32::Rows<DH>;
  using SB = f32::DkvShape<DH, BLOCK>;
  using SC = f32::DqShape<DH, BLOCK>;
  constexpr CUtensorMapDataType kF32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  // rows of a Q or dO box, of a K or V box, of an ab box
  constexpr int kQRows = DKV ? SB::BQ : BLOCK, kKRows = DKV ? BLOCK : SC::BK;
  constexpr size_t kSmem = DKV ? SB::kSmemBytes : SC::kSmemBytes;
  const Strides& st = a.st;
  f32::Args d{a.q_seg, a.kv_seg, a.m, a.l, a.di, a.H, a.Tq, a.Tk, a.mask_value,
              a.ab != nullptr, false, false, false, static_cast<float*>(a.out0),
              static_cast<float*>(a.out1), st.dabt};
  // dab is written 16 bytes a store
  if (!DKV && a.out1 != nullptr &&
      (st.dabt % 4 || st.dabt < a.Tk || reinterpret_cast<uintptr_t>(a.out1) % 16))
    return cudaErrorInvalidValue;
  const long long do_sh = (long long)a.Tq * DH;
  CUtensorMap qm, km, vm, dom, abm;
  bool do_swap = false;
  cudaError_t err = hopper::map_rows(&qm, a.q, st.qb, st.qh, st.qt, a.B, a.H, a.Tq, DH,
                                     R::kCols, kQRows, R::kSwz, &d.q_swap, kF32);
  if (err == cudaSuccess)
    err = hopper::map_rows(&km, a.k, st.kb, st.kh, st.kt, a.B, a.H, a.Tk, DH, R::kCols,
                           kKRows, R::kSwz, &d.k_swap, kF32);
  if (err == cudaSuccess)
    err = hopper::map_rows(&vm, a.v, st.vb, st.vh, st.vt, a.B, a.H, a.Tk, DH, R::kCols,
                           kKRows, R::kSwz, &d.v_swap, kF32);
  if (err == cudaSuccess)
    err = hopper::map_rows(&dom, a.dout, a.H * do_sh, do_sh, DH, a.B, a.H, a.Tq, DH,
                           R::kCols, kQRows, R::kSwz, &do_swap, kF32);
  if (err == cudaSuccess && do_swap) err = cudaErrorInvalidValue;
  if (err == cudaSuccess) {
    if (a.ab != nullptr)
      err = hopper::map_bias(&abm, a.ab, st.abt, a.B, a.H, a.Tq, a.Tk, kQRows, kF32);
    else
      abm = qm;  // not read
  }
  if (err != cudaSuccess) return err;
  auto kernel = DKV ? f32::flash_attention_bwd_dkv_f32_kernel<DH, BLOCK>
                    : f32::flash_attention_bwd_dq_f32_kernel<DH, BLOCK>;
  // once: the ring's shared memory
  static const cudaError_t allowed = hopper::allow_smem(kernel, kSmem);
  if (allowed != cudaSuccess) return allowed;
  const dim3 grid(((DKV ? a.Tk : a.Tq) + BLOCK - 1) / BLOCK, a.H, a.B);
  kernel<<<grid, f32::kThreads, kSmem, a.stream>>>(qm, km, vm, dom, abm, d);
  return cudaGetLastError();
}

// fp32 K6b or K6c by head dim and block height (64 or 32)
cudaError_t dispatch_f32(bool dkv, int Dh, const Args& a) {
  if (a.block != 32 && a.block != 64) return cudaErrorInvalidValue;
  const bool wide = a.block == 64;
#define FA_BWD_F32(DH)                                                            \
  return dkv ? (wide ? launch_f32<true, DH, 64>(a) : launch_f32<true, DH, 32>(a)) \
             : (wide ? launch_f32<false, DH, 64>(a) : launch_f32<false, DH, 32>(a))
  switch (Dh) {
    case 16: FA_BWD_F32(16);
    case 32: FA_BWD_F32(32);
    case 64: FA_BWD_F32(64);
    case 128: FA_BWD_F32(128);
    default: return cudaErrorInvalidValue;
  }
#undef FA_BWD_F32
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

// K6b or K6c: fp32 SIMT (dtype 0) or bf16 tensor cores (dtype 1)
cudaError_t dispatch(bool dkv, int dtype, int Dh, const Args& a) {
  if (dtype == 0) return dispatch_f32(dkv, Dh, a);
  switch (Dh) {
    case 16: return dkv ? launch_dkv_tc<16>(a) : launch_dq_tc<16>(a);
    case 32: return dkv ? launch_dkv_tc<32>(a) : launch_dq_tc<32>(a);
    case 64: return dkv ? launch_dkv_tc<64>(a) : launch_dq_tc<64>(a);
    case 128: return dkv ? launch_dkv_tc<128>(a) : launch_dq_tc<128>(a);
    default: return cudaErrorInvalidValue;
  }
}

int run(bool dkv, int dtype, const Args& a, int Dh) {
  if ((a.q_seg == nullptr) != (a.kv_seg == nullptr) || a.Tq < 1 || a.Tk < 1 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch(dkv, dtype, Dh, a);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, ab, dout and the gradients). q
// (B,H,Tq,Dh), k and v (B,H,Tk,Dh) with the given element strides of their
// first three dimensions (bf16: multiples of 8, 16-byte aligned bases); ab
// (B,H,Tq,Tk) with rows ab_st elements apart (bf16: a multiple of 8) and a
// contiguous last dimension, or null; q_seg (B,Tq) and
// kv_seg (B,Tk) int32, both or neither; dout (B,H,Tq,Dh) contiguous; m, l
// and di (B,H,Tq) fp32 contiguous; `block` (fp32 only, else ignored): the
// keys (K6b) or query rows (K6c) of a block, 64 or 32
// (flash_attention.py fp32_block_rows). Launch on `stream` and return
// cudaGetLastError() as an int (0 = launched).

// K6b: dk and dv (B,H,Tk,Dh) contiguous.
int flash_attention_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                            const void* ab, const int32_t* q_seg, const int32_t* kv_seg,
                            const void* dout, const float* m, const float* l,
                            const float* di, long long q_sb, long long q_sh,
                            long long q_st, long long k_sb, long long k_sh,
                            long long k_st, long long v_sb, long long v_sh,
                            long long v_st, long long ab_st, int B, int H, int Tq,
                            int Tk, int Dh, float mask_value, int block, void* dk,
                            void* dv, void* stream) {
  const Args a{q, k, v, ab, q_seg, kv_seg, dout, m, l, di,
               Strides{q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, ab_st, 0},
               B, H, Tq, Tk, mask_value, block, dk, dv, static_cast<cudaStream_t>(stream)};
  return run(true, dtype, a, Dh);
}

// K6c: dq (B,H,Tq,Dh) contiguous; dab (B,H,Tq,Tk) with rows dab_st elements
// apart (a multiple of 16 bytes, 16-byte aligned: a row's last store may
// reach past Tk into its padding, empty_bias's rows) and a contiguous last
// dimension, or null when the bias needs no gradient.
int flash_attention_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                           const void* ab, const int32_t* q_seg, const int32_t* kv_seg,
                           const void* dout, const float* m, const float* l,
                           const float* di, long long q_sb, long long q_sh,
                           long long q_st, long long k_sb, long long k_sh,
                           long long k_st, long long v_sb, long long v_sh,
                           long long v_st, long long ab_st, int B, int H, int Tq,
                           int Tk, int Dh, float mask_value, int block, void* dq,
                           void* dab, long long dab_st, void* stream) {
  const Args a{q, k, v, ab, q_seg, kv_seg, dout, m, l, di,
               Strides{q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, ab_st, dab_st},
               B, H, Tq, Tk, mask_value, block, dq, dab, static_cast<cudaStream_t>(stream)};
  return run(false, dtype, a, Dh);
}

// fp32 K6b (dkv = 1, block = its keys) or K6c (dkv = 0, block = its query
// rows) at head dim Dh: its dynamic shared memory and ring stages, for the
// plan's check (flash_attention.py fp32_bwd_shape). Returns 0, or -1 for a
// shape there is no kernel for.
int flash_attention_bwd_f32_shape(int dkv, int Dh, int block, int* smem_bytes, int* stages) {
#define FA_BWD_SHAPE(DH, BLOCK)                                                            \
  if (Dh == DH && block == BLOCK) {                                                        \
    *smem_bytes = dkv ? (int)f32::DkvShape<DH, BLOCK>::kSmemBytes                          \
                      : (int)f32::DqShape<DH, BLOCK>::kSmemBytes;                          \
    *stages = dkv ? f32::DkvShape<DH, BLOCK>::kStages : f32::DqShape<DH, BLOCK>::kStages; \
    return 0;                                                                              \
  }
  FA_BWD_SHAPE(16, 32) FA_BWD_SHAPE(16, 64) FA_BWD_SHAPE(32, 32) FA_BWD_SHAPE(32, 64)
  FA_BWD_SHAPE(64, 32) FA_BWD_SHAPE(64, 64) FA_BWD_SHAPE(128, 32) FA_BWD_SHAPE(128, 64)
#undef FA_BWD_SHAPE
  return -1;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
