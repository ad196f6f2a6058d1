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
// tensor cores, against 24 MB (7.2 us) of bytes: bound by operations. In
// bf16 the same shape moves about 12 MB (3.8 us) against 1 us of tensor-core
// operations: bound by bytes, most of them ab's.
//
// One kernel per dtype, chosen by `dtype` in the C entry, for head dims 16,
// 32, 64, 80 and 128. Dh = 80 is the XLSR2-1B encoder's (1280 over 16
// heads; models/unit_extractor/wav2vec2_raw.py). A row of 80 elements is not
// a whole number of 128-byte boxes, so its tiles are cut in the largest box
// that divides a row (hopper::row_box_bytes): five 64-byte boxes of 16
// floats, 64-byte swizzled, in fp32; five 32-byte boxes of 16 bf16, 32-byte
// swizzled, in bf16. In bf16 each k16 step of S = Q K^T then reads one box
// (K-major, SBO = 8 rows of 32 bytes), and O += P V is m64n80k16 with V read
// MN-major across the five boxes (LBO = one box's rows apart); in fp32 a
// thread holds O's columns as five 8-byte pairs, since 10 columns a thread
// are not whole 16-byte chunks. The backward (K6b, K6c) takes Dh = 80 not.
//
// bf16 (flash_attention_tc_kernel, below): the products on the tensor cores
// (wgmma, bf16 operands, fp32 accumulators), the tiles fed by TMA. One block
// per (b, h, 64 query rows): a producer warp loads Q once and streams K, V,
// the ab tile (64 rows x 64 keys) and the key segment ids through a ring of
// shared-memory stages (4 for Dh <= 64, 3 for 128) guarded by mbarriers; two
// warpgroups take every other key tile, each with its own online softmax,
// and merge their m, l and O at the end. S = Q K^T by m64n64k16 from shared
// memory; the bias, mask and online softmax in the accumulator's registers
// (a row's four threads reduce by two shuffles; exp as the hardware's exp2
// of d * log2 e); p rounded to bf16 in registers is the A operand of
// O += P V (m64nDhk16, V read MN-major), so p never touches shared memory.
// The ab tile lands 128-byte swizzled, so a warp's reads of it are
// conflict-free; the bias and the segment ids are template arguments, so
// the softmax holds no branch. Ragged tails of Tq and Tk come back zero from
// TMA and are masked by index. The bias's rows must be 16-byte aligned (the
// caller pads them to 8 elements, ops/fused_attention.py). What holds it
// back now: one block of 64 rows on each SM at the 10 s shape, so its key
// tiles run one after another; each tile's softmax (about 1000 cycles) waits
// on its S product and the next S waits on the softmax.
//
// fp32 (f32::flash_attention_f32_kernel): SIMT FMAs, no TF32, so the results
// stay those of the plain fp32 product; each logit is summed over d in order
// and each output over the keys of a tile in order. Its first design (one
// block of 128 threads a tile of 16 query rows, plain tile loads between two
// barriers, a lane's register tile of 4 rows x 2 keys) took 87.23-93.05 us at
// the 10 s shape on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 2): every
// FMA waited on a shared load of its own, and each of the 512 blocks read the
// head's whole K and V. Now the bf16 kernel's skeleton carries fp32 tiles:
// one block per (b, h, 64 query rows) (32 where 64-row blocks would leave
// most of the card idle, flash_attention.py fp32_block_rows); a producer warp
// loads Q once and streams K, V, the ab tile and the key segment ids by TMA
// (rows in 128-byte boxes, 128-byte swizzled; 64-byte ones at Dh = 80)
// through a ring of 3-4 stages
// guarded by mbarriers; two groups of four warps take alternate key tiles,
// each with its own online softmax, and merge at the end. A thread holds a
// register tile of 4 rows x 8 keys of S and the same 4 rows x Dh/8 columns
// of O, so one 16-byte load of Q or K feeds 16 or 32 FMAs; the swizzle makes
// a warp's loads conflict-free; p goes from the scores to the value product
// through a padded tile in shared memory that one warp writes and reads.
// Under segment ids (and no ab) the key tiles of `skippable_tiles_fwd` are
// not loaded: their keys are masked for every row of the block, and every
// row has an unmasked key elsewhere, so their p are exactly 0 (or their terms
// are scaled by exp(mask - m) = 0) and out, m and l do not change by a bit.
// At the 10 s shape it takes about 41 us against the 15.6 us bound (an H100
// 80GB HBM3 at 700 W, chip_smoke.py --k6-parts): each product about 14 us,
// 58 % of the fp32 FMA rate (the shared loads and the swizzle's address
// arithmetic beside the FMAs), the exps about 5 us, the rest the softmax,
// the merge and the fixed cost of a launch. 3xTF32 wgmma would take the
// products off the FMA pipe.

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

#include "hopper.cuh"

// Strides are in elements; the last dimension of q, k and v is contiguous.
// The bias's rows are `abt` apart (its last dimension contiguous).
struct Strides {
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt, abt;
};

// ---------------------------------------------------------------------------
// fp32: register-blocked SIMT FMAs fed by TMA
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kGroups = 2;                      // consumer groups: alternate key tiles
constexpr int kGroupThreads = 128;
constexpr int kConsumers = kGroups * kGroupThreads;
constexpr int kThreads = kConsumers + 32;       // and one producer warp: TMA
constexpr int kSkipTile = 64;                   // the skip rule's row and key tiles
constexpr int kMaxSkipTiles = 512;              // key tiles past these are always taken
constexpr int kSmemBudget = 227 * 1024 - 2048;  // dynamic; the rest is the static arrays'

template <int DH, int BM>
struct Shape {
  static constexpr int BK = DH <= 64 ? 64 : 32;             // keys of a tile
  static constexpr int TR = BM / 16;                        // query rows of a thread
  static constexpr int KPT = BK / 8;                        // keys of a thread
  static constexpr int CPT = DH / 8;                        // output columns of a thread
  static constexpr int kSwz = hopper::row_box_bytes(DH * 4);  // bytes of a swizzled box row
  static constexpr int kCols = kSwz / 4;                    // its floats (a TMA box row)
  static constexpr int kParts = DH / kCols;                 // boxes of a Q, K or V row
  static constexpr int kAbParts = BK / 32;                  // 32-key boxes of an ab tile
  static constexpr int kPld = BK + 8;                       // a row of p, padded
  static constexpr int kQBytes = BM * DH * 4;
  static constexpr int kKvBytes = BK * DH * 4;              // one K or V tile
  static constexpr int kAbBytes = BM * BK * 4;              // one ab tile
  static constexpr int kSegBytes = 1024;                    // BK key segment ids
  static constexpr int kStageBytes = 2 * kKvBytes + kAbBytes + kSegBytes;
  static constexpr int kPBytes = kGroups * BM * kPld * 4;
  static constexpr int kFixed = 1024 + kQBytes + kPBytes + 8 * 9;
  static constexpr int kFit = (kSmemBudget - kFixed) / kStageBytes;
  static constexpr int kStages = kFit < 4 ? kFit : 4;       // ring of K, V, ab tiles
  static constexpr int kPOffset = kQBytes + kStages * kStageBytes;
  static constexpr int kBarOffset = kPOffset + kPBytes;
  // 1024 bytes of slack align the tiles (the swizzle atom)
  static constexpr size_t kSmemBytes = 1024 + kBarOffset + 8 * (2 * kStages + 1);
  static_assert(kStages >= 2, "the ring needs two stages");
};

// The term TMA's swizzle of `SWZ`-byte rows XORs into the 16-byte chunk
// index of row `row` (hopper::swizzled)
template <int SWZ>
__device__ __forceinline__ int swz_term(int row) {
  return SWZ == 128 ? (row & 7) : SWZ == 64 ? ((row >> 1) & 3) : ((row >> 2) & 1);
}

// Byte offset of 16-byte chunk `chunk` of row `row` in an fp32 tile of ROWS
// rows stored as TMA writes it: each row cut in boxes of SWZ bytes (part p of
// every row, then part p + 1), each box row swizzled
template <int SWZ, int ROWS>
__device__ __forceinline__ int chunk_at(int row, int chunk) {
  constexpr int kChunks = SWZ / 16;
  return (chunk / kChunks) * ROWS * SWZ + row * SWZ +
         (((chunk % kChunks) ^ swz_term<SWZ>(row)) << 4);
}

struct Args {
  const int32_t* q_seg;
  const int32_t* kv_seg;
  int H, Tq, Tk;
  float mask_value;
  bool has_ab;
  bool q_swap, k_swap, v_swap;  // th_swap of each map
  float* out;
  float* m_out;
  float* l_out;
};

// The forward's skip rule (flash_attention.py skippable_tiles_fwd) for the
// 64-row tile of this block's rows (rseg_s: its rows' segment ids), computed
// by the consumer threads: skip_s[u] stays 1 for a 64-key tile u whose keys
// below Tk all have segment ids outside [min, max] of the row tile's rows
// below Tq; unmatched_s becomes 1 if some row below Tq has no key below Tk of
// its own segment (its softmax averages every key, so every tile is taken).
__device__ void skip_rule(const Args& a, int b, int r_base, int n_skip, const int* rseg_s,
                          uint8_t* skip_s, uint32_t* found_s, int* unmatched_s) {
  const int tid = threadIdx.x, lane = tid % 32;
  const int nv = min(kSkipTile, a.Tq - r_base);
  int rmin = rseg_s[0], rmax = rseg_s[0];
  for (int r = 1; r < nv; ++r) {
    rmin = min(rmin, rseg_s[r]);
    rmax = max(rmax, rseg_s[r]);
  }
  const int32_t* ks = a.kv_seg + (size_t)b * a.Tk;
  const int lim = min(a.Tk, n_skip * kSkipTile);
  for (int j = tid; j < lim; j += kConsumers) {
    const int sj = ks[j];
    if (sj >= rmin && sj <= rmax) skip_s[j / kSkipTile] = 0;
  }
  // rows that have a key of their segment, kConsumers keys at a time until
  // every row has one or the keys run out
  const uint64_t all = nv == 64 ? ~0ull : (1ull << nv) - 1;
  for (int c0 = 0;; c0 += kConsumers) {
    uint64_t mask = 0;
    if (c0 + tid < a.Tk) {
      const int sj = ks[c0 + tid];
      for (int r = 0; r < nv; ++r) mask |= (uint64_t)(rseg_s[r] == sj) << r;
    }
    const uint32_t lo = __reduce_or_sync(0xffffffffu, (uint32_t)mask);
    const uint32_t hi = __reduce_or_sync(0xffffffffu, (uint32_t)(mask >> 32));
    if (lane == 0) {
      if (lo) atomicOr(&found_s[0], lo);
      if (hi) atomicOr(&found_s[1], hi);
    }
    hopper::named_sync(2, kConsumers);
    const uint64_t found = found_s[0] | ((uint64_t)found_s[1] << 32);
    hopper::named_sync(2, kConsumers);  // every thread has read found_s
    if ((found & all) == all) return;
    if (c0 + kConsumers >= a.Tk) {
      if (tid == 0) *unmatched_s = 1;
      return;
    }
  }
}

// One block: BM (64, or 32 for short sequences) query rows of one (b, h).
// The last warp loads Q once and streams the K, V and ab tiles (and the key
// segment ids) of every key tile that is not skipped through a ring of
// kStages stages. Two groups of four warps compute, group wg over the key
// tiles t with t % 2 == wg, each with its own online softmax, and merge
// their rows' m, l and O at the end through shared memory.
template <int DH, int BM>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_f32_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap ab_map, const Args a) {
  using S = Shape<DH, BM>;
  constexpr int BK = S::BK, TR = S::TR, KPT = S::KPT, CPT = S::CPT, NS = S::kStages,
                SWZ = S::kSwz, COLS = S::kCols, PLD = S::kPld;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint8_t skip_s[kMaxSkipTiles];  // 1: the 64-key tile is left out
  __shared__ int rseg_s[kSkipTile];          // the 64-row tile's segment ids
  __shared__ uint32_t found_s[2];            // its rows that have a key of their segment
  __shared__ int unmatched_s;                // a row has none: every tile is taken
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = smem;
  uint8_t* stages = smem + S::kQBytes;
  float* p_all = reinterpret_cast<float*>(smem + S::kPOffset);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::kBarOffset);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;        // [NS]: the stage's tiles have landed
  uint64_t* empty = bars + 1 + NS;  // [NS]: the consumers are done with it

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_tiles = (a.Tk + BK - 1) / BK;
  const bool seg = a.q_seg != nullptr;
  const bool skipping = seg && !a.has_ab;
  const int n_skip = min((a.Tk + kSkipTile - 1) / kSkipTile, kMaxSkipTiles);
  const int r_base = q0 / kSkipTile * kSkipTile;  // the 64-row tile of the rule

  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kGroupThreads);  // the group that takes the tile
    }
    hopper::fence_barrier_init();
    found_s[0] = found_s[1] = 0;
    unmatched_s = 0;
  }
  if (skipping) {
    if (tid < kSkipTile)
      rseg_s[tid] = r_base + tid < a.Tq ? a.q_seg[(size_t)b * a.Tq + r_base + tid] : 0;
    for (int t = tid; t < n_skip; t += kThreads) skip_s[t] = 1;
  }
  __syncthreads();
  if (warp == kConsumers / 32 && lane == 0) {
    hopper::prefetch_map(&q_map);
    hopper::prefetch_map(&k_map);
    hopper::prefetch_map(&v_map);
    hopper::mbar_arrive_expect_tx(q_full, S::kQBytes);
    for (int part = 0; part < S::kParts; ++part)
      hopper::load_rows(q_s + part * BM * SWZ, &q_map, q_full, part * COLS, q0, h, b,
                        a.q_swap);
  }
  if (skipping) {
    if (tid < kConsumers)
      skip_rule(a, b, r_base, n_skip, rseg_s, skip_s, found_s, &unmatched_s);
    __syncthreads();
  }
  const bool can_skip = skipping && unmatched_s == 0;
  auto skipped = [&](int t) {
    const int u = t * BK / kSkipTile;
    return can_skip && u < n_skip && skip_s[u] != 0;
  };

  if (warp == kConsumers / 32) {
    // ---- producer warp: the tiles that are taken, in order, n of them so far
    for (int t = 0, n = 0; t < n_tiles; ++t) {
      if (skipped(t)) continue;
      const int s = n % NS, k0 = t * BK;
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
        hopper::mbar_arrive_expect_tx(&full[s],
                                      2 * S::kKvBytes + (a.has_ab ? S::kAbBytes : 0));
        for (int part = 0; part < S::kParts; ++part) {
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
    return;
  }

  // ---- consumer group wg: thread (row group g, key group kg) holds rows
  // g + 16 i (i < TR) and keys kg + 8 c (c < KPT) of each score tile, and
  // the same rows of O at the columns of the 16-byte chunks kg + 8 u; where
  // Dh / 8 is not a multiple of 4 (Dh = 16, 80), at the columns of the
  // 8-byte pairs kg + 8 u instead (columns 2 (kg + 8 u) and the next, u <
  // Dh / 16). A row group lives in one warp, so p
  // goes from the scores to the value product through shared memory with a
  // warp's sync alone. Row r, key j: TMA's swizzle puts the 16-byte chunks
  // of eight consecutive rows in distinct banks, so a warp's 16-byte loads of
  // Q (4 rows, each a broadcast to 8 lanes) and of K (8 rows) are
  // conflict-free.
  const int wg = warp / 4, g = 4 * (warp % 4) + lane / 8, kg = lane % 8;
  float* p_s = p_all + wg * BM * PLD;
  // the swizzle terms of the thread's rows of Q and ab (rows g + 16 i all
  // have g's) and of K (rows kg + 8 c, kg's)
  const int xq = swz_term<SWZ>(g), xk = swz_term<SWZ>(kg), xa = g & 7;
  int qseg[TR];
  float m[TR], l[TR], o[TR][CPT];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int row = q0 + g + 16 * i;
    qseg[i] = (seg && row < a.Tq) ? a.q_seg[(size_t)b * a.Tq + row] : 0;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < CPT; ++e) o[i][e] = 0.f;
  }

  hopper::mbar_wait(q_full, 0);
  for (int t = 0, n = 0; t < n_tiles; ++t) {
    if (skipped(t)) continue;
    const int nn = n++;
    if (t % kGroups != wg) continue;
    const int s = nn % NS, k0 = t * BK;
    const uint8_t* k_s = stages + s * S::kStageBytes;
    const uint8_t* v_s = k_s + S::kKvBytes;
    const uint8_t* ab_s = k_s + 2 * S::kKvBytes;
    const int32_t* kseg = reinterpret_cast<const int32_t*>(ab_s + S::kAbBytes);
    hopper::mbar_wait(&full[s], (nn / NS) & 1);

    // ---- S = Q K^T, each logit summed over d in order (fp32 FMAs, no TF32)
    float sc[TR][KPT];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int c = 0; c < KPT; ++c) sc[i][c] = 0.f;
    // not unrolled whole: the offsets of every chunk held at once would
    // take the registers of the tiles
#pragma unroll 2
    for (int d4 = 0; d4 < DH / 4; ++d4) {
      constexpr int kChunks = SWZ / 16;  // chunks of a swizzled row
      const int part = d4 / kChunks, cc = d4 % kChunks;
      const uint8_t* q_at = q_s + part * BM * SWZ + g * SWZ + ((cc ^ xq) << 4);
      const uint8_t* k_at = k_s + part * BK * SWZ + kg * SWZ + ((cc ^ xk) << 4);
      float4 qv[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_at + 16 * i * SWZ);
#pragma unroll
      for (int c = 0; c < KPT; ++c) {
        const float4 kv = *reinterpret_cast<const float4*>(k_at + 8 * c * SWZ);
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          sc[i][c] = fmaf(qv[i].x, kv.x, sc[i][c]);
          sc[i][c] = fmaf(qv[i].y, kv.y, sc[i][c]);
          sc[i][c] = fmaf(qv[i].z, kv.z, sc[i][c]);
          sc[i][c] = fmaf(qv[i].w, kv.w, sc[i][c]);
        }
      }
    }

    // ---- bias, mask and the online softmax of the thread's rows; keys past
    // Tk (the last tile's tail) are -inf
    if (a.has_ab) {
      // key kg + 8 c: 32-key box c / 4, its 16-byte chunk kg / 4 + 2 (c % 4)
      const uint8_t* ab_at = ab_s + g * 128 + (kg % 4) * 4;
#pragma unroll
      for (int c = 0; c < KPT; ++c) {
        const int off = (c / 4) * BM * 128 + (((kg / 4 + 2 * (c % 4)) ^ xa) << 4);
#pragma unroll
        for (int i = 0; i < TR; ++i)
          sc[i][c] += *reinterpret_cast<const float*>(ab_at + off + 16 * i * 128);
      }
    }
    if (seg) {
#pragma unroll
      for (int c = 0; c < KPT; ++c) {
        const int ks = kseg[kg + 8 * c];
#pragma unroll
        for (int i = 0; i < TR; ++i) sc[i][c] += (qseg[i] == ks) ? 0.f : a.mask_value;
      }
    }
    if (k0 + BK > a.Tk) {
#pragma unroll
      for (int c = 0; c < KPT; ++c)
        if (k0 + kg + 8 * c >= a.Tk)
#pragma unroll
          for (int i = 0; i < TR; ++i) sc[i][c] = -INFINITY;
    }
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      float mx = sc[i][0];
#pragma unroll
      for (int c = 1; c < KPT; ++c) mx = fmaxf(mx, sc[i][c]);
      // the eight lanes of a row group hold a row between them
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      // m_new is finite unless every logit so far is -inf (an ab of -inf)
      const bool live = m_new != -INFINITY;
      const float alpha = live ? expf(m[i] - m_new) : 1.f;
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < KPT; ++c) {
        const float p = live ? expf(sc[i][c] - m_new) : 0.f;
        ps += p;
        p_s[(g + 16 * i) * PLD + kg + 8 * c] = p;
      }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      ps += __shfl_xor_sync(0xffffffffu, ps, 4);
      l[i] = l[i] * alpha + ps;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < CPT; ++e) o[i][e] *= alpha;
    }
    __syncwarp();

    // ---- O += P V, each key in order (past Tk: p = 0, v = 0)
#pragma unroll 2
    for (int j4 = 0; j4 < BK / 4; ++j4) {
      float4 pv[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&p_s[(g + 16 * i) * PLD + 4 * j4]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * j4 + jj;
        float vv[CPT];
        if constexpr (CPT % 4 == 0) {
#pragma unroll
          for (int u = 0; u < CPT / 4; ++u) {
            const float4 x =
                *reinterpret_cast<const float4*>(v_s + chunk_at<SWZ, BK>(j, kg + 8 * u));
            vv[4 * u] = x.x;
            vv[4 * u + 1] = x.y;
            vv[4 * u + 2] = x.z;
            vv[4 * u + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int u = 0; u < CPT / 2; ++u) {
            const int pair = kg + 8 * u;
            const float2 x = *reinterpret_cast<const float2*>(
                v_s + chunk_at<SWZ, BK>(j, pair / 2) + (pair % 2) * 8);
            vv[2 * u] = x.x;
            vv[2 * u + 1] = x.y;
          }
        }
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const float pj = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y : jj == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int e = 0; e < CPT; ++e) o[i][e] = fmaf(pj, vv[e], o[i][e]);
        }
      }
    }
    __syncwarp();  // p_s is read before the next tile writes it
    hopper::mbar_arrive(&empty[s]);
  }

  // ---- merge: group 1 hands its m, l and O to group 0 through the ring's
  // shared memory (every tile is consumed, no copy is in flight)
  float* xch = reinterpret_cast<float*>(stages);  // [TR * (CPT + 2)][128]
  const int gt = tid % kGroupThreads;
  hopper::named_sync(1, kConsumers);
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < TR; ++i) {
#pragma unroll
      for (int e = 0; e < CPT; ++e) xch[(i * CPT + e) * 128 + gt] = o[i][e];
      xch[(TR * CPT + i) * 128 + gt] = m[i];
      xch[(TR * CPT + TR + i) * 128 + gt] = l[i];
    }
  }
  hopper::named_sync(1, kConsumers);
  if (wg == 1) return;
  const size_t bh = (size_t)b * a.H + h;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const float mb = xch[(TR * CPT + i) * 128 + gt];
    const float mm = fmaxf(m[i], mb);
    // a part whose logits are all -inf weighs 0 (and so does a row of them)
    const float fa = m[i] == -INFINITY ? 0.f : expf(m[i] - mm);
    const float fb = mb == -INFINITY ? 0.f : expf(mb - mm);
    l[i] = l[i] * fa + xch[(TR * CPT + TR + i) * 128 + gt] * fb;
    m[i] = mm;
#pragma unroll
    for (int e = 0; e < CPT; ++e) o[i][e] = o[i][e] * fa + xch[(i * CPT + e) * 128 + gt] * fb;

    // ---- epilogue: out = O / l; the residuals m and l
    const int row = q0 + g + 16 * i;
    if (row >= a.Tq) continue;
    const float inv = l[i] == 0.f ? 1.f : 1.f / l[i];
    float* dst = a.out + (bh * a.Tq + row) * DH;
    if constexpr (CPT % 4 == 0) {
#pragma unroll
      for (int u = 0; u < CPT / 4; ++u)
        *reinterpret_cast<float4*>(dst + 4 * (kg + 8 * u)) =
            make_float4(o[i][4 * u] * inv, o[i][4 * u + 1] * inv, o[i][4 * u + 2] * inv,
                        o[i][4 * u + 3] * inv);
    } else {
#pragma unroll
      for (int u = 0; u < CPT / 2; ++u)
        *reinterpret_cast<float2*>(dst + 2 * (kg + 8 * u)) =
            make_float2(o[i][2 * u] * inv, o[i][2 * u + 1] * inv);
    }
    if (a.m_out != nullptr && kg == 0) {
      a.m_out[bh * a.Tq + row] = m[i];
      a.l_out[bh * a.Tq + row] = l[i];
    }
  }
}

}  // namespace f32

namespace {

template <int DH, int BM>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* ab,
                       const Strides& st, int B, int H, int Tq, int Tk, f32::Args a,
                       cudaStream_t stream) {
  using S = f32::Shape<DH, BM>;
  constexpr CUtensorMapDataType kF32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap qm, km, vm, abm;
  cudaError_t err = hopper::map_rows(&qm, q, st.qb, st.qh, st.qt, B, H, Tq, DH, S::kCols,
                                     BM, S::kSwz, &a.q_swap, kF32);
  if (err == cudaSuccess)
    err = hopper::map_rows(&km, k, st.kb, st.kh, st.kt, B, H, Tk, DH, S::kCols, S::BK,
                           S::kSwz, &a.k_swap, kF32);
  if (err == cudaSuccess)
    err = hopper::map_rows(&vm, v, st.vb, st.vh, st.vt, B, H, Tk, DH, S::kCols, S::BK,
                           S::kSwz, &a.v_swap, kF32);
  if (err == cudaSuccess) {
    if (a.has_ab)
      err = hopper::map_bias(&abm, ab, st.abt, B, H, Tq, Tk, BM, kF32);
    else
      abm = qm;  // not read
  }
  if (err != cudaSuccess) return err;
  auto kernel = f32::flash_attention_f32_kernel<DH, BM>;
  // once: the ring's shared memory
  static const cudaError_t allowed = hopper::allow_smem(kernel, S::kSmemBytes);
  if (allowed != cudaSuccess) return allowed;
  const dim3 grid((Tq + BM - 1) / BM, H, B);
  kernel<<<grid, f32::kThreads, S::kSmemBytes, stream>>>(qm, km, vm, abm, a);
  return cudaGetLastError();
}

// the fp32 kernel, by head dim and query rows of a block (64, or 32)
cudaError_t dispatch_f32(int Dh, int block_rows, const void* q, const void* k,
                         const void* v, const void* ab, const Strides& st, int B, int H,
                         int Tq, int Tk, const f32::Args& a, cudaStream_t stream) {
  if (block_rows != 32 && block_rows != 64) return cudaErrorInvalidValue;
  const bool wide = block_rows == 64;
  switch (Dh) {
    case 16:
      return wide ? launch_f32<16, 64>(q, k, v, ab, st, B, H, Tq, Tk, a, stream)
                  : launch_f32<16, 32>(q, k, v, ab, st, B, H, Tq, Tk, a, stream);
    case 32:
      return wide ? launch_f32<32, 64>(q, k, v, ab, st, B, H, Tq, Tk, a, stream)
                  : launch_f32<32, 32>(q, k, v, ab, st, B, H, Tq, Tk, a, stream);
    case 64:
      return wide ? launch_f32<64, 64>(q, k, v, ab, st, B, H, Tq, Tk, a, stream)
                  : launch_f32<64, 32>(q, k, v, ab, st, B, H, Tq, Tk, a, stream);
    case 80:
      return wide ? launch_f32<80, 64>(q, k, v, ab, st, B, H, Tq, Tk, a, stream)
                  : launch_f32<80, 32>(q, k, v, ab, st, B, H, Tq, Tk, a, stream);
    case 128:
      return wide ? launch_f32<128, 64>(q, k, v, ab, st, B, H, Tq, Tk, a, stream)
                  : launch_f32<128, 32>(q, k, v, ab, st, B, H, Tq, Tk, a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma) fed by TMA
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kGroups = 2;                    // consumer warpgroups: the products
constexpr int kConsumers = 128 * kGroups;
constexpr int kThreadsTc = kConsumers + 32;   // and one producer warp: TMA
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct FwdShape {
  static constexpr int BM = 64;                        // query rows of a block
  static constexpr int BK = 64;                        // keys of a tile
  static constexpr int kStages = DH <= 64 ? 4 : 3;     // ring of K, V, ab tiles
  static constexpr int kSwz = hopper::row_box_bytes(DH * 2);  // bytes of a swizzled box row
  static constexpr int kCols = kSwz / 2;               // its columns (TMA box)
  static constexpr int kParts = DH / kCols;            // 2 at Dh = 128, 5 at 80, else 1
  static constexpr int kQBytes = BM * DH * 2;
  static constexpr int kKvBytes = BK * DH * 2;         // one K or V tile
  static constexpr int kAbBytes = BM * BK * 2;         // one ab tile
  static constexpr int kSegBytes = 1024;               // BK key segment ids
  static constexpr int kStageBytes = 2 * kKvBytes + kAbBytes + kSegBytes;
  static constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
  // 1024 bytes of slack align the tiles (the swizzle atom)
  static constexpr size_t kSmemBytes = 1024 + kBarOffset + 8 * (2 * kStages + 1);
};

// ab[row][col] of a 64 x 64 bf16 tile stored with the 128-byte swizzle:
// two consecutive columns (col even) as a float pair
__device__ __forceinline__ float2 ab_pair(const uint8_t* tile, int row, int col) {
  const int off = row * 128 + ((((col >> 3) ^ (row & 7))) << 4) + (col & 7) * 2;
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(tile + off));
}

struct FwdArgs {
  const int32_t* q_seg;
  const int32_t* kv_seg;
  int H, Tq, Tk;
  float mask_value;
  bool q_swap, k_swap, v_swap;  // th_swap of each map
  __nv_bfloat16* out;
  float* m_out;
  float* l_out;
};

// One block: 64 query rows of one (b, h). The last warp loads Q once and
// streams the K, V, ab tiles (and the key segment ids) of every key tile
// through a ring of kStages stages. Two warpgroups compute, each over every
// other key tile with its own online softmax (so that one's softmax overlaps
// the other's products, and each has half the tiles to go through), and
// merge their rows' m, l and O at the end through shared memory. HAS_AB and
// SEG (a bias; segment ids) are template arguments, so that the softmax
// holds no branch.
template <int DH, bool HAS_AB, bool SEG>
__global__ void __launch_bounds__(kThreadsTc)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap ab_map, const FwdArgs a) {
  using S = FwdShape<DH>;
  constexpr int BM = S::BM, BK = S::BK, NS = S::kStages, SWZ = S::kSwz,
                COLS = S::kCols;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = smem;
  uint8_t* stages = smem + S::kQBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::kBarOffset);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;        // [NS]: the stage's tiles have landed
  uint64_t* empty = bars + 1 + NS;  // [NS]: the consumers are done with it

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_tiles = (a.Tk + BK - 1) / BK;

  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 128);    // the warpgroup that takes the tile
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // ---- producer warp
    if (lane == 0) {
      hopper::prefetch_map(&q_map);
      hopper::prefetch_map(&k_map);
      hopper::prefetch_map(&v_map);
      hopper::mbar_arrive_expect_tx(q_full, S::kQBytes);
      for (int part = 0; part < S::kParts; ++part)
        hopper::load_rows(q_s + part * BM * SWZ, &q_map, q_full, part * COLS, q0, h, b, a.q_swap);
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % NS, k0 = t * BK;
      if (t >= NS) hopper::mbar_wait(&empty[s], ((t / NS) - 1) & 1);
      uint8_t* st = stages + s * S::kStageBytes;
      if (SEG) {
        int32_t* kseg = reinterpret_cast<int32_t*>(st + 2 * S::kKvBytes + S::kAbBytes);
        for (int j = lane; j < BK; j += 32)
          kseg[j] = k0 + j < a.Tk ? a.kv_seg[(size_t)b * a.Tk + k0 + j] : 0;
        __syncwarp();
      }
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(
            &full[s], 2 * S::kKvBytes + (HAS_AB ? S::kAbBytes : 0));
        for (int part = 0; part < S::kParts; ++part) {
          hopper::load_rows(st + part * BK * SWZ, &k_map, &full[s], part * COLS, k0, h, b,
                    a.k_swap);
          hopper::load_rows(st + S::kKvBytes + part * BK * SWZ, &v_map, &full[s], part * COLS, k0,
                    h, b, a.v_swap);
        }
        if (HAS_AB)
          hopper::tma_load_4d(st + 2 * S::kKvBytes, &ab_map, &full[s], k0, q0, h, b);
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: thread (warp, lane) holds rows r0 and r0 + 8
  // of every accumulator, and in its 8-column chunk j the columns
  // 8 j + kc + {0, 1}
  const int wg = warp / 4, r0 = 16 * (warp % 4) + lane / 4, kc = 2 * (lane % 4);
  const int i0 = q0 + r0, i1 = i0 + 8;
  const int qseg0 = (SEG && i0 < a.Tq) ? a.q_seg[(size_t)b * a.Tq + i0] : 0;
  const int qseg1 = (SEG && i1 < a.Tq) ? a.q_seg[(size_t)b * a.Tq + i1] : 0;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float sc[BK / 2];
  uint32_t pa[BK / 16][4];

  hopper::mbar_wait(q_full, 0);
  for (int t = wg; t < n_tiles; t += kGroups) {
    const int s = t % NS, k0 = t * BK;
    const uint8_t* st = stages + s * S::kStageBytes;
    hopper::mbar_wait(&full[s], (t / NS) & 1);

    // ---- S = Q K^T (K-major A and B from shared memory; k16 step kk in
    // part kk * 16 / COLS of the rows)
    hopper::fence_regs(sc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int part = kk * 16 / COLS, off = (kk * 16 % COLS) * 2;
      hopper::Wgmma<BK>::ss(
          sc, hopper::make_desc(q_s + part * BM * SWZ + off, 16, 8 * SWZ, SWZ),
          hopper::make_desc(st + part * BK * SWZ + off, 16, 8 * SWZ, SWZ), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    // ---- bias, mask and the online softmax of rows r0 and r0 + 8; keys past
    // Tk (the last tile's tail) are -inf, which no bias or mask changes
    const uint8_t* ab_s = st + 2 * S::kKvBytes;
    const int32_t* kseg = reinterpret_cast<const int32_t*>(ab_s + S::kAbBytes);
    if (k0 + BK > a.Tk) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (k0 + 8 * j + kc + e >= a.Tk) sc[4 * j + e] = sc[4 * j + 2 + e] = -INFINITY;
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
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
        float x0 = sc[4 * j + e], x1 = sc[4 * j + 2 + e];
        if (HAS_AB) {
          x0 += e ? ab0.y : ab0.x;
          x1 += e ? ab1.y : ab1.x;
        }
        if (SEG) {
          const int ks = kseg[col + e];
          x0 += (qseg0 == ks) ? 0.f : a.mask_value;
          x1 += (qseg1 == ks) ? 0.f : a.mask_value;
        }
        sc[4 * j + e] = x0;
        sc[4 * j + 2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
    // the four threads of a quad hold a row between them
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // mn is finite unless every logit so far is -inf (an ab of -inf)
    // mn is -inf only where every logit so far is -inf (an ab of -inf): such
    // a row subtracts 0 instead, so that its p = exp(-inf) = 0, not NaN
    const float ms0 = mn0 == -INFINITY ? 0.f : mn0, ms1 = mn1 == -INFINITY ? 0.f : mn1;
    // exp(d) as the hardware's exp2(d * log2 e), where expf spends a dozen
    // instructions an element; d = x - m is formed first, so the mask value's
    // -0.7 * FLT_MAX never overflows
    const float alpha0 = hopper::exp2_ftz((m0 - ms0) * kLog2e);
    const float alpha1 = hopper::exp2_ftz((m1 - ms1) * kLog2e);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p0 = hopper::exp2_ftz((sc[4 * j + e] - ms0) * kLog2e);
        const float p1 = hopper::exp2_ftz((sc[4 * j + 2 + e] - ms1) * kLog2e);
        ps0 += p0;
        ps1 += p1;
        sc[4 * j + e] = p0;
        sc[4 * j + 2 + e] = p1;
      }
    }
    ps0 += __shfl_xor_sync(0xffffffffu, ps0, 1);
    ps0 += __shfl_xor_sync(0xffffffffu, ps0, 2);
    ps1 += __shfl_xor_sync(0xffffffffu, ps1, 1);
    ps1 += __shfl_xor_sync(0xffffffffu, ps1, 2);
    l0 = l0 * alpha0 + ps0;
    l1 = l1 * alpha1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      o[4 * j] *= alpha0;
      o[4 * j + 1] *= alpha0;
      o[4 * j + 2] *= alpha1;
      o[4 * j + 3] *= alpha1;
    }
    // p rounded to bf16: the register A fragments of the value product
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = hopper::pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = hopper::pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = hopper::pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = hopper::pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }

    // ---- O += P V (V MN-major from shared memory, its parts along N LBO =
    // BK * SWZ apart); keys past Tk: p = 0, v = 0
    hopper::fence_regs(o);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hopper::Wgmma<DH>::rs(
          o, pa[kk],
          hopper::make_desc(st + S::kKvBytes + kk * 16 * SWZ, BK * SWZ, 8 * SWZ, SWZ), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    hopper::mbar_arrive(&empty[s]);
  }

  // ---- merge: warpgroup 1 hands its m, l and O to warpgroup 0 through the
  // ring's shared memory (every tile is consumed, no copy is in flight)
  float* xch = reinterpret_cast<float*>(stages);  // [DH / 2 + 4][128]
  const int ti = tid % 128;
  hopper::named_sync(1, kConsumers);
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) xch[i * 128 + ti] = o[i];
    xch[(DH / 2) * 128 + ti] = m0;
    xch[(DH / 2 + 1) * 128 + ti] = m1;
    xch[(DH / 2 + 2) * 128 + ti] = l0;
    xch[(DH / 2 + 3) * 128 + ti] = l1;
  }
  hopper::named_sync(1, kConsumers);
  if (wg == 1) return;
  {
    const float mb0 = xch[(DH / 2) * 128 + ti], mb1 = xch[(DH / 2 + 1) * 128 + ti];
    const float mm0 = fmaxf(m0, mb0), mm1 = fmaxf(m1, mb1);
    // a part whose logits are all -inf weighs 0 (and so does a row of them)
    const float fa0 = m0 == -INFINITY ? 0.f : expf(m0 - mm0);
    const float fb0 = mb0 == -INFINITY ? 0.f : expf(mb0 - mm0);
    const float fa1 = m1 == -INFINITY ? 0.f : expf(m1 - mm1);
    const float fb1 = mb1 == -INFINITY ? 0.f : expf(mb1 - mm1);
    l0 = l0 * fa0 + xch[(DH / 2 + 2) * 128 + ti] * fb0;
    l1 = l1 * fa1 + xch[(DH / 2 + 3) * 128 + ti] * fb1;
    m0 = mm0;
    m1 = mm1;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      o[4 * j] = o[4 * j] * fa0 + xch[(4 * j) * 128 + ti] * fb0;
      o[4 * j + 1] = o[4 * j + 1] * fa0 + xch[(4 * j + 1) * 128 + ti] * fb0;
      o[4 * j + 2] = o[4 * j + 2] * fa1 + xch[(4 * j + 2) * 128 + ti] * fb1;
      o[4 * j + 3] = o[4 * j + 3] * fa1 + xch[(4 * j + 3) * 128 + ti] * fb1;
    }
  }

  // ---- epilogue: out = O / l in bf16; the residuals m and l
  const size_t bh = (size_t)b * a.H + h;
  const float inv0 = l0 == 0.f ? 1.f : 1.f / l0;
  const float inv1 = l1 == 0.f ? 1.f : 1.f / l1;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int d = 8 * j + kc;
    if (i0 < a.Tq)
      *reinterpret_cast<uint32_t*>(&a.out[(bh * a.Tq + i0) * DH + d]) =
          hopper::pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (i1 < a.Tq)
      *reinterpret_cast<uint32_t*>(&a.out[(bh * a.Tq + i1) * DH + d]) =
          hopper::pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
  if (a.m_out != nullptr && lane % 4 == 0) {
    if (i0 < a.Tq) {
      a.m_out[bh * a.Tq + i0] = m0;
      a.l_out[bh * a.Tq + i0] = l0;
    }
    if (i1 < a.Tq) {
      a.m_out[bh * a.Tq + i1] = m1;
      a.l_out[bh * a.Tq + i1] = l1;
    }
  }
}

}  // namespace tc

namespace {

template <int DH>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* ab,
                      const Strides& st, int B, int H, int Tq, int Tk, tc::FwdArgs a,
                      cudaStream_t stream) {
  using S = tc::FwdShape<DH>;
  CUtensorMap qm, km, vm, abm;
  cudaError_t err = hopper::map_rows(&qm, q, st.qb, st.qh, st.qt, B, H, Tq, DH, S::kCols,
                                 S::BM, S::kSwz, &a.q_swap);
  if (err == cudaSuccess)
    err = hopper::map_rows(&km, k, st.kb, st.kh, st.kt, B, H, Tk, DH, S::kCols, S::BK,
                       S::kSwz, &a.k_swap);
  if (err == cudaSuccess)
    err = hopper::map_rows(&vm, v, st.vb, st.vh, st.vt, B, H, Tk, DH, S::kCols, S::BK,
                       S::kSwz, &a.v_swap);
  if (err == cudaSuccess) {
    if (ab != nullptr)
      err = hopper::map_bias(&abm, ab, st.abt, B, H, Tq, Tk, S::BM);
    else
      abm = qm;  // not read
  }
  if (err != cudaSuccess) return err;
  const bool has_ab = ab != nullptr, seg = a.q_seg != nullptr;
  auto kernel = has_ab ? (seg ? tc::flash_attention_tc_kernel<DH, true, true>
                              : tc::flash_attention_tc_kernel<DH, true, false>)
                       : (seg ? tc::flash_attention_tc_kernel<DH, false, true>
                              : tc::flash_attention_tc_kernel<DH, false, false>);
  static bool smem_allowed[4] = {false, false, false, false};
  const int variant = 2 * has_ab + seg;
  if (!smem_allowed[variant]) {
    err = hopper::allow_smem(kernel, S::kSmemBytes);
    if (err != cudaSuccess) return err;
    smem_allowed[variant] = true;
  }
  const dim3 grid((Tq + S::BM - 1) / S::BM, H, B);
  kernel<<<grid, tc::kThreadsTc, S::kSmemBytes, stream>>>(qm, km, vm, abm, a);
  return cudaGetLastError();
}

cudaError_t dispatch_tc(int Dh, const void* q, const void* k, const void* v,
                        const void* ab, const Strides& st, int B, int H, int Tq, int Tk,
                        const tc::FwdArgs& a, cudaStream_t stream) {
  switch (Dh) {
    case 16: return launch_tc<16>(q, k, v, ab, st, B, H, Tq, Tk, a, stream);
    case 32: return launch_tc<32>(q, k, v, ab, st, B, H, Tq, Tk, a, stream);
    case 64: return launch_tc<64>(q, k, v, ab, st, B, H, Tq, Tk, a, stream);
    case 80: return launch_tc<80>(q, k, v, ab, st, B, H, Tq, Tk, a, stream);
    case 128: return launch_tc<128>(q, k, v, ab, st, B, H, Tq, Tk, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (the SIMT kernel), 1 = bfloat16 (the tensor-core
// kernel) for q, k, v, ab and out. q (B,H,Tq,Dh), k and v (B,H,Tk,Dh) with
// the given element strides of their first three dimensions (16-byte
// multiples, and 16-byte aligned bases); ab (B,H,Tq,Tk) with rows ab_st
// elements apart (16-byte multiples) and a contiguous last dimension, or
// null; q_seg (B,Tq) and kv_seg (B,Tk) int32, both or neither; out
// (B,H,Tq,Dh) contiguous; m and l (B,H,Tq) fp32, both or neither: the
// residuals of the backward. block_rows: the query rows of an fp32 block,
// 64 or 32 (flash_attention.py fp32_block_rows); bf16 blocks take 64.
// Launches on `stream` and returns cudaGetLastError() as an int (0 =
// launched).
int flash_attention(int dtype, const void* q, const void* k, const void* v,
                    const void* ab, const int32_t* q_seg, const int32_t* kv_seg,
                    long long q_sb, long long q_sh, long long q_st, long long k_sb,
                    long long k_sh, long long k_st, long long v_sb, long long v_sh,
                    long long v_st, long long ab_st, int B, int H, int Tq, int Tk, int Dh,
                    int block_rows, float mask_value, void* out, float* m, float* l,
                    void* stream) {
  if ((q_seg == nullptr) != (kv_seg == nullptr) || (m == nullptr) != (l == nullptr) ||
      Tq < 1 || Tk < 1)
    return (int)cudaErrorInvalidValue;
  const Strides st{q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, ab_st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    const f32::Args a{q_seg, kv_seg, H, Tq, Tk, mask_value, ab != nullptr, false, false,
                      false, static_cast<float*>(out), m, l};
    err = dispatch_f32(Dh, block_rows, q, k, v, ab, st, B, H, Tq, Tk, a, s);
  } else if (dtype == 1) {
    const tc::FwdArgs a{q_seg, kv_seg, H, Tq, Tk, mask_value, false, false, false,
                        static_cast<__nv_bfloat16*>(out), m, l};
    err = dispatch_tc(Dh, q, k, v, ab, st, B, H, Tq, Tk, a, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
