// The int8 tied-vocabulary projection with logsumexp and top-k of one
// beam-search step (Hopper, sm_90a): K3b (vocab_topk_v2 and
// vocab_topk_v2_select) and K3a (vocab_topk).
//
// Replaces the TPU kernels of
// seamless_communication_tpu/ops/kernels/vocab_topk.py:
//   K3b  <- `_kernel_v2` (:170, pallas_call :202; wrapper
//           `int8_vocab_topk_v2`, :231), which writes the (N, V) logits, the
//           per-tile stats and block maxima and leaves the selection to XLA
//   K3a  <- `_kernel`    (:45, pallas_call :91; wrapper `int8_vocab_topk`,
//           :120)
// The plain PyTorch versions are in
// seamless_communication_torch/ops/kernels/vocab_topk.py: `_reference` (the
// whole function), `_tiles_reference` (what K3a's and K3b's first stage
// write) and `_select_reference` (the second stage of both).
//
// For the table row v and each x row n:
//   l[n, v] = (sum_d x[n, d] * q[v, d]) * row_scale[v]
// out: each x row's k largest l with their ids (equal values to the lowest
// id) and logz[n] = log sum_v exp(l[n, v]). The products are fp32, as in the
// plain version.
//
// Bound on the card: the int8 table is read once, V*D bytes (262 MB at
// V = 256102, D = 1024), 78.6 us at 3.35 TB/s. The 2*N*V*D operations take
// 39 us at N = 5 and 78 us at N = 10 at the fp32 rate outside the tensor
// cores, so at N = 5 the function is bound by bytes, at N = 10 level.
//
// K3b, two launches a call (K3a, below, the same two).
//
// vocab_topk_v2 (stage 1, the stream): a grid sized to the card (as many
// blocks as fit at once: two an SM up to 8 x rows, one above) walks
// contiguous ranges of 128-row tiles of the table. A producer warp keeps TMA
// copies in flight through a ring of 3 stages of 16 KB, each a box of 128 rows x 128 bytes
// (one slice of d) with the 128-byte swizzle. Four consumer warps share a
// stage: lane (warp, lane) takes the 16-byte chunk 2 warp + lane / 16 of
// the rows lane % 16 + 16 j (j < 8), so that each x value read from shared
// memory (staged once a block as fp32, a broadcast read) serves 8 rows,
// 32 FMAs in 8 independent chains. The int8 values widen exactly by placing
// q + 128 in the mantissa of 2^23 (one byte permute, one subtraction); the
// swizzle puts the 8 lanes of a 16-byte phase on 8 distinct bank groups.
// After a tile's slices, the two half-warps' sums join by one shuffle and
// the four warps' meet in shared memory. Warp w then finishes the x rows
// w, w + 4, ... of the tile's 128 logits: a running (max, sum of exp), and
// the block's sorted list of its k best (value, id), into which a logit goes
// only when it beats the list's last entry (a ballot, then one insertion at
// a time; rare after the first rows). A block writes its lists and stats: a
// few hundred KB for the whole grid, and no (N, V) logits. Up to 12 x rows a
// pass (fewer for large k or D); more rows take more passes, each streaming
// the range again. What holds it back (chip_smoke.py --k3b-parts): the
// stream alone, without the products, is most of the time; the products,
// limited by the instruction rate of the widening and the FMAs, overlap it
// only in part.
//
// vocab_topk_v2_select (stage 2): one block per x row combines the
// blocks' stats into logz and caches the head of each block's sorted list
// in shared memory; then one warp merges the lists into the top k, k rounds
// of a warp argmax over the lanes' best heads (ties to the lowest id), in
// which only the winning lane reads its lists again.
//
// K3a (vocab_topk, then vocab_topk_v2_select): the same stream kernel with
// one difference, a template policy (kPerTile). Its lists and stats are those
// of the K3a tiles of `tile` rows (a multiple of 128): a block's range is a
// run of whole K3a tiles, and at each K3a tile's last 128-row tile the block
// writes its lists and stats of that tile and empties them (`Args::span`,
// the 128-row tiles of a K3a tile); K3b's blocks write once, after their
// range. A K3a tile of fewer than k rows below V pads its list with (-inf,
// kNoId). The selection is K3b's second launch over the ceil(V / tile)
// lists. What a K3a tile costs beyond K3b: refilling its emptied lists (about
// k (1 + ln(rows / k)) insertions a list), so the default tile
// (`ops/kernels/vocab_topk.py fill_tile`) gives each block one K3a tile,
// as many rows as a K3b block's range.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kMagic = 8388736.0f;          // 2^23 + 128

// Byte j of a word of int8 values, given the word xor 0x80808080 (each byte
// then holds q + 128 in [1, 255]): 0x4B0000bb is the float 2^23 + bb.
__device__ __forceinline__ float widen(unsigned biased, int j) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540u | j)) - kMagic;
}

__device__ __forceinline__ unsigned word(const uint4& q, int w) {
  return w == 0 ? q.x : w == 1 ? q.y : w == 2 ? q.z : q.w;
}

// ---------------------------------------------------------------------------
// The stream (K3b's and K3a's first launch) and the selection (their second)
// ---------------------------------------------------------------------------

namespace stream {

constexpr int kRows = 128;                  // table rows of a tile: one a lane
constexpr int kSlice = 128;                 // bytes of a row a stage holds
constexpr int kWarps = 4;                   // consumer warps: two 16-byte chunks of a slice each
constexpr int kThreads = (kWarps + 1) * 32; // and one producer warp (TMA)
constexpr int kStageBytes = kRows * kSlice; // 16 KB
constexpr int kStages = 3;                  // two blocks an SM: 96 KB in flight
constexpr int kMaxPass = 12;                // x rows of a pass
constexpr int kListEntries = 1536;          // rows of a pass x k, at most
constexpr int kMaxXFloats = 16384;          // staged x rows of a pass (64 KB)
constexpr int kMaxK = 128;
constexpr int kMaxBlocks = 1024;            // stream blocks, at most
constexpr int kMaxLists = 2048;             // lists the selection merges, at most
constexpr int kSelectThreads = 256;
constexpr int kSelectCache = 2048;          // stage 2: list entries cached (16 KB)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoId = 0x7fffffff;           // the id of an empty list entry

// (va, ia) ranks before (vb, ib): the larger value, or the lower id
__device__ __forceinline__ bool beats(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

struct Args {
  const void* x;
  int x_bf16;
  const float* row_scale;
  int N, D, Dp, V, k, tiles;
  int span;             // K3a: the 128-row tiles of a list (K3b: unused)
  float* cand_val;      // (L, N, k), L lists: K3b the G blocks, K3a the ceil(V / tile) tiles
  int32_t* cand_idx;    // (L, N, k)
  float* blk_max;       // (L, N)
  float* blk_se;        // (L, N)
};

// x rows a pass, and the dynamic shared memory of the stream kernel
inline int rows_a_pass(int N, int Dp, int k) {
  int np = kMaxPass;
  if (kListEntries / k < np) np = kListEntries / k;
  if (kMaxXFloats / Dp < np) np = kMaxXFloats / Dp;
  return N < np ? N : np;
}

inline size_t smem_bytes(int np, int Dp, int k) {
  return 1024 + (size_t)kStages * kStageBytes + (size_t)np * Dp * 4 + (size_t)np * k * 8 +
         (size_t)kWarps * np * kRows * 4 + 16 * kStages;
}

// One block: the tiles [t0, t1) of the table, NP x rows a pass. K3b
// (kPerTile false): the block's lists and stats are written once, after its
// last tile (list blk); K3a (kPerTile true): at the last tile of each K3a
// tile of `span` tiles (list t / span), and emptied after each write.
template <int NP, bool kPerTile>
__global__ void __launch_bounds__(kThreads, NP <= 8 ? 2 : 1)
vocab_stream_kernel(const __grid_constant__ CUtensorMap map, const Args a) {
  constexpr int NPW = (NP + kWarps - 1) / kWarps;   // x rows a warp finishes
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  float* x_s = reinterpret_cast<float*>(ring + kStages * kStageBytes);   // [NP][Dp]
  float* lv = x_s + NP * a.Dp;                                 // [NP][k]
  int* li = reinterpret_cast<int*>(lv + NP * a.k);             // [NP][k]
  float* red = reinterpret_cast<float*>(li + NP * a.k);        // [kWarps][NP][kRows]
  uint64_t* full = reinterpret_cast<uint64_t*>(red + kWarps * NP * kRows);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int blk = blockIdx.x, G = gridDim.x;
  // the block's units (K3b: 128-row tiles, K3a: K3a tiles) and their tiles
  const int span = kPerTile ? a.span : 1;
  int t0, t1;
  if constexpr (kPerTile) {
    const int units = (a.tiles + span - 1) / span;
    t0 = (int)((long long)blk * units / G) * span;
    t1 = min((int)((long long)(blk + 1) * units / G) * span, a.tiles);
  } else {
    t0 = (int)((long long)blk * a.tiles / G);
    t1 = (int)((long long)(blk + 1) * a.tiles / G);
  }
  const int slices = a.Dp / kSlice, passes = (a.N + NP - 1) / NP, k = a.k;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kWarps * 32);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kWarps) {
    // ---- producer warp: every (pass, tile, slice) in the consumers' order
    if (lane == 0) {
      hopper::prefetch_map(&map);
      int it = 0;
      for (int p = 0; p < passes; ++p)
        for (int t = t0; t < t1; ++t)
          for (int sl = 0; sl < slices; ++sl, ++it) {
            const int s = it % kStages;
            if (it >= kStages) hopper::mbar_wait(&empty[s], ((it / kStages) - 1) & 1);
            hopper::mbar_arrive_expect_tx(&full[s], kStageBytes);
            hopper::tma_load_2d(ring + s * kStageBytes, &map, &full[s], sl * kSlice,
                                t * kRows);
          }
    }
    return;
  }

  // ---- consumer warps. Products: lane (warp, lane) sums rows lane % 16 +
  // 16 j (j < 8) of a tile over the 16-byte chunk 2 warp + lane / 16 of each
  // 128-byte slice, so that each x value read serves 8 rows (32 FMAs in 8
  // independent chains). Finish: warp w takes the x rows n = w, w + 4, ...
  // of the pass, a lane the tile rows lane + 32 i (i < 4).
  const int c = 2 * warp + lane / 16, r0 = lane % 16;
  int it = 0;
  for (int p = 0; p < passes; ++p) {
    const int n0 = p * NP;
    hopper::named_sync(1, kWarps * 32);   // the previous pass's lists are written out
    for (int e = tid; e < NP * a.Dp; e += kWarps * 32) {
      const int n = e / a.Dp, d = e - n * a.Dp;
      float v = 0.f;
      if (n0 + n < a.N && d < a.D) {
        const size_t o = (size_t)(n0 + n) * a.D + d;
        v = a.x_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.x)[o])
                     : static_cast<const float*>(a.x)[o];
      }
      x_s[e] = v;
    }
    for (int e = tid; e < NP * k; e += kWarps * 32) {
      lv[e] = -INFINITY;
      li[e] = kNoId;
    }
    hopper::named_sync(1, kWarps * 32);   // x staged, lists empty

    float m[NPW], se[NPW];
#pragma unroll
    for (int q = 0; q < NPW; ++q) {
      m[q] = -INFINITY;
      se[q] = 0.f;
    }
    for (int t = t0; t < t1; ++t) {
      float acc[NP][8];
#pragma unroll
      for (int n = 0; n < NP; ++n)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[n][j] = 0.f;
      for (int sl = 0; sl < slices; ++sl, ++it) {
        const int s = it % kStages;
        hopper::mbar_wait(&full[s], (it / kStages) & 1);
        const uint8_t* tile = ring + s * kStageBytes;
        const float* xsl = x_s + sl * kSlice + 16 * c;
        uint4 q[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          q[j] = *reinterpret_cast<const uint4*>(tile + hopper::swizzled(r0 + 16 * j, c, 128));
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float w[8][4];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const unsigned biased = word(q[j], u) ^ 0x80808080u;
#pragma unroll
            for (int e = 0; e < 4; ++e) w[j][e] = widen(biased, e);
          }
#pragma unroll
          for (int n = 0; n < NP; ++n) {
            const float4 xv = *reinterpret_cast<const float4*>(xsl + n * a.Dp + 4 * u);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              float sum = acc[n][j];
              sum = fmaf(w[j][0], xv.x, sum);
              sum = fmaf(w[j][1], xv.y, sum);
              sum = fmaf(w[j][2], xv.z, sum);
              sum = fmaf(w[j][3], xv.w, sum);
              acc[n][j] = sum;
            }
          }
        }
        hopper::mbar_arrive(&empty[s]);
      }
      // the half-warps' chunks join, then the warps' partial sums meet in
      // shared memory
#pragma unroll
      for (int n = 0; n < NP; ++n)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float other = __shfl_xor_sync(kFull, acc[n][j], 16);
          if ((j < 4) == (lane < 16))
            red[(warp * NP + n) * kRows + r0 + 16 * j] = acc[n][j] + other;
        }
      hopper::named_sync(1, kWarps * 32);

      // ---- the tile's logits of the warp's x rows: running stats, and the
      // list's k best (a logit goes in only when it beats the list's last);
      // K3a: at a K3a tile's last tile its lists and stats are written and
      // emptied
      const bool flush = kPerTile && (t + 1 == t1 || (t + 1) % span == 0);
#pragma unroll
      for (int qn = 0; qn < NPW; ++qn) {
        const int n = warp + kWarps * qn;
        if (n >= NP || n0 + n >= a.N) break;   // the pass's zero rows past N
        float* nv_s = lv + n * k;
        int* ni_s = li + n * k;
#pragma unroll
        for (int i = 0; i < kRows / 32; ++i) {
          const int row = lane + 32 * i, v = t * kRows + row;
          const bool ok = v < a.V;
          float dot = 0.f;
#pragma unroll
          for (int u = 0; u < kWarps; ++u) dot += red[(u * NP + n) * kRows + row];
          const float l = dot * (ok ? __ldg(a.row_scale + v) : 0.f);
          if (ok) {
            const float mx = fmaxf(m[qn], l);
            se[qn] = se[qn] * expf(m[qn] - mx) + expf(l - mx);
            m[qn] = mx;
          }
          bool pred = ok && beats(l, v, nv_s[k - 1], ni_s[k - 1]);
          unsigned want = __ballot_sync(kFull, pred);
          while (want) {
            const int src = __ffs(want) - 1;
            const float nv = __shfl_sync(kFull, l, src);
            const int ni = __shfl_sync(kFull, v, src);
            int pos = 0;
            for (int j0 = 0; j0 < k; j0 += 32) {
              const int j = j0 + lane;
              pos += __popc(__ballot_sync(kFull, j < k && beats(nv_s[j], ni_s[j], nv, ni)));
            }
            float sv[kMaxK / 32];
            int si[kMaxK / 32];
#pragma unroll
            for (int u = 0; u < kMaxK / 32; ++u) {
              const int j = lane + 32 * u;
              if (j >= pos && j < k - 1) {
                sv[u] = nv_s[j];
                si[u] = ni_s[j];
              }
            }
            __syncwarp();
#pragma unroll
            for (int u = 0; u < kMaxK / 32; ++u) {
              const int j = lane + 32 * u;
              if (j >= pos && j < k - 1) {
                nv_s[j + 1] = sv[u];
                ni_s[j + 1] = si[u];
              }
            }
            if (lane == 0) {
              nv_s[pos] = nv;
              ni_s[pos] = ni;
            }
            __syncwarp();
            if (lane == src) pred = false;
            pred = pred && beats(l, v, nv_s[k - 1], ni_s[k - 1]);
            want = __ballot_sync(kFull, pred);
          }
        }
        if (flush) {
          // the list and stats of x row n0 + n (only this warp touches
          // them), as K3b's blocks write theirs below; then empty
          __syncwarp();
          const size_t row = (size_t)(t / span) * a.N + n0 + n;
          for (int j = lane; j < k; j += 32) {
            a.cand_val[row * k + j] = nv_s[j];
            a.cand_idx[row * k + j] = ni_s[j];
            nv_s[j] = -INFINITY;
            ni_s[j] = kNoId;
          }
          float mm = m[qn], ss = se[qn];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            const float m2 = __shfl_xor_sync(kFull, mm, o), s2 = __shfl_xor_sync(kFull, ss, o);
            const float mx = fmaxf(mm, m2);
            ss = mx == -INFINITY ? 0.f : ss * expf(mm - mx) + s2 * expf(m2 - mx);
            mm = mx;
          }
          if (lane == 0) {
            a.blk_max[row] = mm;
            a.blk_se[row] = ss;
          }
          m[qn] = -INFINITY;
          se[qn] = 0.f;
          __syncwarp();
        }
      }
      hopper::named_sync(1, kWarps * 32);   // red is read
    }

    // ---- K3b: the block's lists and stats of the warp's x rows
    if constexpr (!kPerTile) {
#pragma unroll
      for (int qn = 0; qn < NPW; ++qn) {
        const int n = warp + kWarps * qn;
        if (n >= NP || n0 + n >= a.N) break;
        const size_t row = (size_t)blk * a.N + n0 + n;
        for (int j = lane; j < k; j += 32) {
          a.cand_val[row * k + j] = lv[n * k + j];
          a.cand_idx[row * k + j] = li[n * k + j];
        }
        float mm = m[qn], ss = se[qn];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const float m2 = __shfl_xor_sync(kFull, mm, o), s2 = __shfl_xor_sync(kFull, ss, o);
          const float mx = fmaxf(mm, m2);
          ss = mx == -INFINITY ? 0.f : ss * expf(mm - mx) + s2 * expf(m2 - mx);
          mm = mx;
        }
        if (lane == 0) {
          a.blk_max[row] = mm;
          a.blk_se[row] = ss;
        }
      }
    }
  }
}

// Stage 2: one block per x row n, over G lists (K3b: the stream's blocks;
// K3a: its tiles). The block caches the lists' first C
// entries in shared memory and combines the stats into logz; then warp 0
// takes k rounds: lane l keeps the best head of the lists l, l + 32, ...,
// the warp's best is the round's pick, and its lane advances that list and
// finds its next best.
__global__ void __launch_bounds__(kSelectThreads)
vocab_select_kernel(const float* __restrict__ cand_val, const int32_t* __restrict__ cand_idx,
                    const float* __restrict__ blk_max, const float* __restrict__ blk_se,
                    int N, int G, int k, float* __restrict__ top_vals,
                    int32_t* __restrict__ top_idx, float* __restrict__ logz) {
  constexpr int kW = kSelectThreads / 32;
  __shared__ float red[kW];
  __shared__ float shared_m;
  __shared__ float cache_v[kSelectCache];
  __shared__ int cache_i[kSelectCache];
  __shared__ float hv[kMaxLists];   // the value and id at each list's head
  __shared__ int hi[kMaxLists], head[kMaxLists];
  const int n = blockIdx.x, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int C = min(k, kSelectCache / G);

  // ---- the lists' stats (in registers: list tid + 256 u) and their first C
  // entries, every load in flight at once
  constexpr int S = kMaxLists / kSelectThreads;
  float stat_m[S], stat_s[S];
  float lm = -INFINITY;
#pragma unroll
  for (int u = 0; u < S; ++u) {
    const int g = tid + kSelectThreads * u;
    stat_m[u] = -INFINITY;
    stat_s[u] = 0.f;
    if (g < G) {
      stat_m[u] = blk_max[(size_t)g * N + n];
      stat_s[u] = blk_se[(size_t)g * N + n];
    }
    lm = fmaxf(lm, stat_m[u]);
  }
  {
    constexpr int U = kSelectCache / kSelectThreads;
    float v[U];
    int ix[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = tid + kSelectThreads * u;
      if (e < G * C) {
        const int g = e / C;
        const size_t o = ((size_t)g * N + n) * k + (e - g * C);
        v[u] = cand_val[o];
        ix[u] = cand_idx[o];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = tid + kSelectThreads * u;
      if (e < G * C) {
        cache_v[e] = v[u];
        cache_i[e] = ix[u];
      }
    }
  }
  // ---- logz = M + log sum_g se_g exp(m_g - M)
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) lm = fmaxf(lm, __shfl_xor_sync(kFull, lm, o));
  if (lane == 0) red[warp] = lm;
  __syncthreads();
  if (tid == 0) {
    float mm = -INFINITY;
    for (int w = 0; w < kW; ++w) mm = fmaxf(mm, red[w]);
    shared_m = mm;
  }
  __syncthreads();
  const float M = shared_m;
  float ls = 0.f;
#pragma unroll
  for (int u = 0; u < S; ++u)
    if (stat_m[u] != -INFINITY) ls += stat_s[u] * expf(stat_m[u] - M);
  for (int g = tid; g < G; g += kSelectThreads) {
    head[g] = 0;
    hv[g] = cache_v[g * C];
    hi[g] = cache_i[g * C];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ls += __shfl_xor_sync(kFull, ls, o);
  __syncthreads();   // red is read above
  if (lane == 0) red[warp] = ls;
  __syncthreads();
  if (tid == 0) {
    float ss = 0.f;
    for (int w = 0; w < kW; ++w) ss += red[w];
    logz[n] = M + logf(ss);
  }
  if (warp != 0) return;

  // ---- the top k of the blocks' sorted lists
  float bv = -INFINITY;   // the lane's best head: value, id, list
  int bi = kNoId, bg = -1;
  const auto rescan = [&]() {
    bv = -INFINITY;
    bi = kNoId;
    bg = -1;
    for (int g = lane; g < G; g += 32) {
      const float v = hv[g];
      const int i = hi[g];
      if (bg < 0 || beats(v, i, bv, bi)) {
        bv = v;
        bi = i;
        bg = g;
      }
    }
  };
  rescan();
  for (int j = 0; j < k; ++j) {
    float cv = bv;
    int ci = bi, cl = lane;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kFull, cv, o);
      const int oi = __shfl_xor_sync(kFull, ci, o), ol = __shfl_xor_sync(kFull, cl, o);
      if (beats(ov, oi, cv, ci) || (ov == cv && oi == ci && ol < cl)) {
        cv = ov;
        ci = oi;
        cl = ol;
      }
    }
    if (lane == 0) {
      top_vals[(size_t)n * k + j] = cv;
      top_idx[(size_t)n * k + j] = ci;
    }
    if (lane == cl) {
      const int h = ++head[bg];
      float v = -INFINITY;
      int i = kNoId;
      if (h < C) {
        v = cache_v[bg * C + h];
        i = cache_i[bg * C + h];
      } else if (h < k) {
        const size_t o = ((size_t)bg * N + n) * k + h;
        v = cand_val[o];
        i = cand_idx[o];
      }
      hv[bg] = v;
      hi[bg] = i;
      rescan();
    }
    __syncwarp();
  }
}

template <int NP, bool kPerTile>
int launch_stream(const CUtensorMap& map, const Args& a, int G, cudaStream_t st) {
  const size_t bytes = smem_bytes(NP, a.Dp, a.k);
  static size_t allowed = 0;   // the shared memory allowed so far
  if (bytes > allowed) {
    const cudaError_t err = hopper::allow_smem(vocab_stream_kernel<NP, kPerTile>, bytes);
    if (err != cudaSuccess) return (int)err;
    allowed = bytes;
  }
  vocab_stream_kernel<NP, kPerTile><<<G, kThreads, bytes, st>>>(map, a);
  return (int)cudaGetLastError();
}

// blocks of the stream kernel that fit on the card at once (at most `tiles`
// and kMaxBlocks), or a negative CUDA error
template <int NP>
int grid_of(int Dp, int k, int tiles) {
  const size_t bytes = smem_bytes(NP, Dp, k);
  cudaError_t err = hopper::allow_smem(vocab_stream_kernel<NP, false>, bytes);
  int per_sm = 0, dev = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vocab_stream_kernel<NP, false>,
                                                        kThreads, bytes);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  int g = per_sm * sms;
  if (g > tiles) g = tiles;
  return g < kMaxBlocks ? g : kMaxBlocks;
}

#define STREAM_NP_CASES(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12)

int dispatch_grid(int np, int Dp, int k, int tiles) {
  switch (np) {
#define CASE(P) case P: return grid_of<P>(Dp, k, tiles);
    STREAM_NP_CASES(CASE)
#undef CASE
    default: return -(int)cudaErrorInvalidValue;
  }
}

int dispatch_stream(int np, const CUtensorMap& map, const Args& a, int G, cudaStream_t st) {
  switch (np) {
#define CASE(P)                                                    \
  case P:                                                          \
    return a.span ? launch_stream<P, true>(map, a, G, st)          \
                  : launch_stream<P, false>(map, a, G, st);
    STREAM_NP_CASES(CASE)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

bool valid_shape(int N, int D, int V, int k) {
  const int Dp = (D + kSlice - 1) / kSlice * kSlice;
  return N >= 1 && D >= 16 && D % 16 == 0 && Dp <= kMaxXFloats && V >= 1 && k >= 1 &&
         k <= kMaxK && k <= V;
}

}  // namespace stream

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x). x (N, D) contiguous, table (V, D)
// int8 (16-byte aligned) and row_scale (V,) f32 on the card; 1 <= k <= 128,
// D a multiple of 16 up to 16384.

// The grid of vocab_topk_v2 at these sizes: the blocks that fit on the card
// at once, at most one a 128-row tile and 1024; negative: a CUDA error.
int vocab_topk_v2_grid(int N, int D, int V, int k) {
  if (!stream::valid_shape(N, D, V, k)) return -(int)cudaErrorInvalidValue;
  const int Dp = (D + stream::kSlice - 1) / stream::kSlice * stream::kSlice;
  const int tiles = (V + stream::kRows - 1) / stream::kRows;
  return stream::dispatch_grid(stream::rows_a_pass(N, Dp, k), Dp, k, tiles);
}

// The stream with G blocks over units of `span` 128-row tiles (span 0: K3b,
// a unit is a tile and a block writes one list): block g takes the units
// [g U / G, (g + 1) U / G) of the U = ceil(T / max(span, 1)), T = ceil(V /
// 128); lists of k best (value, id), sorted (value descending, id
// ascending), and (max, sum of exp) per x row.
static int stream_launch(int dtype, const void* x, const int8_t* table,
                         const float* row_scale, int N, int D, int V, int k, int span,
                         int G, float* cand_val, int32_t* cand_idx, float* blk_max,
                         float* blk_se, void* st) {
  if (!stream::valid_shape(N, D, V, k) || (dtype != 0 && dtype != 1) || G < 1 ||
      G > stream::kMaxBlocks || span < 0)
    return (int)cudaErrorInvalidValue;
  const int Dp = (D + stream::kSlice - 1) / stream::kSlice * stream::kSlice;
  const int tiles = (V + stream::kRows - 1) / stream::kRows;
  const int unit = span ? span : 1;
  if (G > (tiles + unit - 1) / unit) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const cudaError_t err = hopper::make_map_u8(&map, table, D, V, D, stream::kRows);
  if (err != cudaSuccess) return (int)err;
  const stream::Args a{x, dtype, row_scale, N, D, Dp, V, k, tiles, span,
                       cand_val, cand_idx, blk_max, blk_se};
  return stream::dispatch_stream(stream::rows_a_pass(N, Dp, k), map, a, G,
                                 static_cast<cudaStream_t>(st));
}

// K3b stage 1 with G blocks (vocab_topk_v2_grid's): each block's list and
// stats of its rows, cand_val (G, N, k) f32, cand_idx (G, N, k) int32,
// blk_max and blk_se (G, N) f32. Block g takes the 128-row tiles [g T / G,
// (g + 1) T / G). Launches on `stream` and returns cudaGetLastError() as an
// int (0 = launched).
int vocab_topk_v2(int dtype, const void* x, const int8_t* table, const float* row_scale,
                  int N, int D, int V, int k, int G, float* cand_val, int32_t* cand_idx,
                  float* blk_max, float* blk_se, void* stream) {
  return stream_launch(dtype, x, table, row_scale, N, D, V, k, 0, G, cand_val, cand_idx,
                       blk_max, blk_se, stream);
}

// K3a stage 1 with G blocks (at most vocab_topk_v2_grid's and the tiles):
// each K3a tile's list and stats, over tiles of `tile` rows (a multiple of
// 128, k <= tile; the last tile cut at V): tile_val (L, N, k) f32, tile_idx
// (L, N, k) int32, tile_max and tile_se (L, N) f32, L = ceil(V / tile).
int vocab_topk(int dtype, const void* x, const int8_t* table, const float* row_scale,
               int N, int D, int V, int k, int tile, int G, float* tile_val,
               int32_t* tile_idx, float* tile_max, float* tile_se, void* stream) {
  if (tile < stream::kRows || tile % stream::kRows || k > tile ||
      (V + tile - 1) / tile > stream::kMaxLists)
    return (int)cudaErrorInvalidValue;
  return stream_launch(dtype, x, table, row_scale, N, D, V, k, tile / stream::kRows, G,
                       tile_val, tile_idx, tile_max, tile_se, stream);
}

// Stage 2 of both: the G lists and stats (G <= 2048) -> top_vals (N, k) f32,
// top_idx (N, k) int32, logz (N,) f32.
int vocab_topk_v2_select(int N, int G, int k, const float* cand_val,
                         const int32_t* cand_idx, const float* blk_max,
                         const float* blk_se, float* top_vals, int32_t* top_idx,
                         float* logz, void* stream) {
  if (N < 1 || G < 1 || G > stream::kMaxLists || k < 1 || k > stream::kMaxK)
    return (int)cudaErrorInvalidValue;
  stream::vocab_select_kernel<<<N, stream::kSelectThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      cand_val, cand_idx, blk_max, blk_se, N, G, k, top_vals, top_idx, logz);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
