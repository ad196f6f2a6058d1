// The decode-attention step shared by K1 (decode_attention.cu, int8 rows),
// K2 (decode_attention_int4.cu, packed-int4 rows) and K5
// (decode_attention_indexed.cu, int8 rows read through a row-origin table):
// beam gather, insert of the quantized current row, and causal attention
// over the cache and the current row, for one layer of one decode step
// (Hopper, sm_90a).
//
// For each (b, h), with s = src[b] the beam this row continues:
//   logit[t] = (q . k[s,h,t]) * k_scale[s,h,t] / sqrt(Dh)        for t < step
//   lcur     = (q . k_t) / sqrt(Dh)                  (current row, unquantized)
//   m = max(NEG, logit[t<step], lcur), p[t] = exp(logit[t] - m), pc = exp(lcur - m)
//   out = (sum_t round_dtype(p[t] * v_scale[s,h,t]) * v[s,h,t] + pc * v_t)
//         / (sum_t p[t] + pc)
//   new_k[b,h] = k[s,h] with row `step` replaced by quantize(k_t), the same
//   for v and for the scales; quantize(x) = clip(rint(x / sc), -L, L) with
//   sc = max(absmax(x) / L, 1e-8), true fp32 division, L = 127 (int8) or 7
//   (int4).
//
// Design. The rows of one (b, h) are split over a thread-block cluster of
// `cluster` blocks (1, 2, 4 or 8, chosen by the host from B*H and T), each
// owning a slice of `slice_rows` rows. A block of 128 threads:
//   1. One thread starts every copy at once: its slice of k, then of v, in
//      tiles of `tile_rows` rows through a ring of `stages` shared-memory
//      slots, each a 1-d bulk copy (TMA) completing on the slot's mbarrier.
//      When the slice fits in the ring (every main-path shape), all of its
//      bytes are in flight from the first microsecond. Meanwhile warp 0
//      quantizes the current row and the other warps copy the slice's
//      scales (into shared memory and to the new scale rows).
//   2. As a tile lands, the same thread patches row `step` in shared memory
//      and starts the bulk store of the tile to new_k / new_v; the threads
//      form the logits from shared memory (a row per group of lanes, one
//      16-value chunk a lane, shuffles within the group). A longer slice
//      refills each slot once its tile is consumed and stored.
//   3. The cluster exchanges the blocks' maxima through distributed shared
//      memory (one cluster barrier), so every block weights its rows with
//      the global max, exactly as the plain version does.
//   4. The v tiles: each lane accumulates its 16 columns over its rows. The
//      block's partial sums (value accumulator and softmax denominator) go
//      to block 0 of the cluster through distributed shared memory (a second
//      cluster barrier), which adds them in rank order and writes `out`.
// Row bytes that are not a multiple of 16 (packed int4 at Dh = 16, 48, ...,
// where a slab may start 8 bytes off a 16-byte line) cannot take bulk
// copies: there (`kBulk` false) every thread copies 8-byte words with
// cp.async, arriving on the same mbarriers, and stores them itself. The
// exchanges are st.async writes into the other blocks' shared memory, each
// counted on the receiving block's mbarrier; the only cluster barrier is the
// one that says every block has initialised its mbarriers.
//
// K5, the lazy beam reorder (the `RowOrigin` policy): row t of logical beam
// b lives in physical slot s = row_src[b, t], the same arithmetic with
// k[s,h,t], k_scale[s,h,t], v[s,h,t] and v_scale[s,h,t], and nothing is
// written but `out` (the caller inserts the new row; rows t >= step are not
// read). Each block loads its slice of row_src into shared memory once;
// rows of one tile come from different slots, so every thread copies 16-byte
// chunks of the tile's rows with cp.async, arriving on the slot's mbarrier
// (the `kBulk` false path; a bulk copy a row, tried by `chip_smoke.py
// --k5-trace`, was slower at every cluster size); the current row is not
// quantized and no slab is stored. The split, the exchanges and so the
// rounding are K1's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

// A library that loads beside another one built from this header names its
// own namespace: two libraries of one process that define a kernel of the
// same name make the second's cluster launches fail.
#ifndef DECODE_STEP_NS
#define DECODE_STEP_NS decode_step
#endif

namespace DECODE_STEP_NS {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDh = 256;
constexpr int kMaxCluster = 8;
constexpr int kMaxStages = 16;
constexpr int kSlotAlign = 128;
constexpr int kSmemBudget = 200 * 1024;  // dynamic shared memory of a block
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
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The float of byte k of `w`, each byte an unsigned u in [0, 256): 2^23 + u
// read as a float, less `bias` (2^23 plus the offset u carries). Exact, and
// one byte permute and one add, where an int-to-float conversion runs at a
// quarter of the rate.
__device__ __forceinline__ float byte_f32(uint32_t w, int k, float bias) {
  return __int_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | k)) - bias;
}

__device__ __forceinline__ int clip_rint(float x, float scale, float levels) {
  return static_cast<int>(fminf(fmaxf(rintf(x / scale), -levels), levels));
}

// int8 rows: Dh bytes, a lane's chunk is 16 bytes = columns 16 g .. 16 g + 15
struct Int8Rows {
  using Chunk = uint4;
  static constexpr int kChunkBytes = 16;
  static constexpr float kLevels = 127.f;
  __host__ __device__ static int row_bytes(int dh) { return dh; }
  __device__ static int col(int g, int j, int) { return g * 16 + j; }
  __device__ static void decode(const Chunk& c, float (&v)[16]) {
    const uint32_t w[4] = {c.x ^ 0x80808080u, c.y ^ 0x80808080u, c.z ^ 0x80808080u,
                           c.w ^ 0x80808080u};  // signed x -> x + 128
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) v[4 * i + k] = byte_f32(w[i], k, 8388736.f);
  }
  // the current row, quantized, from its Dh floats in shared memory
  __device__ static void quantize_row(int8_t* dst, const float* x, float scale, int dh,
                                      int lane) {
    for (int d = lane; d < dh; d += 32)
      dst[d] = static_cast<int8_t>(clip_rint(x[d], scale, kLevels));
  }
};

// packed int4 rows: Dh/2 bytes in split-half order (byte j: value j in the
// low nibble, value j + Dh/2 in the high one); a lane's chunk is 8 bytes =
// columns 8 g .. 8 g + 7 (low nibbles) and Dh/2 + 8 g .. Dh/2 + 8 g + 7
struct Int4Rows {
  using Chunk = uint2;
  static constexpr int kChunkBytes = 8;
  static constexpr float kLevels = 7.f;
  __host__ __device__ static int row_bytes(int dh) { return dh / 2; }
  __device__ static int col(int g, int j, int dh) {
    return j < 8 ? g * 8 + j : dh / 2 + g * 8 + (j - 8);
  }
  __device__ static void decode(const Chunk& c, float (&v)[16]) {
    const uint32_t w[2] = {c.x, c.y};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // sign-extended nibble x -> x + 8
      const uint32_t lo = (w[i] & 0x0F0F0F0Fu) ^ 0x08080808u;
      const uint32_t hi = ((w[i] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[4 * i + k] = byte_f32(lo, k, 8388616.f);
        v[8 + 4 * i + k] = byte_f32(hi, k, 8388616.f);
      }
    }
  }
  __device__ static void quantize_row(int8_t* dst, const float* x, float scale, int dh,
                                      int lane) {
    const int half = dh / 2;
    for (int j = lane; j < half; j += 32) {
      const int lo = clip_rint(x[j], scale, kLevels);
      const int hi = clip_rint(x[j + half], scale, kLevels);
      dst[j] = static_cast<int8_t>(static_cast<uint8_t>((lo & 0xF) | ((hi & 0xF) << 4)));
    }
  }
};

// Where a (b, h)'s rows come from. K1, K2: every row from the slot of the
// beam it continues, src[b] (B,), the slabs copied whole and stored to the
// new caches with row `step` replaced. K5: row t from slot row_src[b, t]
// (`src` is the (B, T) table), no cache written.
struct BeamOrigin {
  static constexpr bool kIndexed = false;
};
struct RowOrigin {
  static constexpr bool kIndexed = true;
};

struct Params {
  const void* q;
  const void* k_t;
  const void* v_t;
  const int8_t* k_cache;
  const int8_t* v_cache;
  const float* k_scale;
  const float* v_scale;
  const int32_t* src;
  void* out;
  int8_t* new_k;
  int8_t* new_v;
  float* new_ks;
  float* new_vs;
  int H, T, Dh, step;
  float sqrt_dh;
  int cluster, slice_rows, tile_rows, stages;
};

__host__ __device__ inline size_t slot_bytes(int tile_rows, int row_bytes) {
  return ((size_t)tile_rows * row_bytes + kSlotAlign - 1) / kSlotAlign * kSlotAlign;
}

// dynamic shared memory of a block: the ring, then the slice's k-scale
// (logit, weight) and v-scale rows, and (K5) its rows' slots
__host__ __device__ inline size_t smem_bytes(const Params& p, int row_bytes, bool indexed) {
  return p.stages * slot_bytes(p.tile_rows, row_bytes) +
         (indexed ? 3 : 2) * sizeof(float) * p.slice_rows;
}

template <class Origin, class Rows, typename T, bool kBulk>
__global__ void __launch_bounds__(kThreads) decode_step_kernel(const __grid_constant__ Params p) {
  constexpr bool kIndexed = Origin::kIndexed;
  static_assert(!(kIndexed && kBulk), "K5 copies its rows with cp.async");
  extern __shared__ __align__(kSlotAlign) unsigned char smem[];
  __shared__ __align__(16) float q_s[kMaxDh];
  __shared__ __align__(16) float vt_s[kMaxDh];
  __shared__ __align__(16) int8_t kq_s[kMaxDh];  // the current row, quantized
  __shared__ __align__(16) int8_t vq_s[kMaxDh];
  __shared__ __align__(16) float red_s[kWarps][kMaxDh];        // warps' value partials
  __shared__ __align__(16) float part_s[kMaxCluster][kMaxDh];  // rank 0: blocks' partials
  __shared__ float den_s[kMaxCluster], max_s[kMaxCluster];
  __shared__ float wred_s[kWarps];
  __shared__ float lcur_s;
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ __align__(8) uint64_t max_bar, part_bar;  // the cluster's exchanges

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = p.cluster;
  const int rank = c > 1 ? (int)hopper::cluster_rank() : 0;
  const int h = blockIdx.x / c, b = blockIdx.y;
  const int H = p.H, T_len = p.T, Dh = p.Dh, step = p.step;
  const int rb = Rows::row_bytes(Dh);
  const size_t bh = (size_t)b * H + h;
  const int r0 = min(T_len, rank * p.slice_rows);
  const int n_rows = min(T_len, r0 + p.slice_rows) - r0;
  const int tile_rows = p.tile_rows, stages = p.stages;
  const int n_half = (n_rows + tile_rows - 1) / tile_rows;  // k tiles, = v tiles
  const int n_tiles = 2 * n_half;
  const size_t slot = slot_bytes(tile_rows, rb);
  unsigned char* ring = smem;
  float* w_s = reinterpret_cast<float*>(smem + stages * slot);  // k scale, logit, weight
  float* vs_s = w_s + p.slice_rows;
  int* rs_s = reinterpret_cast<int*>(vs_s + p.slice_rows);       // K5: the rows' slots

  // One producer thread, lane 0 of warp 1, initialises the ring's barriers
  // before it has a load in flight, then issues every copy as soon as it
  // has the origin; warp 0 meanwhile takes the current row.
  const bool producer = tid == 32;
  if (producer) {
    for (int i = 0; i < stages; ++i) hopper::mbar_init(&full[i], kBulk ? 1 : kThreads);
    hopper::fence_proxy_async_smem();  // the barriers, to the bulk copies
  }
  // the origin: K1, K2 the beam this (b, h) continues; K5 the slot of every
  // row of the slice, loaded once (the barrier before the copies orders it)
  const int s = kIndexed ? 0 : __ldg(p.src + b);
  if constexpr (kIndexed)
    for (int t = tid; t < n_rows; t += kThreads)
      rs_s[t] = __ldg(p.src + (size_t)b * T_len + r0 + t);
  const T* qg = static_cast<const T*>(p.q) + bh * Dh;
  const T* kg = static_cast<const T*>(p.k_t) + bh * Dh;
  const T* vg = static_cast<const T*>(p.v_t) + bh * Dh;
  constexpr int kPer = kMaxDh / 32;
  float qd[kPer], kd[kPer], vd[kPer];
  if (warp == 0)
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int d = lane + 32 * u;
      if (d < Dh) {
        qd[u] = to_f32<T>(qg[d]);
        kd[u] = to_f32<T>(kg[d]);
        vd[u] = to_f32<T>(vg[d]);
      }
    }

  const size_t sbh = (size_t)s * H + h;
  const size_t src_row = sbh * T_len + r0, dst_row = bh * T_len + r0;

  // the row of slice row t in the cache and scales (K5: of its own slot)
  auto row_of = [&](int t) -> size_t {
    if constexpr (kIndexed)
      return ((size_t)rs_s[t] * H + h) * T_len + r0 + t;
    else
      return src_row + t;
  };

  // tile i: k rows for i < n_half, then v rows; slice rows [t0, t0 + nr)
  auto tile_rows_of = [&](int i, int& t0) {
    t0 = (i < n_half ? i : i - n_half) * tile_rows;
    return min(tile_rows, n_rows - t0);
  };
  auto load_tile = [&](int i) {
    int t0;
    const int nr = tile_rows_of(i, t0);
    const int8_t* g = (i < n_half ? p.k_cache : p.v_cache) + (src_row + t0) * rb;
    unsigned char* dst = ring + (i % stages) * slot;
    uint64_t* bar = &full[i % stages];
    if constexpr (kIndexed) {
      // each row from its own slot: 16-byte chunks, every thread arriving
      const int8_t* cache = i < n_half ? p.k_cache : p.v_cache;
      const int cpr = rb / 16;
      for (int w = tid; w < nr * cpr; w += kThreads) {
        const int r = w / cpr, k = w - r * cpr;
        hopper::cp_async_16(dst + r * rb + 16 * k, cache + row_of(t0 + r) * rb + 16 * k);
      }
      hopper::cp_async_arrive_noinc(bar);
    } else if constexpr (kBulk) {
      hopper::mbar_arrive_expect_tx(bar, nr * rb);
      hopper::bulk_load(dst, g, nr * rb, bar);
    } else {
      for (int w = tid; w < nr * rb / 8; w += kThreads) hopper::cp_async_8(dst + 8 * w, g + 8 * w);
      hopper::cp_async_arrive_noinc(bar);
    }
  };
  // the tile in slot, row `step` replaced by `patch`, to new_k / new_v
  auto store_tile = [&](int i, unsigned char* tile, const int8_t* patch) {
    if constexpr (kIndexed) return;  // K5 writes no cache
    int t0;
    const int nr = tile_rows_of(i, t0);
    int8_t* g = (i < n_half ? p.new_k : p.new_v) + (dst_row + t0) * rb;
    const int at = step - r0 - t0;  // row of `step` in this tile, if any
    if constexpr (kBulk) {
      if (producer) {
        if (at >= 0 && at < nr)
          for (int j = 0; j < rb / 16; ++j)
            reinterpret_cast<uint4*>(tile + at * rb)[j] = reinterpret_cast<const uint4*>(patch)[j];
        hopper::fence_proxy_async_smem();
        hopper::bulk_store(g, tile, nr * rb);
        hopper::bulk_commit();
      }
    } else {
      const int words = rb / 8;
      for (int w = tid; w < nr * words; w += kThreads) {
        const int r = w / words;
        reinterpret_cast<uint2*>(g)[w] =
            r == at ? reinterpret_cast<const uint2*>(patch)[w - r * words]
                    : reinterpret_cast<const uint2*>(tile)[w];
      }
    }
  };
  // after tile i: its slot takes tile i + stages, once read and stored
  auto refill = [&](int i) {
    if (i + stages >= n_tiles) return;
    __syncthreads();
    if constexpr (kBulk) {
      if (producer) {
        hopper::bulk_wait_read<0>();
        load_tile(i + stages);
      }
    } else {
      load_tile(i + stages);
    }
  };

  if constexpr (kBulk) {
    if (producer)
      for (int i = 0; i < min(stages, n_tiles); ++i) load_tile(i);
  } else {
    __syncthreads();  // the barriers are initialised
    for (int i = 0; i < min(stages, n_tiles); ++i) load_tile(i);
  }
  // the exchanges' barriers, off the copies' path: block 0 receives
  // every block's partials, every block every block's max
  if (producer && c > 1) {
    hopper::mbar_init(&max_bar, 1);
    hopper::mbar_arrive_expect_tx(&max_bar, c * sizeof(float));
    if (rank == 0) {
      hopper::mbar_init(&part_bar, 1);
      hopper::mbar_arrive_expect_tx(&part_bar, c * (Dh + 1) * sizeof(float));
    }
    hopper::fence_barrier_init();
  }
  if (c > 1) hopper::cluster_arrive_relaxed();  // this block's barriers are ready

  if (warp == 0) {
    // the current row: lcur and its quantized k and v rows
    float amax_k = 0.f, amax_v = 0.f, dot = 0.f;
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      if (lane + 32 * u < Dh) {
        amax_k = fmaxf(amax_k, fabsf(kd[u]));
        amax_v = fmaxf(amax_v, fabsf(vd[u]));
        dot += qd[u] * kd[u];
      }
    amax_k = warp_max(amax_k);
    amax_v = warp_max(amax_v);
    dot = warp_sum(dot);
    const float sk = fmaxf(amax_k / Rows::kLevels, 1e-8f);
    const float sv = fmaxf(amax_v / Rows::kLevels, 1e-8f);
    // the quantized rows go through shared memory as floats: the int4 row
    // pairs column j with column j + Dh/2
    float* kt_s = red_s[0];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int d = lane + 32 * u;
      if (d < Dh) {
        q_s[d] = qd[u];
        kt_s[d] = kd[u];
        vt_s[d] = vd[u];
      }
    }
    __syncwarp();
    if constexpr (!kIndexed) {
      Rows::quantize_row(kq_s, kt_s, sk, Dh, lane);
      Rows::quantize_row(vq_s, vt_s, sv, Dh, lane);
    }
    if (lane == 0) {
      lcur_s = dot / p.sqrt_dh;
      if (!kIndexed && step >= r0 && step < r0 + n_rows) {
        p.new_ks[bh * T_len + step] = sk;
        p.new_vs[bh * T_len + step] = sv;
      }
    }
  } else {
    // the slice's scales: into shared memory and out to the new scale rows,
    // 8 rows a thread in flight at once
    constexpr int kU = 8, kStride = kThreads - 32;
    for (int t0 = tid - 32; t0 < n_rows; t0 += kU * kStride) {
      float ks[kU], vs[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int t = t0 + u * kStride;
        if (t < n_rows) {
          ks[u] = __ldg(p.k_scale + row_of(t));
          vs[u] = __ldg(p.v_scale + row_of(t));
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int t = t0 + u * kStride;
        if (t < n_rows) {
          w_s[t] = ks[u];
          vs_s[t] = vs[u];
          if (!kIndexed && r0 + t != step) {
            p.new_ks[dst_row + t] = ks[u];
            p.new_vs[dst_row + t] = vs[u];
          }
        }
      }
    }
  }
  __syncthreads();

  const float lcur = lcur_s;
  // a group of G lanes (G = chunks a row, to a power of two) takes a row,
  // lane g of the group the 16 values of chunk g
  const int chunks = Dh / 16;
  int G = 1;
  while (G < chunks) G <<= 1;
  const int per = 32 / G, g = lane % G, rl = lane / G;
  const bool active = g < chunks;
  float qr[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) qr[j] = active ? q_s[Rows::col(g, j, Dh)] : 0.f;

  // ---- k tiles: (q . k) * k_scale of rows t < step; the division by
  // sqrt(Dh), monotonic, waits for the softmax pass
  float mloc = -INFINITY;
  for (int i = 0; i < n_half; ++i) {
    unsigned char* tile = ring + (i % stages) * slot;
    hopper::mbar_wait(&full[i % stages], (i / stages) & 1);
    store_tile(i, tile, kq_s);
    int t0;
    const int lim = min(tile_rows_of(i, t0), step - r0 - t0);  // rows to attend
    // two rows a lane group at once, both loads in flight
    constexpr int kRows = 2;
    for (int rr = warp * per; rr < lim; rr += kRows * kWarps * per) {
      typename Rows::Chunk ch[kRows];
      float acc[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int r = rr + k * kWarps * per + rl;
        if (active && r < lim)
          ch[k] = *reinterpret_cast<const typename Rows::Chunk*>(tile + r * rb +
                                                                 g * Rows::kChunkBytes);
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int r = rr + k * kWarps * per + rl;
        acc[k] = 0.f;
        if (active && r < lim) {
          float v[16];
          Rows::decode(ch[k], v);
          float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int j = 0; j < 16; ++j) a[j & 3] += qr[j] * v[j];
          acc[k] = (a[0] + a[1]) + (a[2] + a[3]);
        }
      }
      for (int o = 1; o < G; o <<= 1)
#pragma unroll
        for (int k = 0; k < kRows; ++k) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], o);
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int r = rr + k * kWarps * per + rl;
        if (g == 0 && r < lim) {
          const float l = acc[k] * w_s[t0 + r];
          w_s[t0 + r] = l;
          mloc = fmaxf(mloc, l);
        }
      }
    }
    refill(i);
  }

  // ---- the max over the cluster's rows and the current row -----------------
  mloc = warp_max(mloc);
  if (lane == 0) wred_s[warp] = mloc;
  __syncthreads();
  float m = wred_s[0];
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, wred_s[w]);
  m /= p.sqrt_dh;  // the largest logit: correctly rounded division is monotonic
  if (c > 1) {
    hopper::cluster_wait();  // every block of the cluster has its barriers ready
    if (tid < c) hopper::st_async(&max_s[rank], tid, m, &max_bar);
    hopper::mbar_wait<true>(&max_bar, 0);
    m = max_s[0];
    for (int j = 1; j < c; ++j) m = fmaxf(m, max_s[j]);
  }
  m = fmaxf(fmaxf(m, kNeg), lcur);

  // ---- softmax numerators, scaled by v_scale and rounded to the model dtype
  float dloc = 0.f;
  const int n_att = min(n_rows, step - r0);
  for (int t = tid; t < n_att; t += kThreads) {
    const float pr = expf(w_s[t] / p.sqrt_dh - m);
    dloc += pr;
    w_s[t] = round_to<T>(pr * vs_s[t]);
  }
  __syncthreads();

  // ---- v tiles: each lane sums its 16 columns over its rows ----------------
  float acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0.f;
  for (int i = n_half; i < n_tiles; ++i) {
    unsigned char* tile = ring + (i % stages) * slot;
    hopper::mbar_wait(&full[i % stages], (i / stages) & 1);
    store_tile(i, tile, vq_s);
    int t0;
    const int lim = min(tile_rows_of(i, t0), step - r0 - t0);
    if (active)
      for (int r = warp * per + rl; r < lim; r += 2 * kWarps * per) {
        const int r2 = r + kWarps * per;
        const typename Rows::Chunk c1 = *reinterpret_cast<const typename Rows::Chunk*>(
            tile + r * rb + g * Rows::kChunkBytes);
        typename Rows::Chunk c2 = c1;
        const float w1 = w_s[t0 + r], w2 = r2 < lim ? w_s[t0 + r2] : 0.f;
        if (r2 < lim)
          c2 = *reinterpret_cast<const typename Rows::Chunk*>(tile + r2 * rb +
                                                              g * Rows::kChunkBytes);
        float v[16];
        Rows::decode(c1, v);
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[j] += w1 * v[j];
        Rows::decode(c2, v);
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[j] += w2 * v[j];
      }
    refill(i);
  }

  // ---- merge: row groups of a warp, warps of a block, blocks of a cluster --
  for (int o = G; o < 32; o <<= 1)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
  if (rl == 0 && active)
#pragma unroll
    for (int j = 0; j < 16; ++j) red_s[warp][Rows::col(g, j, Dh)] = acc[j];
  dloc = warp_sum(dloc);
  if (lane == 0) wred_s[warp] = dloc;  // its readers of the max are past a barrier
  __syncthreads();
  float den = 0.f;
  for (int w = 0; w < kWarps; ++w) den += wred_s[w];
  if (c > 1) {
    // each block's partials into block 0's part_s[rank], den_s[rank]
    for (int d = 4 * tid; d < Dh; d += 4 * kThreads) {
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int w = 0; w < kWarps; ++w) {
        const float4 x = *reinterpret_cast<const float4*>(&red_s[w][d]);
        o.x += x.x;
        o.y += x.y;
        o.z += x.z;
        o.w += x.w;
      }
      hopper::st_async4(&part_s[rank][d], 0, o, &part_bar);
    }
    if (tid == 0) hopper::st_async(&den_s[rank], 0, den, &part_bar);
    if (rank == 0) hopper::mbar_wait<true>(&part_bar, 0);
  }
  if (rank == 0) {
    const float pc = expf(lcur - m);
    if (c > 1) {
      den = den_s[0];
      for (int j = 1; j < c; ++j) den += den_s[j];
    }
    den += pc;
    T* out = static_cast<T*>(p.out) + bh * Dh;
    for (int d = tid; d < Dh; d += kThreads) {
      float o = 0.f;
      if (c > 1) {
        for (int j = 0; j < c; ++j) o += part_s[j][d];
      } else {
        for (int w = 0; w < kWarps; ++w) o += red_s[w][d];
      }
      out[d] = from_f32<T>((o + pc * vt_s[d]) / den);
    }
  }
  if constexpr (kBulk)
    if (producer) hopper::bulk_wait_read<0>();  // the stores have read the ring
}

// Checks the plan and launches on `stream` as a cluster of `p.cluster`
// blocks along x: grid (H * cluster, B).
template <class Origin, class Rows, typename T, bool kBulk>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(p, Rows::row_bytes(p.Dh), Origin::kIndexed);
  auto kernel = decode_step_kernel<Origin, Rows, T, kBulk>;
  // once: up to the whole budget (the launch's own size sets the occupancy)
  static const cudaError_t allowed = hopper::allow_smem(kernel, kSmemBudget);
  if (allowed != cudaSuccess) return allowed;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.H * p.cluster, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, p);
}

// dtype: 0 = float32, 1 = bfloat16. Returns a CUDA error code as an int (0 =
// launched); a plan the kernel does not take is cudaErrorInvalidConfiguration.
template <class Rows, class Origin = BeamOrigin>
int run(int dtype, const Params& p, int B, void* stream) {
  const int rb = Rows::row_bytes(p.Dh);
  const bool plan_ok =
      (p.cluster == 1 || p.cluster == 2 || p.cluster == 4 || p.cluster == 8) &&
      p.Dh % 16 == 0 && p.Dh > 0 && p.Dh <= kMaxDh && p.stages >= 1 &&
      p.stages <= kMaxStages && p.tile_rows >= 1 && p.slice_rows >= 1 &&
      (long long)p.slice_rows * p.cluster >= p.T && p.step >= 0 && p.step < p.T &&
      smem_bytes(p, rb, Origin::kIndexed) <= kSmemBudget;
  if (!plan_ok) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if constexpr (Origin::kIndexed) {
    // 16-byte chunks of each row: 16-byte rows and caches
    if (rb % 16 || reinterpret_cast<uintptr_t>(p.k_cache) % 16 ||
        reinterpret_cast<uintptr_t>(p.v_cache) % 16)
      return (int)cudaErrorInvalidValue;
    if (dtype == 0)
      err = launch<Origin, Rows, float, false>(p, B, st);
    else if (dtype == 1)
      err = launch<Origin, Rows, __nv_bfloat16, false>(p, B, st);
    else
      return (int)cudaErrorInvalidValue;
  } else {
    // bulk copies need 16-byte rows and 16-byte aligned caches
    const bool bulk = rb % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(p.k_cache) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(p.v_cache) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(p.new_k) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(p.new_v) % 16 == 0;
    if (dtype == 0)
      err = bulk ? launch<Origin, Rows, float, true>(p, B, st)
                 : launch<Origin, Rows, float, false>(p, B, st);
    else if (dtype == 1)
      err = bulk ? launch<Origin, Rows, __nv_bfloat16, true>(p, B, st)
                 : launch<Origin, Rows, __nv_bfloat16, false>(p, B, st);
    else
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace DECODE_STEP_NS
