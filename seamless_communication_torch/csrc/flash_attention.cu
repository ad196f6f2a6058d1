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
// One kernel per dtype, chosen by `dtype` in the C entry.
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
// fp32 (flash_attention_kernel): SIMT FMAs, no TF32, so the results stay
// those of the plain fp32 product. One block of 128 threads (4 warps) per
// (b, h, tile of 16 query rows), each warp owning 4 rows, which it computes
// together. The block stages each key tile of K and V (64 keys for Dh <= 64,
// 32 for Dh = 128) in shared memory as fp32, K's rows padded by 4 floats so
// that the 16-byte loads of 8 lanes reading 8 keys hit distinct banks. For
// q.k a lane owns
// keys (lane, lane + 32): each 16-byte K load serves the warp's 4 rows and
// each 16-byte q load is a broadcast, so 6 loads feed 32 FMAs (fp32, no
// TF32). The lane adds ab read from device memory (coalesced along the keys)
// and the segment mask compared in registers; warp shuffles reduce each
// row's maximum and sum. The rounded probabilities go to shared memory, and
// for p.v a lane owns output dimensions (lane, lane + 32): each V value
// serves the 4 rows. Every input byte is read once from device memory;
// ragged tails of Tq and Tk are masked in the kernel, so no operand is
// padded. Its bias rows are read by their stride.
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

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows of a block

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
// The bias's rows are `abt` apart (its last dimension contiguous).
struct Strides {
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt, abt;
};

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ ab,
                       const int32_t* __restrict__ q_seg,
                       const int32_t* __restrict__ kv_seg, Strides st, int H,
                       int Tq, int Tk, float mask_value, float* __restrict__ out,
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
  const float* qb = q + b * st.qb + h * st.qh;
  const float* kb = k + b * st.kb + h * st.kh;
  const float* vb = v + b * st.vb + h * st.vh;
  const size_t bh = (size_t)b * H + h;
  const bool seg = q_seg != nullptr;

  for (int idx = tid; idx < kRows * DH; idx += kThreads) {
    const int r = idx / DH, d = idx % DH, i = q0 + r;
    q_s[idx] = i < Tq ? (qb[i * st.qt + d]) : 0.f;
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
      k_s[j * LD + d] = ok ? (kb[key * st.kt + d]) : 0.f;
      v_s[idx] = ok ? (vb[key * st.vt + d]) : 0.f;
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
      const float* abr = (ab && live_row[r])
                         ? ab + (bh * Tq + q0 + row0 + r) * (size_t)st.abt + k0
                         : nullptr;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < KPL; ++c) {
        if (kok[c]) {
          float x = s[r][c];
          if (abr) x += (abr[lane + 32 * c]);
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
        p_s[warp][r][lane + 32 * c] = p;
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
      if (d < DH) out[(bh * Tq + i) * DH + d] = (acc[r][e] * inv);
    }
    if (m_out != nullptr && lane == 0) {
      m_out[bh * Tq + i] = m[r];
      l_out[bh * Tq + i] = l[r];
    }
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ab,
                   const int32_t* q_seg, const int32_t* kv_seg, Strides st, int B,
                   int H, int Tq, int Tk, float mask_value, void* out, float* m,
                   float* l, cudaStream_t stream) {
  const dim3 grid((Tq + kRows - 1) / kRows, H, B);
  flash_attention_kernel<DH><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(ab), q_seg, kv_seg, st, H,
      Tq, Tk, mask_value, static_cast<float*>(out), m, l);
  return cudaGetLastError();
}

// the fp32 SIMT kernel
cudaError_t dispatch(int Dh, const void* q, const void* k, const void* v,
                     const void* ab, const int32_t* q_seg, const int32_t* kv_seg,
                     Strides st, int B, int H, int Tq, int Tk, float mask_value,
                     void* out, float* m, float* l, cudaStream_t stream) {
  switch (Dh) {
    case 16:
      return launch<16>(q, k, v, ab, q_seg, kv_seg, st, B, H, Tq, Tk, mask_value, out, m,
                        l, stream);
    case 32:
      return launch<32>(q, k, v, ab, q_seg, kv_seg, st, B, H, Tq, Tk, mask_value, out, m,
                        l, stream);
    case 64:
      return launch<64>(q, k, v, ab, q_seg, kv_seg, st, B, H, Tq, Tk, mask_value, out, m,
                        l, stream);
    case 128:
      return launch<128>(q, k, v, ab, q_seg, kv_seg, st, B, H, Tq, Tk, mask_value, out, m,
                         l, stream);
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
  static constexpr int kSwz = DH >= 64 ? 128 : DH * 2; // bytes of a swizzled row
  static constexpr int kCols = kSwz / 2;               // its columns (TMA box)
  static constexpr int kHalves = DH / kCols;           // 2 at Dh = 128, else 1
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
      for (int half = 0; half < S::kHalves; ++half)
        hopper::load_rows(q_s + half * BM * SWZ, &q_map, q_full, half * COLS, q0, h, b, a.q_swap);
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
        for (int half = 0; half < S::kHalves; ++half) {
          hopper::load_rows(st + half * BK * SWZ, &k_map, &full[s], half * COLS, k0, h, b,
                    a.k_swap);
          hopper::load_rows(st + S::kKvBytes + half * BK * SWZ, &v_map, &full[s], half * COLS, k0,
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

    // ---- S = Q K^T (K-major A and B from shared memory)
    hopper::fence_regs(sc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int half = kk * 16 / COLS, off = (kk * 16 % COLS) * 2;
      hopper::Wgmma<BK>::ss(
          sc, hopper::make_desc(q_s + half * BM * SWZ + off, 16, 8 * SWZ, SWZ),
          hopper::make_desc(st + half * BK * SWZ + off, 16, 8 * SWZ, SWZ), kk > 0);
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

    // ---- O += P V (V MN-major from shared memory); keys past Tk: p = 0, v = 0
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
    case 128: return launch_tc<128>(q, k, v, ab, st, B, H, Tq, Tk, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (the SIMT kernel), 1 = bfloat16 (the tensor-core
// kernel) for q, k, v, ab and out. q (B,H,Tq,Dh), k and v (B,H,Tk,Dh) with
// the given element strides of their first three dimensions (bf16: multiples
// of 8, and 16-byte aligned bases); ab (B,H,Tq,Tk) with rows ab_st elements
// apart (bf16: a multiple of 8) and a contiguous last dimension, or null;
// q_seg (B,Tq) and kv_seg (B,Tk) int32, both or neither; out (B,H,Tq,Dh)
// contiguous; m and l (B,H,Tq) fp32, both or neither: the residuals of the
// backward. Launches on `stream` and returns cudaGetLastError() as an int
// (0 = launched).
int flash_attention(int dtype, const void* q, const void* k, const void* v,
                    const void* ab, const int32_t* q_seg, const int32_t* kv_seg,
                    long long q_sb, long long q_sh, long long q_st, long long k_sb,
                    long long k_sh, long long k_st, long long v_sb, long long v_sh,
                    long long v_st, long long ab_st, int B, int H, int Tq, int Tk, int Dh,
                    float mask_value, void* out, float* m, float* l, void* stream) {
  if ((q_seg == nullptr) != (kv_seg == nullptr) || (m == nullptr) != (l == nullptr) ||
      Tq < 1 || Tk < 1)
    return (int)cudaErrorInvalidValue;
  const Strides st{q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, ab_st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch(Dh, q, k, v, ab, q_seg, kv_seg, st, B, H, Tq, Tk, mask_value, out, m,
                   l, s);
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
