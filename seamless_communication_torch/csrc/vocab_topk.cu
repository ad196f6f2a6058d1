// Fused int8 tied-vocabulary projection with per-tile logsumexp stats and
// top-k inputs, for one beam-search step (Hopper, sm_90a).
//
// Replaces the TPU kernels of
// seamless_communication_tpu/ops/kernels/vocab_topk.py:
//   vocab_topk_v2  <- `_kernel_v2` (:170, pallas_call :202; wrapper
//                     `int8_vocab_topk_v2`, :231)
//   vocab_topk     <- `_kernel`    (:45, pallas_call :91; wrapper
//                     `int8_vocab_topk`, :120)
// The plain PyTorch versions are `_reference` (the whole function) and
// `_tiles_reference` (what these kernels write) in
// seamless_communication_torch/ops/kernels/vocab_topk.py.
//
// For the vocabulary tile g (rows v = 128 g + r, r < 128) and each x row n:
//   l[n, v] = (sum_d x[n, d] * q[v, d]) * row_scale[v]   for v < V, NEG past V
//   tile_max[g, n] = max_r l[n, v]
//   tile_se[g, n]  = sum_{v < V} exp(l[n, v] - tile_max[g, n])
// vocab_topk_v2 writes l as (N, G*128) logits. vocab_topk writes no logits
// but the tile's k largest l and their ids, found in k rounds of: the
// largest value, the lowest id among its equals, that entry masked to NEG.
//
// Bound on the card: the int8 table is read once, V*D bytes (262 MB at
// V = 256102, D = 1024); vocab_topk_v2 also writes 4*N*V bytes of logits
// (5 MB at N = 5). That is about 80 us at 3.35 TB/s. The 2*N*V*D operations
// (2.6 GFLOP at N = 5) take 39 us at the fp32 rate, so both kernels are
// bound by bytes.
//
// Design: one block of 256 threads (8 warps) per tile of 128 rows, 2001
// blocks at V = 256102. The x rows are staged in shared memory as fp32, up
// to 10 rows a pass (more rows take more passes, which read the tile again,
// from L2). A warp owns 16 table rows and takes them 4 at a time: each lane
// loads 16 bytes of each of the 4 rows (neighbouring lanes on neighbouring
// addresses) and multiplies them with the staged x rows, so each x value read
// from shared memory serves 4 table rows. The staged rows are laid out so
// that the 32 lanes of a warp read 32 consecutive float4s (no bank
// conflict). The int8 values are widened exactly by placing q + 128 in the
// mantissa of 2^23 (one byte permute) and subtracting 2^23 + 128, which
// keeps the integer-to-float converter, at a quarter of the fp32 rate, off
// the path. Shuffles reduce each dot product in fp32; the tile's logits go
// through shared memory to coalesced stores and to the stats, one warp per
// x row. No TMA and no tensor cores: the table is read once with plain
// loads, and the products are fp32 as in the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;                    // vocabulary rows per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kTile / kWarps;  // 16
constexpr int kR = 4;                         // table rows a lane takes at once
constexpr int kMaxRows = 10;                  // x rows per pass
constexpr int kXFloats = 10240;               // 40 KB of staged x rows
constexpr float kNeg = -1e30f;
constexpr float kMagic = 8388736.0f;          // 2^23 + 128

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// Byte j of a word of int8 values, given the word xor 0x80808080 (each byte
// then holds q + 128 in [1, 255]): 0x4B0000bb is the float 2^23 + bb.
__device__ __forceinline__ float widen(unsigned biased, int j) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540u | j)) - kMagic;
}

__device__ __forceinline__ unsigned word(const uint4& q, int w) {
  return w == 0 ? q.x : w == 1 ? q.y : w == 2 ? q.z : q.w;
}

// Where x[n, d] sits in row n of the staged copy: the 4 values of word w of
// the 16-byte chunk c = 32 i + lane are float4 number (4 i + w) * 32 + lane.
__device__ __forceinline__ int staged(int d) {
  const int c = d >> 4, w = (d >> 2) & 3;
  return ((((c >> 5) * 4 + w) * 32 + (c & 31)) << 2) | (d & 3);
}

__host__ __device__ __forceinline__ int staged_row(int D) {
  return (D + 511) / 512 * 512;
}

template <typename T, bool kTopK>
__global__ void __launch_bounds__(kThreads) vocab_tile_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ table,
    const float* __restrict__ row_scale, int N, int D, int V, int rows_per_pass,
    int k, float* __restrict__ logits, float* __restrict__ top_vals,
    int32_t* __restrict__ top_idx, float* __restrict__ tile_max,
    float* __restrict__ tile_se) {
  __shared__ __align__(16) float x_s[kXFloats];
  __shared__ float l_s[kMaxRows][kTile];

  const int g = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunks = D >> 4;
  const int Dp = staged_row(D);
  const size_t Vp = (size_t)gridDim.x * kTile;

  for (int n0 = 0; n0 < N; n0 += rows_per_pass) {
    const int nc = min(rows_per_pass, N - n0);
    __syncthreads();  // the previous pass is done with x_s and l_s
    for (int e = threadIdx.x; e < nc * D; e += kThreads) {
      const int n = e / D, d = e - n * D;
      x_s[n * Dp + staged(d)] = to_f32<T>(x[(size_t)(n0 + n) * D + d]);
    }
    __syncthreads();

    // ---- logits of this warp's 16 rows, 4 rows at a time ------------------
    for (int r0 = warp * kRowsPerWarp; r0 < (warp + 1) * kRowsPerWarp; r0 += kR) {
      const int v0 = g * kTile + r0;
      float acc[kR][kMaxRows];
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int n = 0; n < kMaxRows; ++n) acc[r][n] = 0.f;

      for (int c = lane; c < chunks; c += 32) {
        uint4 q[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r)
          q[r] = (v0 + r < V)
                     ? __ldg(reinterpret_cast<const uint4*>(table + (size_t)(v0 + r) * D) + c)
                     : make_uint4(0u, 0u, 0u, 0u);
        const float4* xc =
            reinterpret_cast<const float4*>(x_s) + (c >> 5) * 4 * 32 + lane;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          float t[kR][4];
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            const unsigned biased = word(q[r], w) ^ 0x80808080u;
#pragma unroll
            for (int j = 0; j < 4; ++j) t[r][j] = widen(biased, j);
          }
#pragma unroll
          for (int n = 0; n < kMaxRows; ++n) {
            if (n < nc) {
              const float4 xv = xc[n * (Dp / 4) + w * 32];
#pragma unroll
              for (int r = 0; r < kR; ++r) {
                float a = acc[r][n];
                a = fmaf(t[r][0], xv.x, a);
                a = fmaf(t[r][1], xv.y, a);
                a = fmaf(t[r][2], xv.z, a);
                a = fmaf(t[r][3], xv.w, a);
                acc[r][n] = a;
              }
            }
          }
        }
      }

#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int v = v0 + r;
        const float sc = (v < V) ? __ldg(row_scale + v) : 0.f;
#pragma unroll
        for (int n = 0; n < kMaxRows; ++n) {
          if (n < nc) {  // nc is the same for the whole block
            const float s = warp_sum(acc[r][n]);
            if (lane == 0) l_s[n][r0 + r] = (v < V) ? s * sc : kNeg;
          }
        }
      }
    }
    __syncthreads();

    // ---- per x row: logits out, tile stats, and (v1) the tile's top k ------
    for (int n = warp; n < nc; n += kWarps) {
      const size_t row = (size_t)(n0 + n);
      float l[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) l[j] = l_s[n][lane + 32 * j];
      if (!kTopK) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          logits[row * Vp + (size_t)g * kTile + lane + 32 * j] = l[j];
      }
      const float m = warp_max(fmaxf(fmaxf(l[0], l[1]), fmaxf(l[2], l[3])));
      float se = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (g * kTile + lane + 32 * j < V) se += expf(l[j] - m);
      se = warp_sum(se);
      if (lane == 0) {
        tile_max[(size_t)g * N + row] = m;
        tile_se[(size_t)g * N + row] = se;
      }
      if (kTopK) {
        for (int s = 0; s < k; ++s) {
          // this lane's best (its columns ascend, so > keeps the lowest)
          float bv = l[0];
          int bc = lane;
#pragma unroll
          for (int j = 1; j < 4; ++j)
            if (l[j] > bv) {
              bv = l[j];
              bc = lane + 32 * j;
            }
          for (int o = 16; o > 0; o >>= 1) {
            const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
            const int oc = __shfl_xor_sync(0xffffffffu, bc, o);
            if (ov > bv || (ov == bv && oc < bc)) {
              bv = ov;
              bc = oc;
            }
          }
          if (lane == 0) {
            top_vals[((size_t)g * N + row) * k + s] = bv;
            top_idx[((size_t)g * N + row) * k + s] = g * kTile + bc;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (bc == lane + 32 * j) l[j] = kNeg;
        }
      }
    }
  }
}

template <bool kTopK>
int launch(int dtype, const void* x, const int8_t* table, const float* row_scale,
           int N, int D, int V, int k, float* logits, float* top_vals,
           int32_t* top_idx, float* tile_max, float* tile_se, void* stream) {
  if (N < 1 || D < 16 || D % 16 || D > kXFloats || V < 1 ||
      (kTopK && (k < 1 || k > kTile)))
    return (int)cudaErrorInvalidValue;
  const int fit = kXFloats / staged_row(D);
  const int rows = fit < kMaxRows ? fit : kMaxRows;
  const int G = (V + kTile - 1) / kTile;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    vocab_tile_kernel<float, kTopK><<<G, kThreads, 0, st>>>(
        static_cast<const float*>(x), table, row_scale, N, D, V, rows, k, logits,
        top_vals, top_idx, tile_max, tile_se);
  } else if (dtype == 1) {
    vocab_tile_kernel<__nv_bfloat16, kTopK><<<G, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), table, row_scale, N, D, V, rows, k,
        logits, top_vals, top_idx, tile_max, tile_se);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x). x (N, D), table (V, D) int8 and
// row_scale (V,) f32 on the card; logits (N, ceil(V/128)*128) f32; tile_max
// and tile_se (ceil(V/128), N) f32. Launches on `stream` and returns
// cudaGetLastError() as an int (0 = launched).
int vocab_topk_v2(int dtype, const void* x, const int8_t* table,
                  const float* row_scale, int N, int D, int V, float* logits,
                  float* tile_max, float* tile_se, void* stream) {
  return launch<false>(dtype, x, table, row_scale, N, D, V, 0, logits, nullptr,
                       nullptr, tile_max, tile_se, stream);
}

// As vocab_topk_v2, but instead of the logits each tile's k largest
// (k <= 128): top_vals (G, N, k) f32 and top_idx (G, N, k) int32.
int vocab_topk(int dtype, const void* x, const int8_t* table,
               const float* row_scale, int N, int D, int V, int k,
               float* top_vals, int32_t* top_idx, float* tile_max,
               float* tile_se, void* stream) {
  return launch<true>(dtype, x, table, row_scale, N, D, V, k, nullptr, top_vals,
                      top_idx, tile_max, tile_se, stream);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
