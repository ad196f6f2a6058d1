// Kaldi 80-mel log filterbank of a waveform (Hopper, sm_90a): K4.
//
// Replaces the TPU kernel `_kernel` in
// seamless_communication_tpu/ops/kernels/fbank_pallas.py:74 (wrapper
// `fbank_pallas`, :114). The plain PyTorch version of the same function is
// `_reference` in seamless_communication_torch/ops/kernels/fbank.py;
// `_fft_reference` there repeats this kernel's arithmetic (its radix
// stages, the split step, the compacted mel ranges) for the CPU tests, and
// `frame_plan` mirrors its grid and shared memory.
//
// Per frame f < max_frames, with x = waveform * 32768 (zero past the end):
//   d[i]  = x[160 f + i] - mean(x[160 f .. 160 f + 399])          i < 400
//   y[i]  = (d[i] - 0.97 d[max(i - 1, 0)]) * povey[i]   (0 for 400 <= i < 512)
//   X[k]  = sum_i y[i] e^{-2 pi i k / 512}                         k < 257
//   out[f, m] = log(max(sum_k |X[k]|^2 mel[k, m], MEL_FLOOR))      m < num_mel
// Every product is an fp32 FMA or multiply: no TF32, no tensor cores.
//
// Bound on the card (`bound` in fbank.py): the least work is a real
// 512-point FFT and the mel filters' nonzero weights, about 15 kflop a
// frame, 0.23 us for 10 s at 67 TFLOP/s; the bytes (the waveform once, the
// output once, 0.97 MB) take 0.29 us at 3.35 TB/s, so the bound is the
// bytes. At that size the kernel is a chain of latencies (one load of the
// samples, a few shared-memory round trips, the output stores), so its
// design keeps the chain short and every SM busy with one block.
//
// Grid. A block of F warps owns F consecutive frames, one a warp, F =
// min(8, max_frames / 128): 128 blocks for any max_frames up to 1024 (one
// wave on 132 SMs), 8 frames a block above. Its frames read the contiguous
// samples [160 f0, 160 (f0 + F - 1) + 400), which the block copies once into
// shared memory by 16-byte cp.async, zero-filled past n (the copy's source
// size), together with the tables (one packed fp32 buffer: window,
// twiddles, mel weights and ranges), every copy in flight at once. A block
// whose frames all lie past the waveform writes log(MEL_FLOOR) and stops;
// so does a warp whose frame starts past it.
//
// A warp's frame. Lane j first takes the sample pairs i = 2 j + 64 m (m <
// 8), which cover every i < 512 once: the warp sums them for the mean, then
// forms z[j + 32 m] = y[2 j + 64 m] + i y[2 j + 64 m + 1], the 256-point
// complex sequence whose FFT Z gives the real 512-point DFT. The FFT, with
// n = j + 32 m = ja + 4 jb + 32 m and k = p + 8 qb + 64 qa:
//   A. lane j: an 8-point DFT over m, times W_256^(j p)       -> A[p][j]
//   B. lane 4 p + ja: an 8-point DFT over jb of A[p][ja + 4 jb], times
//      W_32^(ja qb)                                          -> B[p][qb][ja]
//   C. lane 4 p + c, for qb = c and c + 4: a 4-point DFT over ja -> Z[k]
// The split step then gives bin k (lane k % 32) from Z[k] and Z[256 - k]:
//   X[k] = (Z[k] + conj Z[256-k]) / 2 + W_512^k (Z[k] - conj Z[256-k]) / 2i.
// Twiddles W_512^n = cos - i sin (2 pi n / 512) come from fp32 tables built
// in fp64 on the host, held in shared memory.
//
// Shared memory of a warp: two planes (re, im) of 288 floats, used three
// ways, each access a single wavefront (32 distinct banks) unless noted:
//   A written at 36 p + j: for a fixed p, lanes j on consecutive words;
//   B reads it at 36 p + ja + 4 jb: bank 4 p + ja + 4 jb, distinct over the
//     lanes (4 p + ja = lane);
//   B written at 32 qb + 4 p + ((ja + qb) & 3), C reads it at the same
//     places: for a fixed qb (B) or a fixed (ja, qb - c) (C) the low five
//     bits 4 p + ((ja + qb) & 3) are distinct over the lanes (a swizzle of
//     the quad);
//   Z written at k (for fixed qa, lanes p + 8 c consecutive) and read at k
//     and 256 - k by the split; the powers at k, then the mel sums read
//     them at each filter's bins (lanes on overlapping ranges: some
//     two-way conflicts, and broadcasts).
// The twiddle reads of stage A (index 2 j p) conflict 2- to 8-way: 25
// wavefronts for the warp's 7 pairs, once a frame.
//
// Mel and log: each filter's nonzero bins form one range [lo, hi); the host
// passes the ranges and the nonzero weights compacted, filter by filter.
// Lane l sums the filters l + 32 u (u < 4) side by side, each over its range
// in ascending bin order (about 6 FMAs a filter instead of 257), then
// log(max(., MEL_FLOOR)).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxFrames = 8;        // frames (warps) a block
constexpr int kFrameLen = 400;
constexpr int kHop = 160;
constexpr int kNfft = 512;
constexpr int kPlane = 288;          // floats of a warp's re or im plane
constexpr int kStage = kHop * (kMaxFrames - 1) + kFrameLen;   // 1520 samples
constexpr int kMaxMel = 128;         // 4 filters a lane
constexpr int kMaxWeights = 520;     // nonzero mel weights (at most 2 a bin)
// the packed tables (floats): window, cos, sin, weights, then the ranges
constexpr int kCos = kFrameLen, kSin = kCos + kNfft, kWeights = kSin + kNfft;
constexpr int kTables = kWeights + kMaxWeights + 3 * kMaxMel;
constexpr float kScale = 32768.f;
constexpr float kPreemph = 0.97f;
constexpr float kMelFloor = 1.192092955078125e-07f;
constexpr float kSqrtHalf = 0.70710678118654752f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16 bytes from global into shared memory, of which the first `bytes` are
// read and the rest are zeros
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// (r, i) *= W = cos t - i sin t
__device__ __forceinline__ void twiddle(float& r, float& i, float c, float s) {
  const float nr = fmaf(r, c, i * s);
  i = fmaf(i, c, -(r * s));
  r = nr;
}

// in-place 4-point forward DFT of (r[0], i[0]) .. (r[3], i[3])
__device__ __forceinline__ void dft4(float* r, float* i) {
  const float t0r = r[0] + r[2], t0i = i[0] + i[2];
  const float t1r = r[0] - r[2], t1i = i[0] - i[2];
  const float t2r = r[1] + r[3], t2i = i[1] + i[3];
  const float t3r = i[1] - i[3], t3i = r[3] - r[1];   // (c1 - c3) * -i
  r[0] = t0r + t2r;
  i[0] = t0i + t2i;
  r[1] = t1r + t3r;
  i[1] = t1i + t3i;
  r[2] = t0r - t2r;
  i[2] = t0i - t2i;
  r[3] = t1r - t3r;
  i[3] = t1i - t3i;
}

// in-place 8-point forward DFT, output in natural order: a radix-2 step
// (x_m +- x_{m+4}, the difference times W_8^m), then two 4-point DFTs
__device__ __forceinline__ void dft8(float* r, float* i) {
  float ar[4], ai[4], br[4], bi[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    ar[m] = r[m] + r[m + 4];
    ai[m] = i[m] + i[m + 4];
    br[m] = r[m] - r[m + 4];
    bi[m] = i[m] - i[m + 4];
  }
  float x = br[1], y = bi[1];            // * (1 - i) / sqrt 2
  br[1] = (x + y) * kSqrtHalf;
  bi[1] = (y - x) * kSqrtHalf;
  x = br[2];                             // * -i
  br[2] = bi[2];
  bi[2] = -x;
  x = br[3];                             // * (-1 - i) / sqrt 2
  y = bi[3];
  br[3] = (y - x) * kSqrtHalf;
  bi[3] = -(x + y) * kSqrtHalf;
  dft4(ar, ai);
  dft4(br, bi);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    r[2 * q] = ar[q];
    i[2 * q] = ai[q];
    r[2 * q + 1] = br[q];
    i[2 * q + 1] = bi[q];
  }
}

// The 256-point FFT of the warp's z (lane j holds z[j + 32 m] in zr[m],
// zi[m]) into re[k], im[k] (natural order), stages A, B, C of the header.
__device__ __forceinline__ void fft256(float* zr, float* zi, float* re, float* im,
                                       const float* tw_c, const float* tw_s, int lane) {
  // A: over m, twiddle W_256^(j p) = W_512^(2 j p), A[p][j] at 36 p + j
  dft8(zr, zi);
#pragma unroll
  for (int p = 1; p < 8; ++p) {
    const int t = 2 * lane * p;
    twiddle(zr[p], zi[p], tw_c[t], tw_s[t]);
  }
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    re[36 * p + lane] = zr[p];
    im[36 * p + lane] = zi[p];
  }
  __syncwarp();
  // B: lane 4 p + ja, over jb, twiddle W_32^(ja qb) = W_512^(16 ja qb)
  const int p = lane >> 2, ja = lane & 3;
  float br[8], bi[8];
#pragma unroll
  for (int jb = 0; jb < 8; ++jb) {
    br[jb] = re[36 * p + ja + 4 * jb];
    bi[jb] = im[36 * p + ja + 4 * jb];
  }
  __syncwarp();
  dft8(br, bi);
#pragma unroll
  for (int qb = 1; qb < 8; ++qb) {
    const int t = 16 * ja * qb;
    twiddle(br[qb], bi[qb], tw_c[t], tw_s[t]);
  }
#pragma unroll
  for (int qb = 0; qb < 8; ++qb) {
    re[32 * qb + 4 * p + ((ja + qb) & 3)] = br[qb];
    im[32 * qb + 4 * p + ((ja + qb) & 3)] = bi[qb];
  }
  __syncwarp();
  // C: lane 4 p + c, qb = c + 4 h, over ja -> Z[p + 8 qb + 64 qa]
  const int c = ja;
  float cr[8], ci[8];   // [4 h + ja]
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qb = c + 4 * h;
      cr[4 * h + a] = re[32 * qb + 4 * p + ((a + qb) & 3)];
      ci[4 * h + a] = im[32 * qb + 4 * p + ((a + qb) & 3)];
    }
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    dft4(cr + 4 * h, ci + 4 * h);
#pragma unroll
    for (int qa = 0; qa < 4; ++qa) {
      const int k = p + 8 * (c + 4 * h) + 64 * qa;
      re[k] = cr[4 * h + qa];
      im[k] = ci[4 * h + qa];
    }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kMaxFrames * 32) fbank_kernel(
    const float* __restrict__ wav, int n, const float* __restrict__ tables, int n_weights,
    int num_mel, float* __restrict__ out) {
  __shared__ __align__(16) float stage_s[kStage];
  __shared__ __align__(16) float tab_s[kTables];
  __shared__ float re_s[kMaxFrames][kPlane], im_s[kMaxFrames][kPlane];
  const float* win_s = tab_s;
  const float* tw_c = tab_s + kCos;
  const float* tw_s = tab_s + kSin;
  const float* w_s = tab_s + kWeights;
  const int* rng_s = reinterpret_cast<const int*>(tab_s + kWeights + ((n_weights + 3) & ~3));

  const int F = blockDim.x >> 5, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int f0 = blockIdx.x * F;
  const long long s0 = (long long)f0 * kHop;
  const float floor_log = logf(kMelFloor);

  if (s0 >= n) {  // every frame of the block reads zeros only
    for (int i = tid; i < F * num_mel; i += blockDim.x)
      out[(size_t)f0 * num_mel + i] = floor_log;
    return;
  }

  // ---- stage: the block's samples once (zeros past n), and the tables ----
  const int chunks = (kHop * (F - 1) + kFrameLen) / 4;
  const int all = chunks + (kWeights + ((n_weights + 3) & ~3) + 3 * num_mel + 3) / 4;
  for (int c = tid; c < all; c += blockDim.x) {
    if (c < chunks) {
      const long long s = s0 + 4 * c;
      const int bytes = s >= n ? 0 : (n - s >= 4 ? 16 : (int)(n - s) * 4);
      cp_async_zfill(stage_s + 4 * c, wav + (bytes ? s : 0), bytes);
    } else {
      cp_async_zfill(tab_s + 4 * (c - chunks), tables + 4 * (c - chunks), 16);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // ---- one frame a warp; only warp-wide syncs from here ------------------
  const int f = f0 + warp;
  float* o = out + (size_t)f * num_mel;
  if ((long long)f * kHop >= n) {
    for (int m = lane; m < num_mel; m += 32) o[m] = floor_log;
    return;
  }
  const float* raw = stage_s + kHop * warp;
  float* re = re_s[warp];
  float* im = im_s[warp];

  // 1. the mean of the frame's samples (lane j: i = 2 j + 64 m, i + 1)
  float x0[8], x1[8], sum = 0.f;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int i = 2 * lane + 64 * m;
    x0[m] = x1[m] = 0.f;
    if (i < kFrameLen) {
      const float2 v = *reinterpret_cast<const float2*>(raw + i);
      x0[m] = v.x * kScale;
      x1[m] = v.y * kScale;
    }
    sum += x0[m] + x1[m];
  }
  const float mean = warp_sum(sum) / (float)kFrameLen;

  // 2. pre-emphasis (the first sample replicated) and window: z[j + 32 m]
  float zr[8], zi[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int i = 2 * lane + 64 * m;
    zr[m] = zi[m] = 0.f;
    if (i < kFrameLen) {
      const float d0 = x0[m] - mean, d1 = x1[m] - mean;
      const float dp = (i > 0 ? raw[i - 1] * kScale : x0[m]) - mean;
      zr[m] = (d0 - kPreemph * dp) * win_s[i];
      zi[m] = (d1 - kPreemph * d0) * win_s[i + 1];
    }
  }

  // 3. the 256-point FFT of z -> Z in re, im
  fft256(zr, zi, re, im, tw_c, tw_s, lane);

  // 4. split step and power: bin k = lane + 32 t (and 256 on lane 0)
  float pw[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const int k = lane + 32 * t;
    pw[t] = 0.f;
    if (k <= 256) {
      const float a = re[k & 255], b = im[k & 255];
      const float c = re[(256 - k) & 255], d = im[(256 - k) & 255];
      const float u = 0.5f * (b + d), v = 0.5f * (c - a);
      const float xr = fmaf(tw_s[k], v, fmaf(tw_c[k], u, 0.5f * (a + c)));
      const float xi = fmaf(-tw_s[k], u, fmaf(tw_c[k], v, 0.5f * (b - d)));
      pw[t] = fmaf(xr, xr, xi * xi);
    }
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < 9; ++t)
    if (lane + 32 * t <= 256) re[lane + 32 * t] = pw[t];
  __syncwarp();

  // 5. mel: the filters lane + 32 u side by side, each over its nonzero
  // bins in ascending order, then log
  int lo[4], len[4], off[4], most = 0;
  float acc[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int m = lane + 32 * u;
    lo[u] = off[u] = len[u] = 0;
    acc[u] = 0.f;
    if (m < num_mel) {
      lo[u] = rng_s[3 * m];
      len[u] = rng_s[3 * m + 1] - lo[u];
      off[u] = rng_s[3 * m + 2];
    }
    most = max(most, len[u]);
  }
  for (int j = 0; j < most; ++j)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (j < len[u]) acc[u] = fmaf(re[lo[u] + j], w_s[off[u] + j], acc[u]);
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (lane + 32 * u < num_mel) o[lane + 32 * u] = logf(fmaxf(acc[u], kMelFloor));
}

}  // namespace

extern "C" {

// wav: (n,) f32; tables: the Povey window (400,), cos and sin of 2 pi n /
// 512 (512,) each, the mel filters' nonzero weights compacted (n_weights,
// padded to a multiple of 4), then their ranges (num_mel, 3) int32 (bins
// [lo, hi) and the offset of the first weight), all in one buffer (fp32
// bits); both 16-byte aligned. out (max_frames, num_mel) f32, max_frames a
// multiple of 128. Launches on `stream` and returns cudaGetLastError() as
// an int (0 = launched).
int fbank(const float* wav, int n, const float* tables, int n_weights, int num_mel,
          int max_frames, float* out, void* stream) {
  if (max_frames < 128 || max_frames % 128 || num_mel < 1 || num_mel > kMaxMel ||
      n_weights < 0 || n_weights > kMaxWeights || n < 0 ||
      reinterpret_cast<uintptr_t>(wav) % 16 || reinterpret_cast<uintptr_t>(tables) % 16)
    return (int)cudaErrorInvalidValue;
  const int F = max_frames / 128 < kMaxFrames ? max_frames / 128 : kMaxFrames;
  fbank_kernel<<<max_frames / F, 32 * F, 0, static_cast<cudaStream_t>(stream)>>>(
      wav, n, tables, n_weights, num_mel, out);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
