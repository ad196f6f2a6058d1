// Kaldi 80-mel log filterbank of a waveform (Hopper, sm_90a).
//
// Replaces the TPU kernel `_kernel` in
// seamless_communication_tpu/ops/kernels/fbank_pallas.py:74 (wrapper
// `fbank_pallas`, :114). The plain PyTorch version of the same function is
// `_reference` in seamless_communication_torch/ops/kernels/fbank.py.
//
// Per frame f < max_frames, with x = waveform * 32768 (zero past the end):
//   d[i]  = x[160 f + i] - mean(x[160 f .. 160 f + 399])          i < 400
//   y[i]  = (d[i] - 0.97 d[max(i - 1, 0)]) * povey[i]
//   X[k]  = sum_i y[i] e^{-2 pi i k / 512}                         k < 257
//   out[f, m] = log(max(sum_k |X[k]|^2 mel[k, m], MEL_FLOOR))      m < num_mel
//
// The TPU kernel frames by hop-row reshapes, folds the DC removal into a
// column-sum term, and multiplies by a 400 x 768 [cos | sin] basis in bf16x3
// pieces (its in-kernel matmul rounds to bf16). None of that carries over:
// here every product is an fp32 FMA (the DFT cancels heavily; TF32 would
// lose what bf16x3 kept), and the basis is not stored at all. The twiddle
// of sample i and bin k is cos/sin(2 pi ((i k) mod 512) / 512), read from a
// 512-entry table in shared memory, with the window applied to the samples
// instead of folded into the basis.
//
// Bound on the card (`bound` in fbank.py): the least work of the function is
// a real 512-point FFT and the mel filters' nonzero weights, about 15 kflop a
// frame; for a 10 s waveform (1000 such frames) 15.4 Mflop, 0.23 us at
// 67 TFLOP/s (fp32 without tensor cores). The bytes (the waveform once, the
// output once, 0.97 MB) take 0.29 us at 3.35 TB/s, so the bound is the bytes.
// This kernel sums the DFT directly (400 x 257 complex products a frame,
// about 30x the FFT's flops): simple and exact in fp32, far from the bound.
//
// Design: one block of 288 threads (9 warps) per 4 frames. Warps 0-3 stage
// one frame each in shared memory (DC removal by a warp sum, pre-emphasis,
// window); then thread k < 257 computes bin k of the 4 frames at once (one
// twiddle read for the 4, the samples read as broadcasts, 8 independent
// sums); then the threads compute the (frame, mel) outputs, the mel weights
// read from global memory (coalesced over m, cached). A block whose frames
// all lie past the waveform's end writes log(MEL_FLOOR) and stops.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 288;
constexpr int kFrames = 4;  // frames a block
constexpr int kFrameLen = 400;
constexpr int kHop = 160;
constexpr int kNfft = 512;
constexpr int kBins = kNfft / 2 + 1;  // 257
constexpr float kScale = 32768.f;
constexpr float kPreemph = 0.97f;
constexpr float kMelFloor = 1.192092955078125e-07f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads) fbank_kernel(
    const float* __restrict__ wav, int n, const float* __restrict__ win,
    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    const float* __restrict__ mel, int num_mel, float* __restrict__ out) {
  __shared__ float cos_s[kNfft], sin_s[kNfft], win_s[kFrameLen];
  __shared__ float raw_s[kFrames][kFrameLen], fr_s[kFrames][kFrameLen];
  __shared__ float pw_s[kFrames][kBins];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int f0 = blockIdx.x * kFrames;

  if ((long long)f0 * kHop >= n) {  // every frame of the block reads zeros only
    const float floor_log = logf(kMelFloor);
    for (int i = tid; i < kFrames * num_mel; i += blockDim.x)
      out[(size_t)f0 * num_mel + i] = floor_log;
    return;
  }

  for (int i = tid; i < kNfft; i += blockDim.x) {
    cos_s[i] = cos_t[i];
    sin_s[i] = sin_t[i];
  }
  for (int i = tid; i < kFrameLen; i += blockDim.x) win_s[i] = win[i];
  __syncthreads();

  // ---- stage each frame: DC removal, pre-emphasis, window ----------------
  if (warp < kFrames) {
    const long long start = (long long)(f0 + warp) * kHop;
    float sum = 0.f;
    for (int i = lane; i < kFrameLen; i += 32) {
      const long long s = start + i;
      const float x = s < n ? wav[s] * kScale : 0.f;
      raw_s[warp][i] = x;
      sum += x;
    }
    const float mean = warp_sum(sum) / (float)kFrameLen;
    __syncwarp();
    for (int i = lane; i < kFrameLen; i += 32) {
      const float d = raw_s[warp][i] - mean;
      const float prev = raw_s[warp][i > 0 ? i - 1 : 0] - mean;
      fr_s[warp][i] = (d - kPreemph * prev) * win_s[i];
    }
  }
  __syncthreads();

  // ---- DFT power: thread k, the block's frames together ------------------
  // one twiddle read serves the 4 frames, whose 8 sums are independent
  const int k = tid;
  if (k < kBins) {
    float re[kFrames], im[kFrames];
#pragma unroll
    for (int j = 0; j < kFrames; ++j) re[j] = im[j] = 0.f;
    int idx = 0;  // (i * k) mod 512
    for (int i = 0; i < kFrameLen; ++i) {
      const float c = cos_s[idx], s = sin_s[idx];
#pragma unroll
      for (int j = 0; j < kFrames; ++j) {
        const float y = fr_s[j][i];
        re[j] = fmaf(y, c, re[j]);
        im[j] = fmaf(y, s, im[j]);
      }
      idx = (idx + k) & (kNfft - 1);
    }
#pragma unroll
    for (int j = 0; j < kFrames; ++j) pw_s[j][k] = re[j] * re[j] + im[j] * im[j];
  }
  __syncthreads();

  // ---- mel products and log ---------------------------------------------
  for (int item = tid; item < kFrames * num_mel; item += blockDim.x) {
    const int j = item / num_mel, m = item % num_mel;
    float acc = 0.f;
    for (int b = 0; b < kBins; ++b) acc = fmaf(pw_s[j][b], __ldg(mel + b * num_mel + m), acc);
    out[(size_t)(f0 + j) * num_mel + m] = logf(fmaxf(acc, kMelFloor));
  }
}

}  // namespace

extern "C" {

// wav: (n,) f32; win (400,), cos_t and sin_t (512,), mel (257, num_mel) f32;
// out (max_frames, num_mel) f32, max_frames a multiple of 4. Launches on
// `stream` and returns cudaGetLastError() as an int (0 = launched).
int fbank(const float* wav, int n, const float* win, const float* cos_t,
          const float* sin_t, const float* mel, int num_mel, int max_frames,
          float* out, void* stream) {
  if (max_frames % kFrames || num_mel <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(max_frames / kFrames);
  fbank_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      wav, n, win, cos_t, sin_t, mel, num_mel, out);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
