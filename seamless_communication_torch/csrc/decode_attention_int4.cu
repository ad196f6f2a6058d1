// K2: fused beam-gather + packed-int4 KV-row insert + causal decode
// attention, one decode step of int4-KV self-attention for one layer
// (Hopper, sm_90a).
//
// Replaces the TPU kernel `_kernel_int4` in
// seamless_communication_tpu/ops/kernels/decode_attention.py:267 (wrapper
// `fused_decode_self_attention_int4`, :412). The plain PyTorch version of
// the same function is `_reference_int4` in
// seamless_communication_torch/ops/kernels/decode_attention.py. The caches
// are (B, H, T, Dh/2) bytes in split-half order: byte j of a row holds value
// j in its low nibble and value j + Dh/2 in its high nibble, each a signed
// 4-bit integer in [-7, 7]; the scales are absmax / 7. The function and the
// design are K1's, written out in decode_attention.cuh, over half-width rows:
// a lane takes 8 bytes of a row and sign-extends both nibbles of each byte
// in registers (16 values).
//
// Bound on the card: the gathered packed caches and their f32 scales read
// once (the distinct source beams' rows) and written once: at the main-path
// shape B=5, H=16, T=320, Dh=64 with 3 distinct origins, 3.0 MB, 0.90 us at
// 3.35 TB/s; bound by bytes.
//
// The first design (K1's first, over 32-byte rows) took 9.58-9.71 us under
// CUDA-graph replay on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 2,
// L2-warm), the same as K1 at half its bytes: its chain of dependent phases,
// not the bytes, set the time. The present design starts a block's slice at
// once with bulk copies, stores by bulk copy, and splits each (b, h) over a
// cluster; rows of Dh/2 bytes that are not a multiple of 16 (Dh = 16, 48,
// ...) take 8-byte cp.async copies and thread stores instead.

#include "decode_attention.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k_t, v_t and out). Caches are
// (B, H, T_len, Dh/2) packed bytes, 8-byte aligned. The plan as for
// decode_attention_int8. Launches on `stream` and returns a CUDA error code
// as an int (0 = launched).
int decode_attention_int4(int dtype, const void* q, const void* k_t, const void* v_t,
                          const int8_t* k_cache, const int8_t* v_cache,
                          const float* k_scale, const float* v_scale, const int32_t* src,
                          int B, int H, int T_len, int Dh, int step, float sqrt_dh,
                          int cluster, int slice_rows, int tile_rows, int stages,
                          void* out, int8_t* new_k, int8_t* new_v, float* new_ks,
                          float* new_vs, void* stream) {
  const decode_step::Params p{q,     k_t,    v_t,    k_cache, v_cache, k_scale, v_scale,
                              src,   out,    new_k,  new_v,   new_ks,  new_vs,  H,
                              T_len, Dh,     step,   sqrt_dh, cluster, slice_rows,
                              tile_rows, stages};
  return decode_step::run<decode_step::Int4Rows>(dtype, p, B, stream);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
