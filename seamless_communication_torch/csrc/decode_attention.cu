// K1: fused beam-gather + int8 KV-row insert + causal decode attention, one
// decode step of int8-KV self-attention for one layer (Hopper, sm_90a).
//
// Replaces the TPU kernel `_kernel` in
// seamless_communication_tpu/ops/kernels/decode_attention.py:75 (wrapper
// `fused_decode_self_attention_int8`, :676). The plain PyTorch version of
// the same function is `_reference` in
// seamless_communication_torch/ops/kernels/decode_attention.py; the
// function and the design are written out in decode_attention.cuh, shared
// with K2 (decode_attention_int4.cu).
//
// Bound on the card: the function must read the gathered int8 caches and
// their f32 scales once (the distinct source beams' rows) and write the new
// ones once: at the main-path shape B=5 (beam 5), H=16, T=320, Dh=64 with 3
// distinct origins, 5.6 MB, 1.69 us at 3.35 TB/s. Its arithmetic (4 flops a
// cached value) is far below the fp32 rate, so bytes bound it.
//
// The first design (one block of 128 threads a (b, h), 80 blocks at that
// shape) took 9.46-9.59 us under CUDA-graph replay on an H100 80GB HBM3 at
// 700 W (chip_smoke.py phase 2, L2-warm): each block ran a chain of six
// dependent phases, each waiting on its own global loads (the current row
// and three block reductions, a k pass one row a thread, the scales, a v
// pass), and the chip held about 0.66 MB of loads in flight where 3.35 TB/s
// at HBM latency wants 2-3 MB. The present design (decode_attention.cuh)
// starts every byte of a block's slice at once with bulk copies, stores the
// new slabs by bulk copy as they land, splits each (b, h) over a cluster of
// up to 8 blocks (320 blocks at the main-path shape) merged through
// distributed shared memory, and streams caches longer than its shared
// memory through a ring of tiles.

#include "decode_attention.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k_t, v_t and out). Caches are
// (B, H, T_len, Dh) int8, 16-byte aligned. The plan (cluster, slice_rows,
// tile_rows, stages) is `split_plan` of ops/kernels/decode_attention.py.
// Launches on `stream` and returns a CUDA error code as an int (0 =
// launched).
int decode_attention_int8(int dtype, const void* q, const void* k_t, const void* v_t,
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
  return decode_step::run<decode_step::Int8Rows>(dtype, p, B, stream);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
