// K5: row-indexed int8-KV decode attention, one decode step of
// self-attention for one layer under the lazy beam reorder (Hopper, sm_90a).
//
// Replaces the TPU kernel `_indexed_kernel` in
// seamless_communication_tpu/ops/kernels/decode_attention.py:534 (wrapper
// `indexed_decode_self_attention_int8`, :626). The plain PyTorch version of
// the same function is `_indexed_reference` in
// seamless_communication_torch/ops/kernels/decode_attention.py.
//
// The caches are never permuted. Row t of logical beam b lives in physical
// slot s = row_src[b, t]. For each (b, h):
//   logit[t] = (q . k_i8[s,h,t]) * k_scale[s,h,t] / sqrt(Dh)   for t < step
//   lcur     = (q . k_t) / sqrt(Dh)                  (current row, unquantized)
//   m = max(NEG, logit[t<step], lcur), p[t] = exp(logit[t] - m), pc = exp(lcur - m)
//   out = (sum_t round_dtype(p[t] * v_scale[s,h,t]) * v_i8[s,h,t] + pc * v_t)
//         / (sum_t p[t] + pc)
// with true fp32 divisions, as the plain version divides. Nothing is
// written but `out`: the caller quantizes the new row and stores it in place
// at [b, :, step], which is safe because rows t >= step are never read here.
// The TPU kernel attends to every physical slot and selects the origin row's
// logit afterwards (a one-hot trick for the matrix unit); here each row is
// read from its own slot.
//
// Bound on the card: the function must read the distinct (slot, t) rows that
// some beam reads at t < step (k and v rows, 2*Dh bytes, and their two f32
// scales, over H heads) and write out. At the main-path shape (B=5 beams,
// H=16, Dh=64, a T=320 cache, step 200 of a beam-history table) that is
// about 0.5 MB, 0.16 us at 3.35 TB/s; the arithmetic (4*B*H*step*Dh flops)
// is negligible, so it is bound by bytes.
//
// The first design (one block of 128 threads a (b, h), 80 blocks at that
// shape, a chain of dependent phases each waiting on its own global loads:
// the current row's reduction, one history row a thread, a block max, a
// second pass for v_scale, a block sum, the value pass, a reduction) took
// 7.96-8.03 us under CUDA-graph replay on an H100 80GB HBM3 at 700 W. Now it
// is K1's design, decode_attention.cuh with the RowOrigin policy: a (b, h)'s
// rows split over a thread-block cluster (split_plan), each block's slice of
// row_src loaded once into shared memory, its rows copied with 16-byte
// cp.async by every thread into the ring's mbarrier-guarded slots (the
// rows of one tile come from different slots, so no bulk copy takes a
// tile), the maxima and partial sums exchanged through distributed shared
// memory as K1 exchanges them. What holds it back is K1's: a chain of fixed
// latencies (the table's load, the copies' landing, two cluster exchanges),
// not bytes.

// its own namespace: K1's library loads in the same process
#define DECODE_STEP_NS decode_step_indexed
#include "decode_attention.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k_t, v_t and out). Caches are
// (B, H, T_len, Dh) int8, 16-byte aligned; row_src (B, T_len) int32. The
// plan (cluster, slice_rows, tile_rows, stages) is `split_plan(...,
// indexed=True)` of ops/kernels/decode_attention.py. Launches on `stream`
// and returns a CUDA error code as an int (0 = launched).
int decode_attention_indexed(int dtype, const void* q, const void* k_t, const void* v_t,
                             const int8_t* k_cache, const int8_t* v_cache,
                             const float* k_scale, const float* v_scale,
                             const int32_t* row_src, int B, int H, int T_len, int Dh,
                             int step, float sqrt_dh, int cluster, int slice_rows,
                             int tile_rows, int stages, void* out, void* stream) {
  const decode_step_indexed::Params p{
      q,       k_t,     v_t,    k_cache,  v_cache, k_scale, v_scale,    row_src,
      out,     nullptr, nullptr, nullptr, nullptr, H,       T_len,      Dh,
      step,    sqrt_dh, cluster, slice_rows, tile_rows, stages};
  return decode_step_indexed::run<decode_step_indexed::Int8Rows,
                                  decode_step_indexed::RowOrigin>(dtype, p, B, stream);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
