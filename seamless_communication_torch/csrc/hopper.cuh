// Hopper (sm_90a) building blocks shared by the kernels fed by TMA:
// flash_attention.cu (K6), flash_attention_bwd.cu (K6b, K6c),
// vocab_topk.cu (K3b) and decode_attention.cuh (K1, K2, K5): mbarriers, TMA
// tile loads, 1-d bulk copies and cp.async copies, thread-block-cluster
// barriers and distributed shared memory, shared-memory matrix descriptors
// and warpgroup matrix multiplies (wgmma), and the host-side encoding of a
// TMA tensor map (bf16 or fp32).
//
// Layouts. Every bf16 tile that a wgmma reads is stored as TMA writes it
// with a swizzle: rows of `kSwizzle` bytes (the row of a tile of width Dh
// <= 64, one 64-column half of a Dh = 128 tile, or one 16-column part of a
// Dh = 80 tile: `row_box_bytes`), the parts of a row stored one after the
// other (part p of every row, then part p + 1), 8 rows making one swizzle
// atom of 8 * kSwizzle bytes, the atom's 16-byte chunks XOR-ed with the row
// index. A tile's base is 1024-byte aligned, so the swizzle phase starts at
// 0. The same tile is read two ways:
//   K-major (the contraction runs along the row: S = Q K^T reads Q and K
//     so), descriptor SBO = 8 rows = 8 * kSwizzle bytes between 8-row
//     groups, LBO unused; a k16 step advances the start by 32 bytes within
//     a part, or to the next part;
//   MN-major (the contraction runs down the rows: O += P V reads V so),
//     SBO = 8 * kSwizzle between groups of 8 contraction rows, LBO between
//     the parts along N; a k16 step advances the start by 16 rows.
// The fp32 accumulator of m64nNk16 gives thread t of warp w the rows
// 16 w + t / 4 and 16 w + t / 4 + 8 and, in each 8-column chunk j, the
// columns 8 j + 2 (t % 4) + {0, 1}: d[4 j + {0, 1}] on the first row and
// d[4 j + {2, 3}] on the second. Rounded to bf16 pairwise, the four chunks
// 2 kk, 2 kk + 1 of one 16-column step are the register A fragment of a
// k16 product, so a probability tile goes from one product to the next
// without shared memory.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// one arrival, and `bytes` more to come from TMA before the phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// waits until the phase of parity `parity` has completed; a phase that never
// completes (a lost arrival or copy) traps after about 10 s of clocks, a
// launch error the caller sees, instead of holding the card forever.
// kCluster acquires at cluster scope: for bytes that other blocks of the
// cluster wrote with st_async.
template <bool kCluster = false>
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (!done) {
    if (clock64() - start > 20000000000LL) __trap();
    if constexpr (kCluster)
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(addr), "r"(parity)
          : "memory");
    else
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(addr), "r"(parity)
          : "memory");
  }
}

// ---- TMA --------------------------------------------------------------------

// one box of a 4-d tensor map into shared memory, completion reported to `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// one box of a 2-d tensor map (columns c0, rows c1) into shared memory
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// The 4-d tensor map coordinates of (d, t, h, b): `th_swap` when the map's
// second dimension is h (strides sorted ascending, as a head split from
// (B, T, H * Dh) activations has them).
__device__ __forceinline__ void load_rows(void* dst, const CUtensorMap* map, uint64_t* bar,
                                          int d, int t, int h, int b, bool th_swap) {
  if (th_swap)
    tma_load_4d(dst, map, bar, d, h, t, b);
  else
    tma_load_4d(dst, map, bar, d, t, h, b);
}

// ---- 1-d bulk copies ------------------------------------------------------

// `bytes` (a multiple of 16; both addresses 16-byte aligned) from global
// memory into this block's shared memory, completion reported to `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// `bytes` (a multiple of 16; both addresses 16-byte aligned) from this
// block's shared memory to global memory, in the current bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                   reinterpret_cast<uint64_t>(dst)),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// waits until at most N of this thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// orders this thread's earlier shared-memory writes before its later bulk
// (async-proxy) reads of them
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 8 bytes (both addresses 8-byte aligned) from global into shared memory
__device__ __forceinline__ void cp_async_8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)),
               "l"(reinterpret_cast<uint64_t>(src))
               : "memory");
}

// 16 bytes (both addresses 16-byte aligned) from global into shared memory,
// past L1
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(reinterpret_cast<uint64_t>(src))
               : "memory");
}

// one arrival on `bar` once this thread's earlier cp.async copies have landed
// (the barrier counts it among those it was initialised with)
__device__ __forceinline__ void cp_async_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// ---- thread-block clusters ---------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Cluster barrier, split in two: every thread of every block arrives, then
// waits. This relaxed arrival orders nothing by itself: after
// fence_barrier_init it publishes this block's initialised mbarriers, and
// the wait says that every block of the cluster runs, so that its shared
// memory may be written.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the shared::cluster address of `local`'s offset in block `rank`
__device__ __forceinline__ uint32_t mapa(const void* local, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_addr(local)), "r"(rank));
  return remote;
}

// `v` into the float at `local`'s offset in the shared memory of block `rank`
// of this cluster, its 4 bytes counted on that block's mbarrier at `bar`'s
// offset
__device__ __forceinline__ void st_async(const float* local, uint32_t rank, float v,
                                         uint64_t* bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(
          mapa(local, rank)),
      "f"(v), "r"(mapa(bar, rank))
      : "memory");
}

// the same for 4 floats (16 bytes, `local` 16-byte aligned)
__device__ __forceinline__ void st_async4(const float* local, uint32_t rank, float4 v,
                                          uint64_t* bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, "
      "%4}, [%5];\n" ::"r"(mapa(local, rank)),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(mapa(bar, rank))
      : "memory");
}

// barrier `id` (not 0, which __syncthreads uses) among `count` threads
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// ---- wgmma ------------------------------------------------------------------

// Bytes of the swizzled TMA box that holds one row of `row_bytes` (a
// multiple of 32) of a tile: the whole row up to 128 bytes, else the largest
// of 128, 64 and 32 bytes that divides it, so that a row is a whole number of
// boxes (Dh = 80: five 64-byte boxes of fp32, five 32-byte boxes of bf16).
__host__ __device__ constexpr int row_box_bytes(int row_bytes) {
  return row_bytes <= 128        ? row_bytes
         : row_bytes % 128 == 0 ? 128
         : row_bytes % 64 == 0  ? 64
                                : 32;
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle mode (bits 62-63: 1 = 128 B, 2 = 64 B,
// 3 = 32 B).
__device__ __forceinline__ uint64_t make_desc(const void* smem, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes, int swizzle_bytes) {
  const uint64_t mode = swizzle_bytes == 128 ? 1 : swizzle_bytes == 64 ? 2 : 3;
  return (uint64_t)((smem_addr(smem) >> 4) & 0x3FFF) |
         ((uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32) | (mode << 62);
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a tile of `swz`-byte
// rows (1024-byte aligned) as TMA stores it with the swizzle of that span:
// address bits 4.. XOR-ed with bits 7.. (log2(swz / 16) of them).
__device__ __forceinline__ int swizzled(int row, int chunk, int swz) {
  const int o = row * swz + chunk * 16;
  return o ^ (((o >> 7) & (swz / 16 - 1)) << 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of an accumulator across the
// asynchronous products that write it
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 2^x by the hardware (about 2^-22 relative error), results below 2^-126
// flushed to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// m64nNk16 products: ss (A and B from shared memory) for the score tiles
// (N = 32, 64), rs (A from registers) for the value products (N = Dh).
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  // D (64 x 16, fp32) (+)= A (64 x 16, bf16 in registers) * B (16 x 16,
  // MN-major in shared memory)
  static __device__ __forceinline__ void rs(float (&d)[8], const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  // D (64 x 32, fp32) (+)= A (64 x 16, K-major in shared memory) * B (32 x 16,
  // K-major in shared memory)^T
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // D (64 x 32, fp32) (+)= A (64 x 16, bf16 in registers) * B (16 x 32,
  // MN-major in shared memory)
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  // D (64 x 64, fp32) (+)= A (64 x 16, K-major in shared memory) * B (64 x 16,
  // K-major in shared memory)^T
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // D (64 x 64, fp32) (+)= A (64 x 16, bf16 in registers) * B (16 x 64,
  // MN-major in shared memory)
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<80> {
  // D (64 x 80, fp32) (+)= A (64 x 16, bf16 in registers) * B (16 x 80,
  // MN-major in shared memory: five 16-column parts of 32-byte rows, LBO
  // apart)
  static __device__ __forceinline__ void rs(float (&d)[40], const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  // D (64 x 128, fp32) (+)= A (64 x 16, bf16 in registers) * B (16 x 128,
  // MN-major in shared memory)
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// ---- host: TMA tensor maps --------------------------------------------------

// cuTensorMapEncodeTiled, looked up at run time through the runtime API, so
// that nothing links libcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// bytes of an element of a tensor map of type `dtype` (bf16 or fp32)
inline int elem_bytes(CUtensorMapDataType dtype) {
  return dtype == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
}

// A bf16 (or `dtype`: fp32) tensor of 4 dimensions, innermost first
// (dims[0] contiguous), strides of dims 1-3 in elements (16-byte multiples:
// TMA's rule), read in boxes of box[0] x ... x box[3] elements, the bytes of
// a box row swizzled by `swizzle_bytes` (0 for none, or 32, 64, 128, equal
// to the row). Reads past a dimension's end come back as zeros.
inline cudaError_t make_map(CUtensorMap* map, const void* base, const long long dims[4],
                            const long long strides[3], const int box_dims[4],
                            int swizzle_bytes,
                            CUtensorMapDataType dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  cuuint64_t gdim[4], gstride[3];
  for (int i = 0; i < 4; ++i) gdim[i] = (cuuint64_t)dims[i];
  for (int i = 0; i < 3; ++i) gstride[i] = (cuuint64_t)strides[i] * elem_bytes(dtype);
  cuuint32_t box[4];
  for (int i = 0; i < 4; ++i) box[i] = (cuuint32_t)box_dims[i];
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz =
      swizzle_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : swizzle_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
      : swizzle_bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                            : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUresult r = encode(map, dtype, 4,
                            const_cast<void*>(base), gdim, gstride, box, estride,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A 2-d byte matrix of `rows` rows of `cols` bytes, rows `stride` bytes
// apart (a multiple of 16, as is the base's address), read in boxes of
// box_rows rows of 128 bytes with the 128-byte swizzle. Reads past an end
// come back as zeros.
inline cudaError_t make_map_u8(CUtensorMap* map, const void* base, long long cols,
                               long long rows, long long stride, int box_rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (stride % 16 || reinterpret_cast<uintptr_t>(base) % 16) return cudaErrorInvalidValue;
  const cuuint64_t gdim[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t gstride[1] = {(cuuint64_t)stride};
  const cuuint32_t box[2] = {128, (cuuint32_t)box_rows};
  const cuuint32_t estride[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
                            gdim, gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor map of a (B, H, T, Dh) bf16 (or `dtype`: fp32) operand with
// element strides (sb, sh, st) and a contiguous last dimension, read in
// boxes of `rows` rows of `cols` columns: its dimensions are ordered (d, t,
// h, b), or (d, h, t, b) (`swap`) where h has the smaller stride. A
// dimension of extent 1 has its coordinate at 0, so its stride is set to one
// TMA takes.
inline cudaError_t map_rows(CUtensorMap* map, const void* base, long long sb, long long sh,
                            long long st, int B, int H, int T, int Dh, int cols, int rows,
                            int swizzle, bool* swap,
                            CUtensorMapDataType dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  if (T == 1) st = Dh;
  if (H == 1) sh = st * T;
  if (B == 1) sb = st * T > sh * H ? st * T : sh * H;
  const int align = 16 / elem_bytes(dtype);  // elements of 16 bytes
  if (st % align || sh % align || sb % align || reinterpret_cast<uintptr_t>(base) % 16)
    return cudaErrorInvalidValue;
  *swap = sh < st;
  const long long dims[4] = {Dh, *swap ? H : T, *swap ? T : H, B};
  const long long strides[3] = {*swap ? sh : st, *swap ? st : sh, sb};
  // a swapped map reads a box of 1 head by `rows` rows
  const int box[4] = {cols, *swap ? 1 : rows, *swap ? rows : 1, 1};
  return make_map(map, base, dims, strides, box, swizzle, dtype);
}

// The tensor map of a (B, H, Tq, Tk) bf16 (or `dtype`: fp32) bias whose rows
// are `rs` elements apart (16-byte multiples), read in boxes of `rows` rows
// of 128 bytes of keys (64 bf16, 32 fp32), 128-byte swizzled.
inline cudaError_t map_bias(CUtensorMap* map, const void* base, long long rs, int B, int H,
                            int Tq, int Tk, int rows,
                            CUtensorMapDataType dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  if (rs % (16 / elem_bytes(dtype)) || rs < Tk || reinterpret_cast<uintptr_t>(base) % 16)
    return cudaErrorInvalidValue;
  const long long dims[4] = {Tk, Tq, H, B};
  const long long strides[3] = {rs, rs * Tq, rs * Tq * H};
  const int box[4] = {128 / elem_bytes(dtype), rows, 1, 1};
  return make_map(map, base, dims, strides, box, 128, dtype);
}


// Allows `bytes` of dynamic shared memory for `kernel` (needed above 48 KB).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace hopper
