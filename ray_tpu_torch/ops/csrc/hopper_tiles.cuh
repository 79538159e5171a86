// Building blocks of the bf16 flash-attention kernels on Hopper (sm_90a):
// asynchronous tile copies into swizzled shared memory and `wgmma` products
// by inline PTX. Included by flash_attention_fwd.cu and
// flash_attention_bwd.cu; everything is an inline device function.
//
// Shared-memory tiles are bf16 in wgmma's 128-byte-swizzled layout: a
// (rows, D) tile is D / 64 column chunks of (rows, 64), each chunk `rows`
// rows of 128 bytes, and the 16-byte group g of row r sits at group
// g ^ (r % 8). Eight rows form one 1024-byte swizzle atom, so every tile
// starts on a 1024-byte boundary.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

using bf16 = __nv_bfloat16;

// One warpgroup (128 threads) per block, one 64-row tile each. Blocks of
// one warpgroup run out of step with each other, so one block's exp2 and
// packing overlap another's wgmma on the same SM; two warpgroups per
// block, in step through their barriers, ran dkv 13% and dq 30% slower at
// the GPT-2 shape on the H100.
constexpr int kNT = 128;
constexpr uint32_t kChunk = 64 * 128;  // one 64-column chunk of a 64-row tile, bytes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (4) bytes global -> shared without passing through registers;
// the destination is zero-filled when !valid (rows past the ragged edge)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// makes this thread's completed copies visible to wgmma's (async proxy) reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// rows [r0, r0 + 64) of a (rows, D) slab into the swizzled tile at dst;
// rows at or past `limit` read as zero. The block's threads share the
// copy, 16 bytes each, neighbouring threads on neighbouring addresses.
template <int D>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const bf16* __restrict__ src,
                                                int r0, int limit, int tid) {
  constexpr int kPerRow = D / 8;
#pragma unroll
  for (int i = 0; i < 64 * kPerRow / kNT; ++i) {
    const int p = tid + i * kNT;
    const int r = p / kPerRow, g = p % kPerRow;
    const uint32_t off = (g >> 3) * kChunk + r * 128 + (((g & 7) ^ (r & 7)) << 4);
    const bool ok = r0 + r < limit;
    cp_async16(dst + off, src + (ok ? (size_t)(r0 + r) * D + g * 8 : 0), ok);
  }
}

// wgmma shared-memory descriptor of a 128B-swizzled operand (layout type 1)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// K-major operand: addr is a chunk's first row plus 32 bytes per 16-element
// k step inside the 128-byte rows; 8-row groups lie 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) { return make_desc(addr, 16, 1024); }
// MN-major operand (B through the transpose bit): addr is the chunk's row
// 16 * k_step; along K, 8-row groups lie 1024 bytes apart. Every B here is
// one 64-wide chunk, so the stride between 64-wide blocks along N is never
// read; both offsets carry 1024.
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) { return make_desc(addr, 1024, 1024); }

// 2^x on the hardware's approximation (MUFU.EX2, a couple of f32 ulps), the
// unit exp2f reaches through extra instructions that keep results below
// 2^-126; those flush to zero here, far under bf16's rounding of P.
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N of this warpgroup's committed groups are in flight
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of d across a wgmma wait
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_ACC32(d)                                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define WG_D32                                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64, f32) = A (64 x 16) . B (16 x 64) + (acc ? d : 0), A and B
// K-major in shared memory. Accumulator element i of a thread sits at row
// 16 * warp + lane / 4 + 8 * ((i >> 1) & 1), column 8 * (i >> 2) +
// 2 * (lane % 4) + (i & 1).
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC32(d)
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 64, f32) += A (64 x 16, four bf16x2 registers) . B (16 x 64),
// B MN-major in shared memory. A's fragment is the accumulator layout of a
// 64 x 16 tile: a[r] holds elements 2r, 2r + 1 of accumulator columns
// 16 k .. 16 k + 15, so a packed S accumulator feeds the next product.
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// byte offset of k step ks (16 columns) in a K-major (64, D) tile
__device__ __forceinline__ uint32_t kstep(int ks) { return (ks >> 2) * kChunk + (ks & 3) * 32; }

}  // namespace hopper
