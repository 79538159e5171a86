// Flash-attention backward for Hopper (sm_90a): two kernels, dK/dV and dQ.
//
// Replaces: ray_tpu/ops/attention.py, `_dkv_kernel` and `_dq_kernel` driven
// by `_bwd_pallas` (the classic Pallas TPU backward), and with them the
// function of the pipelined TPU backward `_bwd_pipe_tpu` (and its interpret
// twin `_bwd_pipe_interp`), which computes the same gradients on a skewed
// schedule.
//
// The math is Dao et al. alg. 2 as the TPU kernels do it. P is recomputed
// from the forward's natural-log lse:
//   s  = q.k^T * sm_scale * log2(e), masked (col < skv; col <= row if causal)
//   p  = exp2(s - lse * log2(e))
//   dV += round(p)^T . dO          dP = dO . V^T
//   dS = p * (dP - delta) * sm_scale
//   dK += round(dS)^T . Q          dQ += round(dS) . K
// `round` is the cast to the input dtype (the TPU kernel's .astype), every
// sum is f32, and dq/dk/dv are written in the input dtype. delta =
// rowsum(dO * O) comes from the wrapper in f32, as JAX computes it outside
// its kernels. The plain PyTorch version is `_flash_bwd_plain` in
// ray_tpu_torch/ops/attention.py.
//
// What bounds it on the H100: operations. The function does 5 products of
// 2 * D flops per unmasked (q, k) pair against 10 (S, D)-sized reads and
// writes per head, so at S 1024 it sits far above the ~295 flop/byte ridge
// and the limit is the bf16 tensor-core rate (989 TFLOP/s).
//
// What the design does about it. Both dtypes share the work split:
// - dkv kernel: a block owns one kv tile of one kv head (of one batch row).
//   K_j and V_j stay in shared memory for the whole block. The block walks
//   the q heads of the kv head's GQA group and, for each, the q tiles from
//   the causal diagonal to the end, so a kv head is never repeated in
//   memory and the group sum that JAX does after its kernel happens in the
//   f32 accumulators. Each tile recomputes S and dP (2 products) and adds
//   into dV and dK (2 more).
// - dq kernel: a block owns one q tile of one q head. Q_i and dO_i stay in
//   shared memory; K/V tiles of kv head h / groups stream through up to the
//   causal diagonal. It recomputes S and dP and adds into dQ.
// - No atomics: every output element has one owner block, so the gradients
//   are deterministic run to run. The price: both kernels recompute S and
//   dP, 7 products where the function needs 5.
// - q rows at or past S and kv rows at or past Skv are masked inside the
//   kernels (the JAX wrapper pads instead and relies on zero dO in the pad).
//
// bf16 (the train path's dtype) runs on the tensor cores: `wgmma` products
// fed by `cp.async` copies into 128-byte-swizzled shared memory, through a
// two-stage ring, so the next tile's copy overlaps the current tile's
// products (the overlap K4's skewed schedule, `_bwd_pipe_tpu`, buys on the
// TPU). Each consumer warpgroup owns a 64-row slice of the block's tile:
// - dkv: kv rows are M. S^T = K Q^T and dP^T = V dO^T come out with one
//   kv row per accumulator row, so lse and delta are per-column values,
//   read from the stage once per q tile. round(P^T) and round(dS^T) stay in
//   registers and are the A operand of dV += P^T dO and dK += dS^T Q; B (dO,
//   Q) is read MN-major from the same stage through the transpose bit.
// - dq: q rows are M. S = Q K^T, dP = dO V^T, and round(dS) in registers is
//   the A operand of dQ += dS K with K read MN-major.
// - Only tiles on the causal diagonal or on the ragged edge apply the mask.
// f32 keeps the first version's scalar FMA kernels: wgmma on f32 inputs
// runs in TF32, which would break the f32 contract (1e-4 against the plain
// version), and no main path runs the backward in f32. They read f32
// tiles padded to D+1 columns from shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tiles.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------ f32: scalar FMA kernels

constexpr int kThreads = 256;  // 16 x 16: tx walks columns / head dims, ty rows
constexpr int kBlockQ = 64;
constexpr int kBlockKV = 64;
constexpr int kRI = kBlockQ / 16;   // score rows per thread: ty + 16 * i
constexpr int kCJ = kBlockKV / 16;  // score columns per thread: tx + 16 * j
constexpr int kPS = kBlockKV + 1;   // row stride of the (64, 64) score tiles in shared memory

// T is float only (bf16 takes the wgmma kernels below); the conversions
// keep the templates' shape.
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

// x rounded to the input dtype, as the TPU kernel's .astype(q.dtype)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// 64 rows of a (rows, D) slab from row r0 into s[64][D+1] as f32; rows at
// or past `limit` read as zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* s, const T* __restrict__ src, int r0,
                                          int limit, int tid) {
  for (int idx = tid; idx < 64 * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    s[r * (D + 1) + d] = r0 + r < limit ? to_f32(src[(size_t)(r0 + r) * D + d]) : 0.f;
  }
}

// acc[i][j] += sum_d a[ty + 16i][d] * b[tx + 16j][d]   (a, b: (64, D+1))
template <int D>
__device__ __forceinline__ void mm_abt(const float* a, const float* b, int tx, int ty,
                                       float (&acc)[kRI][kCJ]) {
  for (int d = 0; d < D; ++d) {
    float av[kRI], bv[kCJ];
#pragma unroll
    for (int i = 0; i < kRI; ++i) av[i] = a[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < kCJ; ++j) bv[j] = b[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < kRI; ++i)
#pragma unroll
      for (int j = 0; j < kCJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[a][c] += sum_r p[r][ty + 16a] * x[r][tx + 16c]   (p: (64, kPS), x: (64, D+1))
template <int D>
__device__ __forceinline__ void mm_atb(const float* p, const float* x, int tx, int ty,
                                       float (&acc)[kRI][D / 16]) {
  for (int r = 0; r < kBlockQ; ++r) {
    float pv[kRI], xv[D / 16];
#pragma unroll
    for (int a = 0; a < kRI; ++a) pv[a] = p[r * kPS + ty + 16 * a];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) xv[c] = x[r * (D + 1) + tx + 16 * c];
#pragma unroll
    for (int a = 0; a < kRI; ++a)
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[a][c] = fmaf(pv[a], xv[c], acc[a][c]);
  }
}

// acc[a][c] += sum_k p[ty + 16a][k] * x[k][tx + 16c]   (p: (64, kPS), x: (64, D+1))
template <int D>
__device__ __forceinline__ void mm_ab(const float* p, const float* x, int tx, int ty,
                                      float (&acc)[kRI][D / 16]) {
  for (int k = 0; k < kBlockKV; ++k) {
    float pv[kRI], xv[D / 16];
#pragma unroll
    for (int a = 0; a < kRI; ++a) pv[a] = p[(ty + 16 * a) * kPS + k];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) xv[c] = x[k * (D + 1) + tx + 16 * c];
#pragma unroll
    for (int a = 0; a < kRI; ++a)
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[a][c] = fmaf(pv[a], xv[c], acc[a][c]);
  }
}

// Row statistics of q tile q0 into shared memory: lse * log2(e) and delta.
__device__ __forceinline__ void load_rows(float* s_lse, float* s_delta,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta, int q0, int sq,
                                          int tid) {
  if (tid < kBlockQ) {
    const bool in = q0 + tid < sq;
    s_lse[tid] = in ? lse[q0 + tid] * kLog2e : 0.f;
    s_delta[tid] = in ? delta[q0 + tid] : 0.f;
  }
}

// p and dS of one (q tile, kv tile) pair from the raw scores and dP.
// Writes round(p) to s_p (when given) and round(dS) to s_ds, both q-major.
template <typename T>
__device__ __forceinline__ void p_and_ds(const float (&s)[kRI][kCJ], const float (&dp)[kRI][kCJ],
                                         const float* s_lse, const float* s_delta, float* s_p,
                                         float* s_ds, int q0, int c0, int sq, int skv,
                                         int causal, float scale_log2, float sm_scale, int tx,
                                         int ty) {
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    const int r = ty + 16 * i;
    const int row = q0 + r;
#pragma unroll
    for (int j = 0; j < kCJ; ++j) {
      const int c = tx + 16 * j;
      const int col = c0 + c;
      const bool keep = row < sq && col < skv && (!causal || col <= row);
      const float p = keep ? exp2f(s[i][j] * scale_log2 - s_lse[r]) : 0.f;
      const float ds = p * (dp[i][j] - s_delta[r]) * sm_scale;
      if (s_p != nullptr) s_p[r * kPS + c] = round_to<T>(p);
      s_ds[r * kPS + c] = round_to<T>(ds);
    }
  }
}

// Shared memory of both kernels, in floats: four (64, D+1) tiles, two
// (64, 65) score tiles and two 64-row statistics.
template <int D>
constexpr int smem_floats() {
  return 4 * 64 * (D + 1) + 2 * kBlockQ * kPS + 2 * kBlockQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int num_q_heads,
                     int num_kv_heads, int sq, int skv, int causal, float scale_log2,
                     float sm_scale) {
  constexpr int kDI = D / 16;
  const int kt = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int groups = num_q_heads / num_kv_heads;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kBlockKV * (D + 1);
  float* sQ = sV + kBlockKV * (D + 1);
  float* sDO = sQ + kBlockQ * (D + 1);
  float* sP = sDO + kBlockQ * (D + 1);
  float* sDS = sP + kBlockQ * kPS;
  float* sLse = sDS + kBlockQ * kPS;
  float* sDelta = sLse + kBlockQ;

  const int c0 = kt * kBlockKV;
  const size_t kv_off = ((size_t)b * num_kv_heads + hk) * skv * D;
  load_tile<T, D>(sK, k + kv_off, c0, skv, tid);
  load_tile<T, D>(sV, v + kv_off, c0, skv, tid);

  float acc_k[kRI][kDI], acc_v[kRI][kDI];
#pragma unroll
  for (int a = 0; a < kRI; ++a)
#pragma unroll
    for (int c = 0; c < kDI; ++c) acc_k[a][c] = acc_v[a][c] = 0.f;

  const int n_q_tiles = (sq + kBlockQ - 1) / kBlockQ;
  // causal: q tiles strictly above the diagonal band contribute nothing
  const int t_start = causal ? c0 / kBlockQ : 0;

  for (int g = 0; g < groups; ++g) {
    const int h = hk * groups + g;
    const size_t q_off = ((size_t)b * num_q_heads + h) * sq * D;
    const size_t row_off = ((size_t)b * num_q_heads + h) * sq;
    for (int t = t_start; t < n_q_tiles; ++t) {
      const int q0 = t * kBlockQ;
      __syncthreads();  // the previous tile's reads of sQ / sDO / sP / sDS are done
      load_tile<T, D>(sQ, q + q_off, q0, sq, tid);
      load_tile<T, D>(sDO, dout + q_off, q0, sq, tid);
      load_rows(sLse, sDelta, lse + row_off, delta + row_off, q0, sq, tid);
      __syncthreads();

      float s[kRI][kCJ], dp[kRI][kCJ];
#pragma unroll
      for (int i = 0; i < kRI; ++i)
#pragma unroll
        for (int j = 0; j < kCJ; ++j) s[i][j] = dp[i][j] = 0.f;
      mm_abt<D>(sQ, sK, tx, ty, s);
      mm_abt<D>(sDO, sV, tx, ty, dp);
      p_and_ds<T>(s, dp, sLse, sDelta, sP, sDS, q0, c0, sq, skv, causal, scale_log2,
                  sm_scale, tx, ty);
      __syncthreads();
      mm_atb<D>(sP, sDO, tx, ty, acc_v);   // dV_j += round(P)^T dO
      mm_atb<D>(sDS, sQ, tx, ty, acc_k);   // dK_j += round(dS)^T Q
    }
  }

#pragma unroll
  for (int a = 0; a < kRI; ++a) {
    const int row = c0 + ty + 16 * a;
    if (row >= skv) continue;
#pragma unroll
    for (int c = 0; c < kDI; ++c) {
      const size_t at = kv_off + (size_t)row * D + tx + 16 * c;
      dk[at] = from_f32<T>(acc_k[a][c]);
      dv[at] = from_f32<T>(acc_v[a][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int num_q_heads, int num_kv_heads, int sq, int skv,
                    int causal, float scale_log2, float sm_scale) {
  constexpr int kDI = D / 16;
  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (num_q_heads / num_kv_heads);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + kBlockQ * (D + 1);
  float* sK = sDO + kBlockQ * (D + 1);
  float* sV = sK + kBlockKV * (D + 1);
  float* sDS = sV + kBlockKV * (D + 1);
  float* sLse = sDS + 2 * kBlockQ * kPS;  // the second score tile is unused here
  float* sDelta = sLse + kBlockQ;

  const int q0 = qt * kBlockQ;
  const size_t q_off = ((size_t)b * num_q_heads + h) * sq * D;
  const size_t row_off = ((size_t)b * num_q_heads + h) * sq;
  const size_t kv_off = ((size_t)b * num_kv_heads + hk) * skv * D;
  load_tile<T, D>(sQ, q + q_off, q0, sq, tid);
  load_tile<T, D>(sDO, dout + q_off, q0, sq, tid);
  load_rows(sLse, sDelta, lse + row_off, delta + row_off, q0, sq, tid);

  float acc_q[kRI][kDI];
#pragma unroll
  for (int a = 0; a < kRI; ++a)
#pragma unroll
    for (int c = 0; c < kDI; ++c) acc_q[a][c] = 0.f;

  int n_tiles = (skv + kBlockKV - 1) / kBlockKV;
  if (causal) n_tiles = min(n_tiles, (q0 + kBlockQ - 1) / kBlockKV + 1);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int c0 = kt * kBlockKV;
    __syncthreads();  // the previous tile's reads of sK / sDS are done
    load_tile<T, D>(sK, k + kv_off, c0, skv, tid);
    load_tile<T, D>(sV, v + kv_off, c0, skv, tid);
    __syncthreads();

    float s[kRI][kCJ], dp[kRI][kCJ];
#pragma unroll
    for (int i = 0; i < kRI; ++i)
#pragma unroll
      for (int j = 0; j < kCJ; ++j) s[i][j] = dp[i][j] = 0.f;
    mm_abt<D>(sQ, sK, tx, ty, s);
    mm_abt<D>(sDO, sV, tx, ty, dp);
    p_and_ds<T>(s, dp, sLse, sDelta, nullptr, sDS, q0, c0, sq, skv, causal, scale_log2,
                sm_scale, tx, ty);
    __syncthreads();
    mm_ab<D>(sDS, sK, tx, ty, acc_q);  // dQ_i += round(dS) K
  }

#pragma unroll
  for (int a = 0; a < kRI; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= sq) continue;
#pragma unroll
    for (int c = 0; c < kDI; ++c)
      dq[q_off + (size_t)row * D + tx + 16 * c] = from_f32<T>(acc_q[a][c]);
  }
}

// ------------------------------------ bf16: wgmma kernels (sm_90a only)
//
// The swizzled tile layout, the cp.async copies and the wgmma products are
// in hopper_tiles.cuh.

using namespace hopper;

// 64 rows of lse (threads 0-63) and delta (threads 64-127) from row r0
// into two float[64] at dst; rows at or past `limit` read as zero. 4-byte
// copies: a head's rows start at any float when Sq is odd.
__device__ __forceinline__ void load_rows_async(uint32_t dst, const float* __restrict__ lse,
                                                const float* __restrict__ delta, int r0,
                                                int limit, int tid) {
  const int r = tid & 63;
  const bool ok = r0 + r < limit;
  cp_async4(dst + 4 * tid, (tid < 64 ? lse : delta) + (ok ? r0 + r : 0), ok);
}

template <int D>
constexpr size_t wgmma_smem() {
  // two resident (64, D) tiles, two stages of two streamed ones, the dkv
  // kernel's two stages of (lse, delta), alignment slack
  return 2 * (64 * D * 2) + 2 * 2 * (64 * D * 2) + 2 * 512 + 1024;
}

template <int D>
__global__ void __launch_bounds__(kNT, 1)
flash_bwd_dkv_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, int num_q_heads,
                    int num_kv_heads, int sq, int skv, int causal, float scale_log2,
                    float sm_scale) {
  constexpr int kC = D / 64;               // 64-column chunks of a row
  constexpr uint32_t kTile = 64 * D * 2;   // one (64, D) bf16 tile

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023u) & ~1023u;
  const uint32_t sV = sK + kTile;
  const uint32_t sStage = sV + kTile;         // stage s: Q at + 2 s kTile, dO after it
  const uint32_t sRows = sStage + 4 * kTile;  // stage s: lse[64], delta[64] at + 512 s
  const float* rows_ptr = reinterpret_cast<const float*>(smem_raw + (sRows - raw));

  const int tid = threadIdx.x;
  const int warp = tid >> 5;  // accumulator rows 16 warp .. 16 warp + 15
  const int lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int groups = num_q_heads / num_kv_heads;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int c0 = blockIdx.x * 64;
  const size_t kv_off = ((size_t)b * num_kv_heads + hk) * skv * D;

  const int n_q_tiles = (sq + 63) / 64;
  const int t_start = causal ? c0 / 64 : 0;  // q tiles above the diagonal add nothing
  const int nt = max(n_q_tiles - t_start, 0);
  const int n_iter = groups * nt;            // (q head of the group, q tile) pairs

  // step `it` of the walk: q head hk * groups + it / nt, q tile t_start + it % nt
  auto prefetch = [&](int it) {
    const int h = hk * groups + it / nt;
    const int q0 = (t_start + it % nt) * 64;
    const uint32_t st = sStage + (it & 1) * 2 * kTile;
    const size_t q_off = ((size_t)b * num_q_heads + h) * sq * D;
    const size_t row_off = ((size_t)b * num_q_heads + h) * sq;
    load_tile_async<D>(st, q + q_off, q0, sq, tid);
    load_tile_async<D>(st + kTile, dout + q_off, q0, sq, tid);
    load_rows_async(sRows + (it & 1) * 512, lse + row_off, delta + row_off, q0, sq, tid);
  };

  load_tile_async<D>(sK, k + kv_off, c0, skv, tid);
  load_tile_async<D>(sV, v + kv_off, c0, skv, tid);
  if (n_iter > 0) prefetch(0);
  cp_async_commit();

  float acc_dk[kC][32], acc_dv[kC][32];
#pragma unroll
  for (int c = 0; c < kC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_dk[c][i] = acc_dv[c][i] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    if (it + 1 < n_iter) prefetch(it + 1);  // overlaps this step's products
    cp_async_commit();
    cp_async_wait<1>();  // this step's stage (and K, V) have landed
    fence_proxy_async();
    __syncthreads();
    const int q0 = (t_start + it % nt) * 64;
    const uint32_t sQ = sStage + (it & 1) * 2 * kTile;
    const uint32_t sDO = sQ + kTile;
    const float* s_lse = rows_ptr + (it & 1) * 128;
    const float* s_delta = s_lse + 64;
    // Four commit groups, so the math of one product runs while the next is
    // on the tensor cores: S^T = K Q^T | dP^T = V dO^T (P^T meanwhile) |
    // dV += P^T dO (dS^T meanwhile) | dK += dS^T Q.
    float s[32], dp[32];  // the first k step overwrites them
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      mma_ss(s, desc_k(sK + kstep(ks)), desc_k(sQ + kstep(ks)), ks > 0);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      mma_ss(dp, desc_k(sV + kstep(ks)), desc_k(sDO + kstep(ks)), ks > 0);
    wgmma_commit();
    wgmma_wait<1>();
    pin(s);
    // P^T in place; columns are q rows. A slice past Skv or wholly above
    // the diagonal runs too and masks to zero: a branch around wgmma that
    // the compiler cannot prove warpgroup-uniform serializes every wgmma of
    // the kernel (ptxas C7520).
    const bool edge = q0 + 64 > sq || c0 + 64 > skv || (causal && c0 + 63 > q0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 8 * i + 2 * tq + j;
        const float lse2 = s_lse[col] * kLog2e;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int idx = 4 * i + 2 * hh + j;
          float p = ex2_ftz(s[idx] * scale_log2 - lse2);
          if (edge) {
            const int kv = c0 + 16 * warp + g + 8 * hh, qr = q0 + col;
            if (qr >= sq || kv >= skv || (causal && kv > qr)) p = 0.f;
          }
          s[idx] = p;
        }
      }
    }
    uint32_t pa[16];  // round(P^T): A fragments of the 4 k steps over 64 q rows
#pragma unroll
    for (int r = 0; r < 16; ++r) pa[r] = pack_bf16(s[2 * r], s[2 * r + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < kC; ++c)
        mma_rs(acc_dv[c], &pa[4 * kk], desc_mn(sDO + c * kChunk + kk * 16 * 128));
    wgmma_commit();
    wgmma_wait<1>();  // dP^T has landed; dV may still run
    pin(dp);
    uint32_t dsa[16];  // round(dS^T)
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float dl0 = s_delta[8 * (r >> 1) + 2 * tq], dl1 = s_delta[8 * (r >> 1) + 2 * tq + 1];
      dsa[r] = pack_bf16(s[2 * r] * (dp[2 * r] - dl0) * sm_scale,
                         s[2 * r + 1] * (dp[2 * r + 1] - dl1) * sm_scale);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < kC; ++c)
        mma_rs(acc_dk[c], &dsa[4 * kk], desc_mn(sQ + c * kChunk + kk * 16 * 128));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      pin(acc_dk[c]);
      pin(acc_dv[c]);
    }
    __syncthreads();  // the stage is read; the next step's copy may overwrite it
  }

#pragma unroll
  for (int c = 0; c < kC; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = c0 + 16 * warp + g + 8 * hh;
        if (row >= skv) continue;
        const size_t at = kv_off + (size_t)row * D + 64 * c + 8 * i + 2 * tq;
        const int idx = 4 * i + 2 * hh;
        *reinterpret_cast<__nv_bfloat162*>(dk + at) =
            __floats2bfloat162_rn(acc_dk[c][idx], acc_dk[c][idx + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(acc_dv[c][idx], acc_dv[c][idx + 1]);
      }
}

template <int D>
__global__ void __launch_bounds__(kNT, 1)
flash_bwd_dq_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dq, int num_q_heads, int num_kv_heads, int sq, int skv,
                   int causal, float scale_log2, float sm_scale) {
  constexpr int kC = D / 64;
  constexpr uint32_t kTile = 64 * D * 2;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sDO = sQ + kTile;
  const uint32_t sStage = sDO + kTile;  // stage s: K at + 2 s kTile, V after it

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;  // causal: the longest walks start first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (num_q_heads / num_kv_heads);
  const int q0 = qt * 64;
  const size_t q_off = ((size_t)b * num_q_heads + h) * sq * D;
  const size_t row_off = ((size_t)b * num_q_heads + h) * sq;
  const size_t kv_off = ((size_t)b * num_kv_heads + hk) * skv * D;

  int n_tiles = (skv + 63) / 64;
  if (causal) n_tiles = min(n_tiles, q0 / 64 + 1);

  auto prefetch = [&](int it) {
    const uint32_t st = sStage + (it & 1) * 2 * kTile;
    load_tile_async<D>(st, k + kv_off, it * 64, skv, tid);
    load_tile_async<D>(st + kTile, v + kv_off, it * 64, skv, tid);
  };

  load_tile_async<D>(sQ, q + q_off, q0, sq, tid);
  load_tile_async<D>(sDO, dout + q_off, q0, sq, tid);
  if (n_tiles > 0) prefetch(0);
  cp_async_commit();

  // this thread's two accumulator rows: lse * log2(e) and delta
  float lse2[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + 16 * warp + g + 8 * hh;
    lse2[hh] = row < sq ? lse[row_off + row] * kLog2e : 0.f;
    dl[hh] = row < sq ? delta[row_off + row] : 0.f;
  }

  float acc[kC][32];
#pragma unroll
  for (int c = 0; c < kC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) prefetch(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    const int c0 = it * 64;
    const uint32_t sK = sStage + (it & 1) * 2 * kTile;
    const uint32_t sV = sK + kTile;
    // S = Q K^T | dP = dO V^T (P meanwhile) | dQ += dS K; no branch around
    // the products, as in the dkv kernel
    float s[32], dp[32];  // the first k step overwrites them
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      mma_ss(s, desc_k(sQ + kstep(ks)), desc_k(sK + kstep(ks)), ks > 0);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      mma_ss(dp, desc_k(sDO + kstep(ks)), desc_k(sV + kstep(ks)), ks > 0);
    wgmma_commit();
    wgmma_wait<1>();
    pin(s);
    const bool edge = q0 + 64 > sq || c0 + 64 > skv || (causal && c0 + 63 > q0);
#pragma unroll
    for (int idx = 0; idx < 32; ++idx) {
      const int hh = (idx >> 1) & 1;
      float p = ex2_ftz(s[idx] * scale_log2 - lse2[hh]);
      if (edge) {
        const int row = q0 + 16 * warp + g + 8 * hh;
        const int col = c0 + 8 * (idx >> 2) + 2 * tq + (idx & 1);
        if (row >= sq || col >= skv || (causal && col > row)) p = 0.f;
      }
      s[idx] = p;
    }
    wgmma_wait<0>();
    pin(dp);
    uint32_t dsa[16];  // round(dS): A fragments of the 4 k steps over 64 kv rows
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float dlr = dl[r & 1];
      dsa[r] = pack_bf16(s[2 * r] * (dp[2 * r] - dlr) * sm_scale,
                         s[2 * r + 1] * (dp[2 * r + 1] - dlr) * sm_scale);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < kC; ++c)
        mma_rs(acc[c], &dsa[4 * kk], desc_mn(sK + c * kChunk + kk * 16 * 128));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kC; ++c) pin(acc[c]);
    __syncthreads();
  }

#pragma unroll
  for (int c = 0; c < kC; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = q0 + 16 * warp + g + 8 * hh;
        if (row >= sq) continue;
        const int idx = 4 * i + 2 * hh;
        *reinterpret_cast<__nv_bfloat162*>(dq + q_off + (size_t)row * D + 64 * c + 8 * i + 2 * tq) =
            __floats2bfloat162_rn(acc[c][idx], acc[c][idx + 1]);
      }
}

// ----------------------------------------------------------------- launch

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int batch, num_q_heads, num_kv_heads, sq, skv, causal;
  float scale_log2, sm_scale;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_dkv(const Args& a) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.skv + kBlockKV - 1) / kBlockKV, a.num_kv_heads, a.batch);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.num_q_heads, a.num_kv_heads, a.sq, a.skv, a.causal,
      a.scale_log2, a.sm_scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const Args& a) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.sq + kBlockQ - 1) / kBlockQ, a.num_q_heads, a.batch);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dq), a.num_q_heads,
      a.num_kv_heads, a.sq, a.skv, a.causal, a.scale_log2, a.sm_scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_wgmma(const Args& a) {
  const size_t smem = wgmma_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.skv + 63) / 64, a.num_kv_heads, a.batch);
  flash_bwd_dkv_wgmma<D><<<grid, kNT, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.delta,
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.num_q_heads, a.num_kv_heads, a.sq,
      a.skv, a.causal, a.scale_log2, a.sm_scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_wgmma(const Args& a) {
  const size_t smem = wgmma_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.sq + 63) / 64, a.num_q_heads, a.batch);
  flash_bwd_dq_wgmma<D><<<grid, kNT, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.delta,
      static_cast<bf16*>(a.dq), a.num_q_heads, a.num_kv_heads, a.sq, a.skv, a.causal,
      a.scale_log2, a.sm_scale);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32 (FMA kernels), 1 = bfloat16 (wgmma kernels); head_dim 64 or 128.
template <bool kDkv>
int dispatch(int dtype, int head_dim, const Args& a) {
  if (a.batch == 0 || a.sq == 0 || a.skv == 0) return 0;
  if (a.num_kv_heads <= 0 || a.num_q_heads % a.num_kv_heads) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && head_dim == 64) return kDkv ? launch_dkv<float, 64>(a) : launch_dq<float, 64>(a);
  if (dtype == 0 && head_dim == 128)
    return kDkv ? launch_dkv<float, 128>(a) : launch_dq<float, 128>(a);
  if (dtype == 1 && head_dim == 64) return kDkv ? launch_dkv_wgmma<64>(a) : launch_dq_wgmma<64>(a);
  if (dtype == 1 && head_dim == 128)
    return kDkv ? launch_dkv_wgmma<128>(a) : launch_dq_wgmma<128>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, dout (B, Hq, Sq, D); k, v, dk, dv (B, Hkv, Skv, D); lse, delta (B, Hq, Sq)
// float32. dk and dv hold the sums over each kv head's GQA group. Returns
// cudaGetLastError() after the launch.
int flash_attention_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dk, void* dv, int dtype, int head_dim, int batch,
                                   int num_q_heads, int num_kv_heads, int sq, int skv,
                                   int causal, float scale_log2, float sm_scale,
                                   void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
         nullptr, dk, dv, batch, num_q_heads, num_kv_heads, sq, skv, causal, scale_log2,
         sm_scale, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(dtype, head_dim, a);
}

// Same inputs; dq (B, Hq, Sq, D).
int flash_attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  void* dq, int dtype, int head_dim, int batch,
                                  int num_q_heads, int num_kv_heads, int sq, int skv,
                                  int causal, float scale_log2, float sm_scale,
                                  void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
         dq, nullptr, nullptr, batch, num_q_heads, num_kv_heads, sq, skv, causal, scale_log2,
         sm_scale, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(dtype, head_dim, a);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
