// Flash-attention forward for Hopper (sm_90a).
//
// Replaces: ray_tpu/ops/attention.py, `_fwd_kernel` driven by `_fwd_pallas`
// (the classic Pallas TPU forward), and the pipelined TPU forward
// `_fwd_pipe_tpu` (with its interpret twin `_fwd_pipe_interp`), which
// computes the same outputs on a skewed schedule.
//
// What bounds it on the H100: operations. A (64-row q tile, kv tile) pair
// does 4 * 64 * 64 * D flops on 2 * 64 * D loaded elements, so long
// sequences are far above the ~295 flop/byte ridge and the limit is the
// multiply rate: 989 TFLOP/s in bf16 on the tensor cores. Between the two
// products of a tile sits the online softmax (a row max, 64 * 64 exp2, a
// row sum, the rescale of O) on the ordinary cores; run one after the
// other, the three leave the tensor cores idle for most of a tile.
//
// What the design does about it. One block (one warpgroup) per (64-row q
// tile, q head, batch), the longest causal walks first; GQA maps q head h
// onto kv head h / groups, so a kv head is never repeated in memory.
// bf16 (the dtype of both main paths):
// - Both products run on `wgmma`. S = Q K^T takes Q (loaded once per block)
//   and the K tile K-major from 128-byte-swizzled shared memory; the S
//   accumulator's register layout is the A fragment of the next product,
//   so round(P) is packed in place and O += round(P) V reads only V from
//   shared memory (MN-major, through the transpose bit). P never touches
//   shared memory.
// - K and V tiles stay bf16 and arrive by `cp.async` (zero-filled past the
//   ragged edge) through a two-stage ring, so tile t + 1's copy runs under
//   tile t's products and softmax.
// - Within a block a tile's steps run one after the other: S product, wait,
//   mask / row max / exp2 / row sum / pack, rescale of O, PV product, wait.
//   The overlap comes from the blocks beside it: at about 120 registers
//   (D 64) an SM holds four single-warpgroup blocks, which drift apart, so
//   one block's softmax runs under another's products. Measured slower on
//   the H100 (GPT-2 train shape, 0.056-0.057 ms for this kernel):
//   - the TPU's pipelined schedule (`_fwd_stages`: tile t + 1's scores
//     under tile t's online update), built three ways, 0.063-0.071 ms. It
//     keeps the scaled scores or a second P fragment live beside the
//     accumulators (147-172 registers at D 64: two or three blocks an SM),
//     and ptxas serializes every wgmma of a kernel in which an ordinary
//     instruction writes a register that a product reads or accumulates
//     into while another product is in flight (notes C7513, C7515);
//   - two warpgroups a block on one K/V ring (half the tile traffic from
//     L2, but the warpgroups meet at every barrier), 0.065 ms.
// - Row statistics live in the four threads of a quad (two rows a thread):
//   the row max goes over two shuffles, the row sum stays per thread until
//   the end. Only the diagonal tile and the ragged last tile apply the mask.
// f32 keeps the first version's scalar FMA kernel from f32 shared-memory
// tiles: wgmma on f32 inputs runs in TF32, which would break the f32
// contract (1e-4 against the plain version), and no main path runs f32.
//
// Numerics follow the TPU kernel: scores are f32, the online softmax runs
// in base 2 with log2(e) folded into the scale, p is rounded to v's dtype
// before P.V (f32 accumulate), and the stored lse is the NATURAL-log
// logsumexp; a row with no unmasked column gets lse -1e30 and O = 0. Keys at
// or past kv_len are masked. The bf16 kernel takes 2^x from the hardware's
// approximation (`ex2.approx.ftz`, a couple of f32 ulps, far under bf16's
// rounding of p). The plain PyTorch version is `_flash_fwd_plain` in
// ray_tpu_torch/ops/attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tiles.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;  // 1 / log2(e)
constexpr int kThreads = 256;  // 16 x 16: tx walks kv columns / head dims, ty rows
constexpr int kBlockQ = 64;
constexpr int kBlockKV = 64;
constexpr int kRI = kBlockQ / 16;
constexpr int kCJ = kBlockKV / 16;

// ------------------------------------------------- f32: scalar FMA kernel
//
// T is float only (bf16 takes the wgmma kernel below); the conversions keep
// the template's shape.
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

// p rounded to v's dtype, as the TPU kernel's p.astype(v.dtype)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float group16_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float group16_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Shared memory: sQ[64][D+1] | sK[64][D+1] (reused as sP[64][65]) | sV[64][D].
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
                 int num_q_heads, int num_kv_heads, int sq, int skv, int causal,
                 float scale_log2) {
  constexpr int kDIters = D / 16;
  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (num_q_heads / num_kv_heads);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBlockQ * (D + 1);
  constexpr int kKPFloats =
      kBlockKV * (D + 1) > kBlockQ * (kBlockKV + 1) ? kBlockKV * (D + 1)
                                                    : kBlockQ * (kBlockKV + 1);
  float* sP = sK;  // P reuses K's space once the scores are in registers
  float* sV = sK + kKPFloats;

  const T* qh = q + ((size_t)b * num_q_heads + h) * sq * D;
  const T* kh = k + ((size_t)b * num_kv_heads + hk) * skv * D;
  const T* vh = v + ((size_t)b * num_kv_heads + hk) * skv * D;
  const int q0 = qt * kBlockQ;

  for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    sQ[r * (D + 1) + d] = q0 + r < sq ? to_f32(qh[(size_t)(q0 + r) * D + d]) : 0.f;
  }

  float m_i[kRI], l_i[kRI], acc[kRI][kDIters];
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDIters; ++j) acc[i][j] = 0.f;
  }

  int n_tiles = (skv + kBlockKV - 1) / kBlockKV;
  if (causal) n_tiles = min(n_tiles, (q0 + kBlockQ - 1) / kBlockKV + 1);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int c0 = kt * kBlockKV;
    __syncthreads();  // previous tile's sP / sV reads are done
    for (int idx = tid; idx < kBlockKV * D; idx += kThreads) {
      const int c = idx / D, d = idx - c * D;
      const bool in = c0 + c < skv;
      sK[c * (D + 1) + d] = in ? to_f32(kh[(size_t)(c0 + c) * D + d]) : 0.f;
      sV[idx] = in ? to_f32(vh[(size_t)(c0 + c) * D + d]) : 0.f;
    }
    __syncthreads();

    float sc[kRI][kCJ];
#pragma unroll
    for (int i = 0; i < kRI; ++i)
#pragma unroll
      for (int j = 0; j < kCJ; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[kRI], kv[kCJ];
#pragma unroll
      for (int i = 0; i < kRI; ++i) qv[i] = sQ[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < kCJ; ++j) kv[j] = sK[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < kRI; ++i)
#pragma unroll
        for (int j = 0; j < kCJ; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
    __syncthreads();  // every thread is done reading sK: sP may overwrite it

    float alpha_i[kRI];
#pragma unroll
    for (int i = 0; i < kRI; ++i) {
      const int r = ty + 16 * i;
      const int row = q0 + r;
      float m_cur = kNegInf;
#pragma unroll
      for (int j = 0; j < kCJ; ++j) {
        const int col = c0 + tx + 16 * j;
        const bool keep = col < skv && (!causal || col <= row);
        sc[i][j] = keep ? sc[i][j] * scale_log2 : kNegInf;
        m_cur = fmaxf(m_cur, sc[i][j]);
      }
      m_cur = group16_max(m_cur);
      const float m_new = fmaxf(m_i[i], m_cur);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kCJ; ++j) {
        const float p = exp2f(sc[i][j] - m_new);
        psum += p;
        sP[r * (kBlockKV + 1) + tx + 16 * j] = round_to<T>(p);
      }
      psum = group16_sum(psum);
      const float alpha = exp2f(m_i[i] - m_new);
      l_i[i] = alpha * l_i[i] + psum;
      m_i[i] = m_new;
      alpha_i[i] = alpha;
    }
    __syncthreads();

    float pv[kRI][kDIters];
#pragma unroll
    for (int i = 0; i < kRI; ++i)
#pragma unroll
      for (int j = 0; j < kDIters; ++j) pv[i][j] = 0.f;
    for (int c = 0; c < kBlockKV; ++c) {
      float vv[kDIters];
#pragma unroll
      for (int j = 0; j < kDIters; ++j) vv[j] = sV[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRI; ++i) {
        const float p = sP[(ty + 16 * i) * (kBlockKV + 1) + c];
#pragma unroll
        for (int j = 0; j < kDIters; ++j) pv[i][j] = fmaf(p, vv[j], pv[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRI; ++i)
#pragma unroll
      for (int j = 0; j < kDIters; ++j) acc[i][j] = acc[i][j] * alpha_i[i] + pv[i][j];
  }

  T* oh = out + ((size_t)b * num_q_heads + h) * sq * D;
  float* lh = lse + ((size_t)b * num_q_heads + h) * sq;
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float safe_l = l_i[i] == 0.f ? 1.f : l_i[i];
#pragma unroll
    for (int j = 0; j < kDIters; ++j)
      oh[(size_t)row * D + tx + 16 * j] = from_f32<T>(acc[i][j] / safe_l);
    if (tx == 0) lh[row] = l_i[i] == 0.f ? kNegInf : (m_i[i] + log2f(safe_l)) * kLn2;
  }
}

// ------------------------------------- bf16: wgmma kernel (sm_90a only)

using namespace hopper;

// Q and two stages of (K, V) tiles, each (64, D) bf16; alignment slack
template <int D>
constexpr size_t wgmma_smem() {
  return 5 * (64 * D * 2) + 1024;
}

// Scaled scores of a kv tile from the S accumulator. An accumulator element
// i of a thread sits at row 16 * warp + lane / 4 + 8 * ((i >> 1) & 1), column
// 8 * (i >> 2) + 2 * (lane % 4) + (i & 1); row0 and col0 are the thread's
// first. `edge` (block-uniform) marks a tile that holds a masked column.
__device__ __forceinline__ void scaled_scores(float (&x)[32], const float (&s)[32],
                                              float scale_log2, bool edge, int row0, int col0,
                                              int skv, int causal) {
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = s[i] * scale_log2;
  if (edge) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = row0 + 8 * ((i >> 1) & 1);
      const int col = col0 + 8 * (i >> 2) + (i & 1);
      if (col >= skv || (causal && col > row)) x[i] = kNegInf;
    }
  }
}

// One online-softmax update on a thread's two rows (hh = 0, 1) of a tile:
// x becomes p = 2^(x - m_new), m the running row max, l this thread's share
// of the running row sum (its 16 columns of every tile: the quad is summed
// once, at the end), alpha the factor that brings O to the new max, and pa
// round(p) packed as the A fragments of the PV product's four k steps.
__device__ __forceinline__ void online_softmax(float (&x)[32], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], uint32_t (&pa)[16]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(x[4 * j + 2 * hh], x[4 * j + 2 * hh + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[hh], mx);
    alpha[hh] = ex2_ftz(m[hh] - m_new);
    m[hh] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pv = ex2_ftz(x[4 * j + 2 * hh + e] - m_new);
        x[4 * j + 2 * hh + e] = pv;
        sum += pv;
      }
    l[hh] = alpha[hh] * l[hh] + sum;
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) pa[r] = pack_bf16(x[2 * r], x[2 * r + 1]);
}

// S = Q K^T for one kv tile: D / 16 k steps of m64n64k16, the first of which
// overwrites s; committed as one group.
template <int D>
__device__ __forceinline__ void start_s(float (&s)[32], uint32_t sQ, uint32_t sK) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    mma_ss(s, desc_k(sQ + kstep(ks)), desc_k(sK + kstep(ks)), ks > 0);
  wgmma_commit();
}

// O = alpha O + round(P) V for one kv tile (a thread's two rows each by
// their own alpha; N = D as D / 64 products of N 64 per k step), committed
// as one group. O's last product must have been waited for.
template <int D>
__device__ __forceinline__ void start_pv(float (&acc)[D / 64][32], const float (&alpha)[2],
                                         const uint32_t (&pa)[16], uint32_t sV) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] *= alpha[(i >> 1) & 1];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
      mma_rs(acc[c], &pa[4 * kk], desc_mn(sV + c * kChunk + kk * 16 * 128));
  wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(kNT, 1)
flash_fwd_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out, float* __restrict__ lse,
                int num_q_heads, int num_kv_heads, int sq, int skv, int causal,
                float scale_log2) {
  constexpr int kC = D / 64;              // 64-column chunks of a row
  constexpr uint32_t kTile = 64 * D * 2;  // one (64, D) bf16 tile

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sStage = sQ + kTile;  // stage t % 2: K tile t, V tile t after it

  const int tid = threadIdx.x;
  const int warp = tid >> 5;  // accumulator rows 16 warp .. 16 warp + 15
  const int lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;  // causal: the longest walks start first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (num_q_heads / num_kv_heads);
  const int q0 = qt * 64;
  const size_t q_off = ((size_t)b * num_q_heads + h) * sq * D;
  const size_t kv_off = ((size_t)b * num_kv_heads + hk) * skv * D;
  const int row0 = q0 + 16 * warp + g;  // this thread's rows: row0, row0 + 8

  int n = (skv + 63) / 64;  // >= 1: the launcher refuses skv == 0
  if (causal) n = min(n, q0 / 64 + 1);

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kC][32];
#pragma unroll
  for (int c = 0; c < kC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  float s[32], x[32], alpha[2];  // every S product's first k step overwrites s
  uint32_t pa[16];

  auto prefetch = [&](int t) {
    if (t < n) {
      const uint32_t st = sStage + (t & 1) * 2 * kTile;
      load_tile_async<D>(st, k + kv_off, t * 64, skv, tid);
      load_tile_async<D>(st + kTile, v + kv_off, t * 64, skv, tid);
    }
    cp_async_commit();
  };
  load_tile_async<D>(sQ, q + q_off, q0, sq, tid);
  prefetch(0);

  // The trip count is the block's own, and nothing else branches around a
  // product: a branch that the compiler cannot prove warpgroup-uniform
  // serializes every wgmma of the kernel (ptxas C7520).
  for (int t = 0; t < n; ++t) {
    prefetch(t + 1);     // overlaps this step
    cp_async_wait<1>();  // this step's stage (and Q) have landed
    fence_proxy_async();
    __syncthreads();
    const uint32_t sK = sStage + (t & 1) * 2 * kTile;
    start_s<D>(s, sQ, sK);
    wgmma_wait<0>();
    pin(s);
    const int c0 = t * 64;
    const bool edge = c0 + 64 > skv || (causal && c0 + 63 > q0);  // diagonal or ragged tile
    scaled_scores(x, s, scale_log2, edge, row0, c0 + 2 * tq, skv, causal);
    online_softmax(x, m, l, alpha, pa);
    start_pv<D>(acc, alpha, pa, sK + kTile);
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kC; ++c) pin(acc[c]);
    __syncthreads();  // the stage is read; the next step's copy may overwrite it
  }

  bf16* oh = out + q_off;
  float* lh = lse + ((size_t)b * num_q_heads + h) * sq;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float sum = l[hh];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = row0 + 8 * hh;
    if (row >= sq) continue;
    const float safe_l = sum == 0.f ? 1.f : sum;
    const float inv = 1.f / safe_l;
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int idx = 4 * i + 2 * hh;
        *reinterpret_cast<__nv_bfloat162*>(oh + (size_t)row * D + 64 * c + 8 * i + 2 * tq) =
            __floats2bfloat162_rn(acc[c][idx] * inv, acc[c][idx + 1] * inv);
      }
    if (tq == 0) lh[row] = sum == 0.f ? kNegInf : (m[hh] + log2f(safe_l)) * kLn2;
  }
}

// ----------------------------------------------------------------- launch

template <typename T, int D>
int launch_typed(const void* q, const void* k, const void* v, void* out, float* lse,
                 int batch, int num_q_heads, int num_kv_heads, int sq, int skv,
                 int causal, float scale_log2, cudaStream_t stream) {
  constexpr int kKPFloats =
      kBlockKV * (D + 1) > kBlockQ * (kBlockKV + 1) ? kBlockKV * (D + 1)
                                                    : kBlockQ * (kBlockKV + 1);
  const size_t smem = sizeof(float) * ((size_t)kBlockQ * (D + 1) + kKPFloats + kBlockKV * D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + kBlockQ - 1) / kBlockQ, num_q_heads, batch);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, num_q_heads, num_kv_heads, sq, skv, causal, scale_log2);
  return (int)cudaGetLastError();
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, float* lse,
                 int batch, int num_q_heads, int num_kv_heads, int sq, int skv, int causal,
                 float scale_log2, cudaStream_t stream) {
  if (skv == 0) return (int)cudaErrorInvalidValue;  // the kernel walks at least one kv tile
  const size_t smem = wgmma_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + 63) / 64, num_q_heads, batch);
  flash_fwd_wgmma<D><<<grid, kNT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), lse, num_q_heads, num_kv_heads, sq, skv, causal, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (FMA kernel), 1 = bfloat16 (wgmma kernel); head_dim 64 or
// 128. q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D),
// out like q, lse (B, Hq, Sq) float32. Returns cudaGetLastError() after launch.
int flash_attention_fwd_launch(const void* q, const void* k, const void* v, void* out,
                               void* lse, int dtype, int head_dim, int batch,
                               int num_q_heads, int num_kv_heads, int sq, int skv,
                               int causal, float scale_log2, void* stream) {
  if (batch == 0 || sq == 0) return 0;
  if (num_kv_heads <= 0 || num_q_heads % num_kv_heads) return (int)cudaErrorInvalidValue;
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FWD_ARGS q, k, v, out, l, batch, num_q_heads, num_kv_heads, sq, skv, causal, scale_log2, s
  if (dtype == 0 && head_dim == 64) return launch_typed<float, 64>(FWD_ARGS);
  if (dtype == 0 && head_dim == 128) return launch_typed<float, 128>(FWD_ARGS);
  if (dtype == 1 && head_dim == 64) return launch_wgmma<64>(FWD_ARGS);
  if (dtype == 1 && head_dim == 128) return launch_wgmma<128>(FWD_ARGS);
#undef FWD_ARGS
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
