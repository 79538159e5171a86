// Ragged paged attention for Hopper (sm_90a).
//
// Replaces: ray_tpu/ops/ragged_paged_attention.py, `_ragged_kernel` driven by
// `_ragged_pallas` (the Pallas TPU kernel). One call covers every region
// shape the serving engine dispatches: prefill chunks at any offset, decode
// lanes (q_len 1), verify regions (q_len K), inactive lanes (q_len 0).
//
// What bounds it on the H100: the bytes of the K/V pages it reads. Every
// query row of a region attends to the same pages, and the GQA group of
// `groups` query heads shares one kv head, so at decode (q_len 1) each page
// byte feeds only 2 * groups flops per element, far below the ~295 flop/byte
// the card needs before its tensor cores become the limit. Prefill chunks
// reuse each page for up to `chunk` query rows and move towards compute.
//
// What the design does about it (bf16, the serving dtype):
// - One block is one warpgroup holding a 64-row tile: `nqb` consecutive
//   q blocks of one region x the GQA group's heads (16 tokens x 4 heads for
//   Llama-3-8B at block_q 8), so each K/V byte is read from device memory
//   once per tile and serves every head of the group. Row r of the tile is
//   head r / (nqb * block_q) of the group, region row qb0 * block_q +
//   r % (nqb * block_q).
// - K/V are walked in 64-column tiles of kv positions. Each tile row is
//   gathered through the sequence's block-table row with 16-byte `cp.async`
//   copies into wgmma's 128B-swizzled layout (at page_size 64 one page is
//   exactly one tile; other page sizes gather several pages into a tile or
//   one page into several), through a three-stage ring, so two tiles' copies
//   are in flight under every tile's products. Columns past the walked
//   pages are zero-filled, never read.
// - S = Q K^T and O += round(P) V run on `wgmma` (m64n64k16): K is the
//   K-major B operand, the S accumulator is packed in place into P's A
//   fragments, V is MN-major through the transpose bit (as in
//   flash_attention_fwd.cu). 64 rows cost what 4 do, so the padding rows of
//   a decode tile (28 of 32 at Llama-3-8B) spend no extra issue slots.
//   The only branch around a product is the block's own tile loop.
// - Decode (max_q_blocks == 1: every launch of the K-step decode block) is
//   split over the kv walk (flash-decoding): block (split, kv head, lane)
//   walks `tiles_per_split` tiles, so 8 lanes x 8 kv heads become 8 x 8 x
//   splits blocks instead of 64 for 132 SMs; splits past a lane's last tile
//   exit at once. Each split writes its partial (m, l, acc) rows to an f32
//   workspace that the wrapper allocates; a second kernel combines them in
//   split order (deterministic: two calls are bitwise equal).
// f32 keeps the first version's scalar FMA kernel (wgmma on f32 runs in
// TF32, which would break the f32 contract of 1e-4 against the plain
// version).
//
// Semantics kept from the TPU kernel (they are what a redesign breaks):
// - Pages are visited in order through tables[s], only up to the frontier
//   pos_hi = kv_len - q_len + min((qb + 1) * block_q, q_len) - 1 of each
//   8-row q block; columns past the frontier page do not exist.
// - A padding row (row >= q_len) of a q block with work sees every logit
//   masked to -1e30, so it gets p = exp(0) = 1 on every column of every page
//   its block walked: its output is the mean of V over those rows, rows past
//   kv_len included. A q block with no work writes zeros (safe_l); q blocks
//   past counts[s] (or max_q_blocks) write nothing.
// - Grouping q blocks into one tile is exact. The tile walks to the
//   frontier of its last working q block, which is the largest. For a real
//   row of an earlier block every extra page lies past its own position, so
//   all its columns there are masked: its running max is already real (its
//   first page holds column 0), p = 2^(-1e30 - m) = 0 and alpha = 2^0 = 1,
//   exactly. Padding rows only ever sit in the region's last working q
//   block, whose frontier is the tile's, so they see exactly their pages.
//   Rows of q blocks without work are written as zeros. (This assumes
//   kv_len >= q_len, as every caller's descriptor has.)
// - Split-KV is exact only with the finite sentinel. Partials combine with
//   weights 2^(m_i - m_max); a split whose columns are all masked for a row
//   (a verify row whose frontier ends a page before the block's, or a
//   padding row) holds m = -1e30 and gets weight 2^(-1e30 - m_max) = 0 when
//   the row has a real max, and weight 1 when it has none, so an
//   all-padding row still gives the mean of V. With -inf it would give NaN.
// - Columns past the walked pages (the tail of the last 64-column tile) take
//   -3e38, below the -1e30 of a masked column, so they get p = 0 even on a
//   row whose every column is masked.
//
// Numerics: the kernel scales q itself as the TPU's caller does,
// q' = bf16(f32(q) * f32(sm_scale)) (f32 for f32), so the numbers are those
// of a pre-scaled q; logits and the online softmax are f32; the bf16 kernel
// runs the softmax in base 2 (log2(e) folded after the product,
// `ex2.approx.ftz`) and rounds p to bf16 before P.V, where the plain version
// keeps p in f32 (bf16 tolerance: 2e-2). The plain PyTorch version is
// `ragged_reference_attention` in ray_tpu_torch/ops/ragged_paged_attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tiles.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;  // f32 kernel: 16 x 16, tx walks columns, ty rows

// ------------------------------------------------- f32: scalar FMA kernel

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

// Shared memory: sQ[R][D+1] | sK[ps][D+1] (reused as sP[R][ps+1]) | sV[ps][D].
// The +1 strides keep the column-per-lane reads of sQ and sK free of bank
// conflicts.
// RI = rows per thread (rows <= 16 * RI), CJ = page columns per thread
// (page_size <= 16 * CJ): both fixed at compile time so no FMA is spent on
// rows or columns the block does not have.
template <int D, int RI, int CJ>
__global__ void __launch_bounds__(kThreads)
ragged_kernel(const float* __restrict__ q, const float* __restrict__ k_pages,
              const float* __restrict__ v_pages, const int* __restrict__ starts,
              const int* __restrict__ counts, const int* __restrict__ q_lens,
              const int* __restrict__ kv_lens, const int* __restrict__ tables,
              float* __restrict__ out, float q_scale, int t_rows, int num_pages,
              int page_size, int max_pages, int block_q, int groups) {
  constexpr int kDIters = D / 16;
  const int qb = blockIdx.x;
  const int g = blockIdx.y;
  const int s = blockIdx.z;
  if (qb >= counts[s]) return;  // past the region: aliases its last block, writes nothing

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int rows = groups * block_q;
  const int ps = page_size;
  const int q_len = q_lens[s];
  const int kv_len = kv_lens[s];
  const int row0 = (starts[s] + qb) * block_q;  // first token row of this q block

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + rows * (D + 1);
  const int kp_floats = max(ps * (D + 1), rows * (ps + 1));
  float* sP = sK;  // P reuses K's space once the logits are in registers
  float* sV = sK + kp_floats;

  // query rows: r -> (head g*groups + r / block_q, token row0 + r % block_q),
  // scaled here as the caller's f32(q) * f32(sm_scale)
  for (int idx = tid; idx < rows * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    const int h = g * groups + r / block_q;
    const int t = row0 + r % block_q;
    sQ[r * (D + 1) + d] = q[((size_t)h * t_rows + t) * D + d] * q_scale;
  }

  float m_i[RI], l_i[RI], acc[RI][kDIters];
  int pos_i[RI];
  bool valid_i[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
    const int r = ty + 16 * i;
    const int qrow = qb * block_q + (r % block_q);
    pos_i[i] = kv_len - q_len + qrow;
    valid_i[i] = qrow < q_len;
#pragma unroll
    for (int j = 0; j < kDIters; ++j) acc[i][j] = 0.f;
  }

  // causal frontier of the block's last real row (the TPU kernel's pos_hi)
  const int pos_hi = kv_len - q_len + min((qb + 1) * block_q, q_len) - 1;
  int n_pages = 0;
  if (qb * block_q < q_len && pos_hi >= 0) n_pages = min(max_pages, pos_hi / ps + 1);

  const size_t page_elems = (size_t)ps * D;
  for (int kb = 0; kb < n_pages; ++kb) {
    const int page = tables[s * max_pages + kb];
    const float* kp = k_pages + ((size_t)g * num_pages + page) * page_elems;
    const float* vp = v_pages + ((size_t)g * num_pages + page) * page_elems;
    __syncthreads();  // previous page's sP / sV reads are done
    for (int idx = tid; idx < ps * D; idx += kThreads) {
      const int c = idx / D, d = idx - c * D;
      sK[c * (D + 1) + d] = kp[idx];
      sV[idx] = vp[idx];
    }
    __syncthreads();

    float sc[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int r = ty + 16 * i;
        qv[i] = r < rows ? sQ[r * (D + 1) + d] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = tx + 16 * j;
        kv[j] = c < ps ? sK[c * (D + 1) + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
    __syncthreads();  // every thread is done reading sK: sP may overwrite it

    float alpha_i[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
      float m_cur = kNegInf;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = tx + 16 * j;
        const int col = kb * ps + c;
        const bool keep = valid_i[i] && col <= pos_i[i] && col < kv_len;
        sc[i][j] = keep ? sc[i][j] : kNegInf;
        if (c < ps) m_cur = fmaxf(m_cur, sc[i][j]);
      }
      m_cur = group16_max(m_cur);
      const float m_new = fmaxf(m_i[i], m_cur);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = tx + 16 * j;
        if (c < ps) {
          const float p = expf(sc[i][j] - m_new);
          psum += p;
          if (r < rows) sP[r * (ps + 1) + c] = p;
        }
      }
      psum = group16_sum(psum);
      const float alpha = expf(m_i[i] - m_new);
      l_i[i] = alpha * l_i[i] + psum;
      m_i[i] = m_new;
      alpha_i[i] = alpha;
    }
    __syncthreads();

    float pv[RI][kDIters];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < kDIters; ++j) pv[i][j] = 0.f;
    for (int c = 0; c < ps; ++c) {
      float vv[kDIters];
#pragma unroll
      for (int j = 0; j < kDIters; ++j) vv[j] = sV[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int r = ty + 16 * i;
        if (r < rows) {
          const float p = sP[r * (ps + 1) + c];
#pragma unroll
          for (int j = 0; j < kDIters; ++j) pv[i][j] = fmaf(p, vv[j], pv[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < kDIters; ++j) acc[i][j] = acc[i][j] * alpha_i[i] + pv[i][j];
  }

  // every block the sequence owns writes its rows; l == 0 (no work) -> zeros
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
    const float safe_l = l_i[i] == 0.f ? 1.f : l_i[i];
    const int h = g * groups + r / block_q;
    const int t = row0 + r % block_q;
    float* o = out + ((size_t)h * t_rows + t) * D;
#pragma unroll
    for (int j = 0; j < kDIters; ++j) o[tx + 16 * j] = acc[i][j] / safe_l;
  }
}

// ------------------------------------- bf16: wgmma kernels (sm_90a only)

using namespace hopper;

constexpr int kStages = 3;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kSkip = -3.0e38f;  // a column past the walked pages: p = 0 on any row

// Q and kStages stages of (K, V) tiles, each (64, D) bf16; alignment slack
template <int D>
constexpr size_t wgmma_smem() {
  return (1 + 2 * kStages) * (64 * D * 2) + 1024;
}

__device__ __forceinline__ void st_shared16(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// 8 bf16 values scaled as the caller's bf16(f32(q) * f32(scale))
__device__ __forceinline__ uint32_t scale_pair(uint32_t v, float scale) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return pack_bf16(f.x * scale, f.y * scale);
}

// byte offset of (row r, 16-byte group gch) in a 128B-swizzled (64, D) tile
__device__ __forceinline__ uint32_t swz(int r, int gch) {
  return (gch >> 3) * kChunk + r * 128 + (((gch & 7) ^ (r & 7)) << 4);
}

// kv positions [c0, c0 + 64) of one kv head into the K and V tiles at dstK,
// dstV: position c sits at row c % ps of page table[c / ps]; positions at or
// past n_cols (the end of the walked pages) are zero-filled and not read.
// kp, vp point at page 0 of the kv head.
template <int D>
__device__ __forceinline__ void load_kv_tile(uint32_t dstK, uint32_t dstV,
                                             const bf16* __restrict__ kp,
                                             const bf16* __restrict__ vp,
                                             const int* __restrict__ table, int c0, int n_cols,
                                             int ps, int tid) {
  constexpr int kPerRow = D / 8;
#pragma unroll
  for (int i = 0; i < 64 * kPerRow / kNT; ++i) {
    const int p = tid + i * kNT;
    const int r = p / kPerRow, gch = p % kPerRow;
    const int col = c0 + r;
    const bool ok = col < n_cols;
    size_t src = 0;
    if (ok) src = ((size_t)table[col / ps] * ps + col % ps) * D + gch * 8;
    const uint32_t off = swz(r, gch);
    cp_async16(dstK + off, kp + src, ok);
    cp_async16(dstV + off, vp + src, ok);
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

// Grid: (tiles of nqb q blocks, longest walks first | splits, kv heads,
// sequences); one warpgroup per block. kSplit: the block walks kv tiles
// [split * tiles_per_split, ...) of q block 0 (nqb == 1) and writes its
// partial rows to the workspace; otherwise it walks every kv tile up to the
// tile's frontier and writes the output.
template <int D, bool kSplit>
__global__ void __launch_bounds__(kNT, 1)
ragged_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k_pages,
             const bf16* __restrict__ v_pages, const int* __restrict__ starts,
             const int* __restrict__ counts, const int* __restrict__ q_lens,
             const int* __restrict__ kv_lens, const int* __restrict__ tables,
             bf16* __restrict__ out, float* __restrict__ ws_acc, float2* __restrict__ ws_ml,
             float q_scale, int t_rows, int num_pages, int page_size, int max_pages,
             int block_q, int groups, int nqb, int max_q_blocks, int tiles_per_split) {
  constexpr int kC = D / 64;              // 64-column chunks of a row
  constexpr uint32_t kTile = 64 * D * 2;  // one (64, D) bf16 tile

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sStage = sQ + kTile;  // stage i: K tile, V tile after it

  const int g = blockIdx.y, s = blockIdx.z;
  const int qb0 = kSplit ? 0 : (gridDim.x - 1 - blockIdx.x) * nqb;
  // the descriptor's four loads are issued together: the block's first
  // page copy waits on them, then on its block-table entry
  const int count = counts[s], q_len = q_lens[s], kv_len = kv_lens[s], start = starts[s];
  const int qb_end = min(count, max_q_blocks);  // q blocks this region writes
  if (qb0 >= qb_end) return;
  const int span = nqb * block_q;  // region rows of the tile
  const int used = span * groups;  // tile rows in use (<= 64)

  // the tile's frontier: that of its last working q block, the largest
  int n_pages = 0;
  if (qb0 * block_q < q_len) {
    const int qbw = min(min(qb0 + nqb, qb_end) - 1, (q_len - 1) / block_q);
    const int pos_hi = kv_len - q_len + min((qbw + 1) * block_q, q_len) - 1;
    if (pos_hi >= 0) n_pages = min(max_pages, pos_hi / page_size + 1);
  }
  const int n_cols = n_pages * page_size;
  const int n_tiles = (n_cols + 63) / 64;
  int t0 = 0, t1 = n_tiles;
  if (kSplit) {
    t0 = blockIdx.x * tiles_per_split;
    if (t0 >= n_tiles) return;  // past the lane's last tile
    t1 = min(n_tiles, t0 + tiles_per_split);
  }

  const int tid = threadIdx.x;
  const int warp = tid >> 5;  // accumulator rows 16 warp .. 16 warp + 15
  const int lane = tid & 31;
  const int tq = lane & 3;
  const int rbase = 16 * warp + (lane >> 2);  // this thread's rows: rbase, rbase + 8
  const int row_base = (start + qb0) * block_q;  // token row of region row qb0 * block_q

  const bf16* kh = k_pages + (size_t)g * num_pages * page_size * D;
  const bf16* vh = v_pages + (size_t)g * num_pages * page_size * D;
  const int* table = tables + (size_t)s * max_pages;
  auto prefetch = [&](int t) {
    if (t < t1) {
      const uint32_t st = sStage + ((t - t0) % kStages) * 2 * kTile;
      load_kv_tile<D>(st, st + kTile, kh, vh, table, t * 64, n_cols, page_size, tid);
    }
    cp_async_commit();
  };
  // Q's loads are issued first and used last, so their latency overlaps
  // that of the block-table reads and the first tiles' copies. Rows past
  // the tile's use or in q blocks the region does not write are zero.
  constexpr int kPerRow = D / 8;
  constexpr int kQLoads = 64 * kPerRow / kNT;
  uint4 qv[kQLoads];
#pragma unroll
  for (int i = 0; i < kQLoads; ++i) {
    const int r = (tid + i * kNT) / kPerRow, gch = (tid + i * kNT) % kPerRow;
    const int tok = r % span;
    qv[i] = make_uint4(0, 0, 0, 0);
    if (r < used && qb0 + tok / block_q < qb_end)
      qv[i] = *reinterpret_cast<const uint4*>(
          q + ((size_t)(g * groups + r / span) * t_rows + row_base + tok) * D + gch * 8);
  }
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) prefetch(t0 + i);
  // Q, scaled, into the swizzled tile
#pragma unroll
  for (int i = 0; i < kQLoads; ++i) {
    const int r = (tid + i * kNT) / kPerRow, gch = (tid + i * kNT) % kPerRow;
    uint4 v = qv[i];
    v.x = scale_pair(v.x, q_scale);
    v.y = scale_pair(v.y, q_scale);
    v.z = scale_pair(v.z, q_scale);
    v.w = scale_pair(v.w, q_scale);
    st_shared16(sQ + swz(r, gch), v);
  }

  // last kept column of each of the thread's rows (-1: a padding or unused row)
  int lim[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = rbase + 8 * hh;
    const int i = qb0 * block_q + r % span;  // region row
    lim[hh] = (r < used && i < q_len) ? kv_len - q_len + i : -1;
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kC][32];
#pragma unroll
  for (int c = 0; c < kC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  float sacc[32], x[32], alpha[2];  // every S product's first k step overwrites sacc
  uint32_t pa[16];

  // The trip count is the block's own and nothing else branches around a
  // product: a branch that the compiler cannot prove warpgroup-uniform
  // serializes every wgmma of the kernel (ptxas C7520).
  for (int t = t0; t < t1; ++t) {
    prefetch(t + kStages - 1);      // overlaps this tile's work
    cp_async_wait<kStages - 1>();   // this tile's stage has landed
    fence_proxy_async();            // Q's plain stores and the copies, to wgmma
    __syncthreads();
    const uint32_t sK = sStage + ((t - t0) % kStages) * 2 * kTile;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      mma_ss(sacc, desc_k(sQ + kstep(ks)), desc_k(sK + kstep(ks)), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    pin(sacc);
    const int c0 = t * 64 + 2 * tq;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = c0 + 8 * (i >> 2) + (i & 1);
      const int lm = lim[(i >> 1) & 1];
      x[i] = col >= n_cols ? kSkip : (col > lm ? kNegInf : sacc[i] * kLog2e);
    }
    online_softmax(x, m, l, alpha, pa);
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] *= alpha[(i >> 1) & 1];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < kC; ++c)
        mma_rs(acc[c], &pa[4 * kk], desc_mn(sK + kTile + c * kChunk + kk * 16 * 128));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kC; ++c) pin(acc[c]);
    __syncthreads();  // the stage is read; a later copy may overwrite it
  }
  cp_async_wait<0>();  // no copy outlives the block

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float sum = l[hh];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int r = rbase + 8 * hh;
    if (r >= used) continue;
    const int tok = r % span;
    const int i = qb0 * block_q + tok;  // region row
    if (kSplit) {
      // the real rows, and one padding row (head 0, region row q_len) for
      // all of them: every padding row of the block holds the same partial
      const bool pad_row = r == q_len;  // nqb == 1: r < block_q is head 0's
      if (!(i < q_len || pad_row)) continue;
      const size_t row = ((size_t)(s * gridDim.y + g) * gridDim.x + blockIdx.x) * used + r;
      if (tq == 0) ws_ml[row] = make_float2(m[hh], sum);
      float* dst = ws_acc + row * D;
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int idx = 4 * j + 2 * hh;
          *reinterpret_cast<float2*>(dst + 64 * c + 8 * j + 2 * tq) =
              make_float2(acc[c][idx], acc[c][idx + 1]);
        }
    } else {
      const int qb = i / block_q;
      if (qb >= qb_end) continue;
      // a q block without work writes zeros; l > 0 on every row of one with work
      const float inv = (qb * block_q < q_len && sum > 0.f) ? 1.f / sum : 0.f;
      bf16* o = out + ((size_t)(g * groups + r / span) * t_rows + row_base + tok) * D;
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int idx = 4 * j + 2 * hh;
          *reinterpret_cast<__nv_bfloat162*>(o + 64 * c + 8 * j + 2 * tq) =
              __floats2bfloat162_rn(acc[c][idx] * inv, acc[c][idx + 1] * inv);
        }
    }
  }
}

constexpr int kMaxSplits = 32;  // one lane of a warp per split in the combine
constexpr int kCombineThreads = 128;

// Combines the split partials of q block 0 of lane s, kv head g, in split
// order. Each warp takes distinct partial rows (the real rows and the one
// padding row): lane j reads split j's (m, l), the warp takes the max and
// the weights 2^(m_j - m_max), then each lane sums its D / 32 columns over
// the splits, four splits' loads in flight at a time. The padding row's
// result is written to every padding row of the block.
template <int D>
__global__ void __launch_bounds__(kCombineThreads)
ragged_combine(const float* __restrict__ ws_acc, const float2* __restrict__ ws_ml,
               const int* __restrict__ starts, const int* __restrict__ counts,
               const int* __restrict__ q_lens, const int* __restrict__ kv_lens,
               bf16* __restrict__ out, int t_rows, int page_size, int max_pages, int block_q,
               int groups, int n_splits, int tiles_per_split) {
  constexpr int kCols = D / 32;  // columns of a lane: 4 (D 128) or 2 (D 64)
  const int g = blockIdx.x, s = blockIdx.y;
  const int count = counts[s], q_len = q_lens[s], kv_len = kv_lens[s], start = starts[s];
  if (count < 1) return;
  int n_pages = 0;
  if (q_len > 0) {
    const int pos_hi = kv_len - q_len + min(block_q, q_len) - 1;
    if (pos_hi >= 0) n_pages = min(max_pages, pos_hi / page_size + 1);
  }
  const int n_tiles = (n_pages * page_size + 63) / 64;
  const int n_used = (n_tiles + tiles_per_split - 1) / tiles_per_split;
  const int rows = groups * block_q;
  const int real = min(q_len, block_q);       // real rows of each head
  const int n_src = groups * real + (real < block_q ? 1 : 0);  // + the padding row
  const size_t base = (size_t)(s * gridDim.x + g) * n_splits * rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* o = out + ((size_t)g * groups * t_rows + (size_t)start * block_q) * D + lane * kCols;

  if (n_used == 0) {  // no work: every row of the block is zero
    for (int r = warp; r < rows; r += kCombineThreads / 32)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        o[((size_t)(r / block_q) * t_rows + r % block_q) * D + c] = __float2bfloat16_rn(0.f);
    return;
  }
  for (int k = warp; k < n_src; k += kCombineThreads / 32) {
    // partial row: head k / real, token k % real; the last one is the padding row
    const bool pad = k == groups * real;
    const int r = pad ? real : (k / real) * block_q + k % real;
    const float2 ml = lane < n_used ? ws_ml[base + (size_t)lane * rows + r]
                                    : make_float2(kNegInf, 0.f);
    float m_max = ml.x;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m_max = fmaxf(m_max, __shfl_xor_sync(0xffffffffu, m_max, off));
    const float w = lane < n_used ? ex2_ftz(ml.x - m_max) : 0.f;
    float lsum = w * ml.y;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
    float a[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) a[c] = 0.f;
    for (int j0 = 0; j0 < n_used; j0 += 4) {
      float v[4][kCols];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = min(j0 + u, n_used - 1);  // a repeated load, weighted 0 below
        const float* src = ws_acc + (base + (size_t)j * rows + r) * D + lane * kCols;
        if constexpr (kCols == 4) {
          const float4 x = *reinterpret_cast<const float4*>(src);
          v[u][0] = x.x, v[u][1] = x.y, v[u][2] = x.z, v[u][3] = x.w;
        } else {
          const float2 x = *reinterpret_cast<const float2*>(src);
          v[u][0] = x.x, v[u][1] = x.y;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float wj = __shfl_sync(0xffffffffu, w, min(j0 + u, 31));
        const float wu = j0 + u < n_used ? wj : 0.f;
#pragma unroll
        for (int c = 0; c < kCols; ++c) a[c] += wu * v[u][c];
      }
    }
    const float inv = 1.f / lsum;
    if (!pad) {
      bf16* dst = o + ((size_t)(r / block_q) * t_rows + r % block_q) * D;
#pragma unroll
      for (int c = 0; c < kCols; c += 2)
        *reinterpret_cast<__nv_bfloat162*>(dst + c) = __floats2bfloat162_rn(a[c] * inv, a[c + 1] * inv);
    } else {
      for (int pr = 0; pr < rows; ++pr) {
        if (pr % block_q < real) continue;
        bf16* dst = o + ((size_t)(pr / block_q) * t_rows + pr % block_q) * D;
#pragma unroll
        for (int c = 0; c < kCols; c += 2)
          *reinterpret_cast<__nv_bfloat162*>(dst + c) =
              __floats2bfloat162_rn(a[c] * inv, a[c + 1] * inv);
      }
    }
  }
}

// ----------------------------------------------------------------- launch

template <int D, int RI, int CJ>
int launch_fma(const float* q, const float* k_pages, const float* v_pages, const int* starts,
               const int* counts, const int* q_lens, const int* kv_lens, const int* tables,
               float* out, float q_scale, int t_rows, int num_pages, int page_size,
               int max_pages, int block_q, int groups, int num_seqs, int num_kv_heads,
               int max_q_blocks, cudaStream_t stream) {
  const int rows = groups * block_q;
  const int k_floats = page_size * (D + 1), p_floats = rows * (page_size + 1);
  const int kp_floats = k_floats > p_floats ? k_floats : p_floats;
  const size_t smem =
      sizeof(float) * ((size_t)rows * (D + 1) + kp_floats + (size_t)page_size * D);
  cudaError_t err = cudaFuncSetAttribute(
      ragged_kernel<D, RI, CJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(max_q_blocks, num_kv_heads, num_seqs);
  ragged_kernel<D, RI, CJ><<<grid, kThreads, smem, stream>>>(
      q, k_pages, v_pages, starts, counts, q_lens, kv_lens, tables, out, q_scale, t_rows,
      num_pages, page_size, max_pages, block_q, groups);
  return (int)cudaGetLastError();
}

#define FMA_ARGS                                                                        \
  q, k_pages, v_pages, starts, counts, q_lens, kv_lens, tables, out, q_scale, t_rows,   \
      num_pages, page_size, max_pages, block_q, groups, num_seqs, num_kv_heads,         \
      max_q_blocks, stream

template <int D, int RI>
int launch_fma_cols(const float* q, const float* k_pages, const float* v_pages,
                    const int* starts, const int* counts, const int* q_lens,
                    const int* kv_lens, const int* tables, float* out, float q_scale,
                    int t_rows, int num_pages, int page_size, int max_pages, int block_q,
                    int groups, int num_seqs, int num_kv_heads, int max_q_blocks,
                    cudaStream_t stream) {
  if (page_size <= 32) return launch_fma<D, RI, 2>(FMA_ARGS);
  if (page_size <= 64) return launch_fma<D, RI, 4>(FMA_ARGS);
  if (page_size <= 128) return launch_fma<D, RI, 8>(FMA_ARGS);
  return (int)cudaErrorInvalidValue;
}

template <int D>
int launch_fma_rows(const float* q, const float* k_pages, const float* v_pages,
                    const int* starts, const int* counts, const int* q_lens,
                    const int* kv_lens, const int* tables, float* out, float q_scale,
                    int t_rows, int num_pages, int page_size, int max_pages, int block_q,
                    int groups, int num_seqs, int num_kv_heads, int max_q_blocks,
                    cudaStream_t stream) {
  const int rows = groups * block_q;
  if (rows <= 16) return launch_fma_cols<D, 1>(FMA_ARGS);
  if (rows <= 32) return launch_fma_cols<D, 2>(FMA_ARGS);
  if (rows <= 64) return launch_fma_cols<D, 4>(FMA_ARGS);
  return (int)cudaErrorInvalidValue;
}

#undef FMA_ARGS

template <int D>
int launch_wgmma(const bf16* q, const bf16* k_pages, const bf16* v_pages, const int* starts,
                 const int* counts, const int* q_lens, const int* kv_lens, const int* tables,
                 bf16* out, float* ws_acc, float2* ws_ml, float q_scale, int t_rows,
                 int num_pages, int page_size, int max_pages, int block_q, int groups,
                 int num_seqs, int num_kv_heads, int max_q_blocks, int n_splits,
                 int tiles_per_split, cudaStream_t stream) {
  const int rows = groups * block_q;
  if (rows > 64 || page_size > 128) return (int)cudaErrorInvalidValue;
  const int smem = (int)wgmma_smem<D>();
  if (max_q_blocks == 1) {  // decode: split over the kv walk, then combine
    const int tiles = (max_pages * page_size + 63) / 64;
    // the combine reads ws_acc rows in float4 (D 128) / float2 (D 64) loads
    if (ws_acc == nullptr || ws_ml == nullptr || reinterpret_cast<uintptr_t>(ws_acc) % 16 ||
        reinterpret_cast<uintptr_t>(ws_ml) % 8 || tiles_per_split < 1 ||
        n_splits > kMaxSplits || (long long)n_splits * tiles_per_split < tiles)
      return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(ragged_wgmma<D, true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    ragged_wgmma<D, true><<<dim3(n_splits, num_kv_heads, num_seqs), kNT, smem, stream>>>(
        q, k_pages, v_pages, starts, counts, q_lens, kv_lens, tables, out, ws_acc, ws_ml,
        q_scale, t_rows, num_pages, page_size, max_pages, block_q, groups, 1, 1,
        tiles_per_split);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ragged_combine<D><<<dim3(num_kv_heads, num_seqs), kCombineThreads, 0, stream>>>(
        ws_acc, ws_ml, starts, counts, q_lens, kv_lens, out, t_rows, page_size, max_pages,
        block_q, groups, n_splits, tiles_per_split);
    return (int)cudaGetLastError();
  }
  const int nqb = 64 / rows;
  cudaError_t err = cudaFuncSetAttribute(ragged_wgmma<D, false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ragged_wgmma<D, false>
      <<<dim3((max_q_blocks + nqb - 1) / nqb, num_kv_heads, num_seqs), kNT, smem, stream>>>(
          q, k_pages, v_pages, starts, counts, q_lens, kv_lens, tables, out, nullptr, nullptr,
          q_scale, t_rows, num_pages, page_size, max_pages, block_q, groups, nqb,
          max_q_blocks, 0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (FMA kernel), 1 = bfloat16 (wgmma kernels); head_dim 64
// or 128. q is UNSCALED: the kernels scale it by q_scale as they load it.
// ws_acc (S, Hkv, n_splits, groups * block_q, D), 16-byte aligned, and
// ws_ml (the same rows, float2) are the bf16 decode path's f32 workspace
// (max_q_blocks == 1; null otherwise). Returns cudaGetLastError() after the
// launches.
int ragged_paged_attention_launch(const void* q, const void* k_pages, const void* v_pages,
                                  const void* starts, const void* counts, const void* q_lens,
                                  const void* kv_lens, const void* tables, void* out,
                                  void* ws_acc, void* ws_ml, float q_scale, int dtype,
                                  int head_dim, int t_rows, int num_pages, int page_size,
                                  int max_pages, int block_q, int groups, int num_seqs,
                                  int num_kv_heads, int max_q_blocks, int n_splits,
                                  int tiles_per_split, void* stream) {
  if (max_q_blocks == 0 || num_seqs == 0) return 0;
  const int* st = static_cast<const int*>(starts);
  const int* ct = static_cast<const int*>(counts);
  const int* ql = static_cast<const int*>(q_lens);
  const int* kl = static_cast<const int*>(kv_lens);
  const int* tb = static_cast<const int*>(tables);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const float* qf = static_cast<const float*>(q);
    const float* kf = static_cast<const float*>(k_pages);
    const float* vf = static_cast<const float*>(v_pages);
    float* of = static_cast<float*>(out);
#define FMA_CALL(D)                                                                         \
  launch_fma_rows<D>(qf, kf, vf, st, ct, ql, kl, tb, of, q_scale, t_rows, num_pages,        \
                     page_size, max_pages, block_q, groups, num_seqs, num_kv_heads,         \
                     max_q_blocks, s)
    if (head_dim == 64) return FMA_CALL(64);
    if (head_dim == 128) return FMA_CALL(128);
#undef FMA_CALL
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 1) {
    const bf16* qb = static_cast<const bf16*>(q);
    const bf16* kb = static_cast<const bf16*>(k_pages);
    const bf16* vb = static_cast<const bf16*>(v_pages);
    bf16* ob = static_cast<bf16*>(out);
    float* wa = static_cast<float*>(ws_acc);
    float2* wm = static_cast<float2*>(ws_ml);
#define WG_CALL(D)                                                                          \
  launch_wgmma<D>(qb, kb, vb, st, ct, ql, kl, tb, ob, wa, wm, q_scale, t_rows, num_pages,   \
                  page_size, max_pages, block_q, groups, num_seqs, num_kv_heads,            \
                  max_q_blocks, n_splits, tiles_per_split, s)
    if (head_dim == 64) return WG_CALL(64);
    if (head_dim == 128) return WG_CALL(128);
#undef WG_CALL
  }
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
