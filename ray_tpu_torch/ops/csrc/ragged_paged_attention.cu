// Ragged paged attention for Hopper (sm_90a).
//
// Replaces: ray_tpu/ops/ragged_paged_attention.py, `_ragged_kernel` driven by
// `_ragged_pallas` (the Pallas TPU kernel). One launch covers every region
// shape the serving engine dispatches: prefill chunks at any offset, decode
// lanes (q_len 1), verify regions (q_len K), inactive lanes (q_len 0).
//
// What bounds it on the H100: the bytes of the K/V pages it reads. Every
// query row of a region attends to the same pages, and the GQA group of
// `groups` query heads shares one kv head, so at decode (q_len 1) each page
// byte feeds only 2 * groups flops per element: far below the ~295 flop/byte
// the card needs before its tensor cores become the limit. Prefill chunks
// reuse each page for up to `chunk` query rows and move towards compute.
//
// What the design does about it: one thread block per (q block, kv head,
// sequence). The block holds all `groups * block_q` query rows of the GQA
// group, so each K/V page is read from device memory ONCE per q block and
// serves every query head of the group from shared memory. Pages are walked
// through the sequence's own block-table row and only up to the causal
// frontier `pos_hi` of the block's last real row (the TPU kernel's `work`
// predicate), so pages past the frontier are never fetched.
//
// Numerics follow the TPU kernel: q arrives pre-scaled (the wrapper rounds
// q * sm_scale to q's own dtype first), logits and the online softmax are
// f32 with plain expf and the finite -1e30 mask, and p stays f32 in P.V.
// Masked rows of a processed page get p = exp(0) = 1 exactly as on the TPU
// (pad rows come back finite); blocks past the region's real rows and
// inactive lanes write zeros (safe_l); blocks past `counts[s]` write nothing.
// The plain PyTorch version is `ragged_reference_attention` in
// ray_tpu_torch/ops/ragged_paged_attention.py.
//
// This first version computes with f32 FMAs from shared memory; moving the
// products onto the tensor cores (wgmma) and the page loads onto TMA is the
// work of a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;  // 16 x 16: tx walks columns, ty walks rows

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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

// Shared memory: sQ[R][D+1] | sK[ps][D+1] (reused as sP[R][ps+1]) | sV[ps][D].
// The +1 strides keep the column-per-lane reads of sQ and sK free of bank
// conflicts.
// RI = rows per thread (rows <= 16 * RI), CJ = page columns per thread
// (page_size <= 16 * CJ): both fixed at compile time so no FMA is spent on
// rows or columns the block does not have.
template <typename T, int D, int RI, int CJ>
__global__ void __launch_bounds__(kThreads)
ragged_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
              const T* __restrict__ v_pages, const int* __restrict__ starts,
              const int* __restrict__ counts, const int* __restrict__ q_lens,
              const int* __restrict__ kv_lens, const int* __restrict__ tables,
              T* __restrict__ out, int t_rows, int num_pages, int page_size,
              int max_pages, int block_q, int groups) {
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

  // query rows: r -> (head g*groups + r / block_q, token row0 + r % block_q)
  for (int idx = tid; idx < rows * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    const int h = g * groups + r / block_q;
    const int t = row0 + r % block_q;
    sQ[r * (D + 1) + d] = to_f32(q[((size_t)h * t_rows + t) * D + d]);
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
    const T* kp = k_pages + ((size_t)g * num_pages + page) * page_elems;
    const T* vp = v_pages + ((size_t)g * num_pages + page) * page_elems;
    __syncthreads();  // previous page's sP / sV reads are done
    for (int idx = tid; idx < ps * D; idx += kThreads) {
      const int c = idx / D, d = idx - c * D;
      sK[c * (D + 1) + d] = to_f32(kp[idx]);
      sV[idx] = to_f32(vp[idx]);
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
    T* o = out + ((size_t)h * t_rows + t) * D;
#pragma unroll
    for (int j = 0; j < kDIters; ++j) o[tx + 16 * j] = from_f32<T>(acc[i][j] / safe_l);
  }
}

template <typename T, int D, int RI, int CJ>
int launch_typed(const void* q, const void* k_pages, const void* v_pages,
                 const int* starts, const int* counts, const int* q_lens,
                 const int* kv_lens, const int* tables, void* out, int t_rows,
                 int num_pages, int page_size, int max_pages, int block_q,
                 int groups, int num_seqs, int num_kv_heads, int max_q_blocks,
                 cudaStream_t stream) {
  const int rows = groups * block_q;
  const int k_floats = page_size * (D + 1), p_floats = rows * (page_size + 1);
  const int kp_floats = k_floats > p_floats ? k_floats : p_floats;
  const size_t smem =
      sizeof(float) * ((size_t)rows * (D + 1) + kp_floats + (size_t)page_size * D);
  cudaError_t err = cudaFuncSetAttribute(
      ragged_kernel<T, D, RI, CJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(max_q_blocks, num_kv_heads, num_seqs);
  ragged_kernel<T, D, RI, CJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), starts, counts, q_lens, kv_lens, tables,
      static_cast<T*>(out), t_rows, num_pages, page_size, max_pages, block_q, groups);
  return (int)cudaGetLastError();
}

#define RPA_ARGS                                                                     \
  q, k_pages, v_pages, starts, counts, q_lens, kv_lens, tables, out, t_rows,         \
      num_pages, page_size, max_pages, block_q, groups, num_seqs, num_kv_heads,      \
      max_q_blocks, stream

template <typename T, int D, int RI>
int launch_cols(const void* q, const void* k_pages, const void* v_pages,
                const int* starts, const int* counts, const int* q_lens,
                const int* kv_lens, const int* tables, void* out, int t_rows,
                int num_pages, int page_size, int max_pages, int block_q, int groups,
                int num_seqs, int num_kv_heads, int max_q_blocks, cudaStream_t stream) {
  if (page_size <= 32) return launch_typed<T, D, RI, 2>(RPA_ARGS);
  if (page_size <= 64) return launch_typed<T, D, RI, 4>(RPA_ARGS);
  if (page_size <= 128) return launch_typed<T, D, RI, 8>(RPA_ARGS);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int D>
int launch_rows(const void* q, const void* k_pages, const void* v_pages,
                const int* starts, const int* counts, const int* q_lens,
                const int* kv_lens, const int* tables, void* out, int t_rows,
                int num_pages, int page_size, int max_pages, int block_q, int groups,
                int num_seqs, int num_kv_heads, int max_q_blocks, cudaStream_t stream) {
  const int rows = groups * block_q;
  if (rows <= 16) return launch_cols<T, D, 1>(RPA_ARGS);
  if (rows <= 32) return launch_cols<T, D, 2>(RPA_ARGS);
  if (rows <= 64) return launch_cols<T, D, 4>(RPA_ARGS);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_dim(int head_dim, const void* q, const void* k_pages, const void* v_pages,
               const int* starts, const int* counts, const int* q_lens,
               const int* kv_lens, const int* tables, void* out, int t_rows,
               int num_pages, int page_size, int max_pages, int block_q, int groups,
               int num_seqs, int num_kv_heads, int max_q_blocks, cudaStream_t stream) {
  if (head_dim == 64) return launch_rows<T, 64>(RPA_ARGS);
  if (head_dim == 128) return launch_rows<T, 128>(RPA_ARGS);
  return (int)cudaErrorInvalidValue;
}

#undef RPA_ARGS

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after launch.
int ragged_paged_attention_launch(const void* q, const void* k_pages,
                                  const void* v_pages, const void* starts,
                                  const void* counts, const void* q_lens,
                                  const void* kv_lens, const void* tables, void* out,
                                  int dtype, int head_dim, int t_rows, int num_pages,
                                  int page_size, int max_pages, int block_q, int groups,
                                  int num_seqs, int num_kv_heads, int max_q_blocks,
                                  void* stream) {
  if (max_q_blocks == 0 || num_seqs == 0) return 0;
  const int* st = static_cast<const int*>(starts);
  const int* ct = static_cast<const int*>(counts);
  const int* ql = static_cast<const int*>(q_lens);
  const int* kl = static_cast<const int*>(kv_lens);
  const int* tb = static_cast<const int*>(tables);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dim<float>(head_dim, q, k_pages, v_pages, st, ct, ql, kl, tb, out,
                             t_rows, num_pages, page_size, max_pages, block_q, groups,
                             num_seqs, num_kv_heads, max_q_blocks, s);
  if (dtype == 1)
    return launch_dim<__nv_bfloat16>(head_dim, q, k_pages, v_pages, st, ct, ql, kl, tb,
                                     out, t_rows, num_pages, page_size, max_pages,
                                     block_q, groups, num_seqs, num_kv_heads,
                                     max_q_blocks, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
