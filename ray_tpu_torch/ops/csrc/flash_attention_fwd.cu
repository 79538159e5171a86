// Flash-attention forward for Hopper (sm_90a).
//
// Replaces: ray_tpu/ops/attention.py, `_fwd_kernel` driven by `_fwd_pallas`
// (the classic Pallas TPU forward), and with it the function of the
// pipelined TPU forward `_fwd_pipe_tpu`, which computes the same outputs on
// a skewed schedule.
//
// What bounds it on the H100: operations. A (64-row q tile, kv tile) pair
// does 4 * 64 * 64 * D flops on 2 * 64 * D loaded elements, so long
// sequences are far above the ~295 flop/byte ridge and the limit is the
// multiply rate: 989 TFLOP/s in bf16 on the tensor cores.
//
// What the design does about it, in this first version: one thread block
// per (64-row q tile, q head, batch). The q tile stays in shared memory for
// the block's whole kv loop, so q is read once; K/V tiles of 64 rows stream
// through shared memory once per q tile, up to the causal diagonal only.
// GQA maps q head h onto kv head h / groups, so a kv head is never
// repeated in memory. The products run as f32 FMAs from shared memory, a
// long way under the tensor-core rate; the wgmma + TMA ping-pong schedule
// (the counterpart of the TPU's pipelined forward) is the later change that
// moves this kernel towards its bound.
//
// Numerics follow the TPU kernel: scores are f32, the online softmax runs
// in base 2 with log2(e) folded into the scale, p is rounded to v's dtype
// before P.V (f32 accumulate), and the stored lse is the NATURAL-log
// logsumexp; a row with no unmasked column gets lse -1e30 and O = 0. Keys at
// or past kv_len are masked. The plain PyTorch version is
// `_flash_fwd_plain` in ray_tpu_torch/ops/attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;  // 1 / log2(e)
constexpr int kThreads = 256;  // 16 x 16: tx walks kv columns / head dims, ty rows
constexpr int kBlockQ = 64;
constexpr int kBlockKV = 64;
constexpr int kRI = kBlockQ / 16;
constexpr int kCJ = kBlockKV / 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

template <typename T>
int launch_dim(int head_dim, const void* q, const void* k, const void* v, void* out,
               float* lse, int batch, int num_q_heads, int num_kv_heads, int sq,
               int skv, int causal, float scale_log2, cudaStream_t stream) {
  if (head_dim == 64)
    return launch_typed<T, 64>(q, k, v, out, lse, batch, num_q_heads, num_kv_heads, sq,
                               skv, causal, scale_log2, stream);
  if (head_dim == 128)
    return launch_typed<T, 128>(q, k, v, out, lse, batch, num_q_heads, num_kv_heads, sq,
                                skv, causal, scale_log2, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D),
// out like q, lse (B, Hq, Sq) float32. Returns cudaGetLastError() after launch.
int flash_attention_fwd_launch(const void* q, const void* k, const void* v, void* out,
                               void* lse, int dtype, int head_dim, int batch,
                               int num_q_heads, int num_kv_heads, int sq, int skv,
                               int causal, float scale_log2, void* stream) {
  if (batch == 0 || sq == 0) return 0;
  if (num_kv_heads <= 0 || num_q_heads % num_kv_heads) return (int)cudaErrorInvalidValue;
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dim<float>(head_dim, q, k, v, out, l, batch, num_q_heads, num_kv_heads,
                             sq, skv, causal, scale_log2, s);
  if (dtype == 1)
    return launch_dim<__nv_bfloat16>(head_dim, q, k, v, out, l, batch, num_q_heads,
                                     num_kv_heads, sq, skv, causal, scale_log2, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
