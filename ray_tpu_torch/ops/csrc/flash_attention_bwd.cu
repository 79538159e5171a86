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
// What the design does about it, in this first version:
// - dkv kernel: one block per (64-row kv tile, kv head, batch). K_j and V_j
//   stay in shared memory for the whole block. The block walks the q heads
//   of the kv head's GQA group and, for each, the q tiles from the causal
//   diagonal to the end, so a kv head is never repeated in memory and the
//   group sum that JAX does after its kernel happens in the f32
//   accumulators. Each tile recomputes S and dP (2 products) and adds into
//   dV and dK (2 more).
// - dq kernel: one block per (64-row q tile, q head, batch). Q_i and dO_i
//   stay in shared memory; K/V tiles of kv head h / groups stream through up
//   to the causal diagonal. It recomputes S and dP and adds into dQ.
// - No atomics: every output element has one owner block, so the gradients
//   are deterministic run to run.
// - q rows at or past S and kv rows at or past Skv are masked inside the
//   kernels (the JAX wrapper pads instead and relies on zero dO in the pad).
// The products run as f32 FMAs from shared memory (7 products where the
// function needs 5), a long way under the tensor-core rate; wgmma, TMA and
// the K4-style overlapped schedule are the later changes that move these
// kernels towards their bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 256;  // 16 x 16: tx walks columns / head dims, ty rows
constexpr int kBlockQ = 64;
constexpr int kBlockKV = 64;
constexpr int kRI = kBlockQ / 16;   // score rows per thread: ty + 16 * i
constexpr int kCJ = kBlockKV / 16;  // score columns per thread: tx + 16 * j
constexpr int kPS = kBlockKV + 1;   // row stride of the (64, 64) score tiles in shared memory

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

// dtype: 0 = float32, 1 = bfloat16; head_dim 64 or 128.
template <bool kDkv>
int dispatch(int dtype, int head_dim, const Args& a) {
  if (a.batch == 0 || a.sq == 0 || a.skv == 0) return 0;
  if (a.num_kv_heads <= 0 || a.num_q_heads % a.num_kv_heads) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && head_dim == 64) return kDkv ? launch_dkv<float, 64>(a) : launch_dq<float, 64>(a);
  if (dtype == 0 && head_dim == 128)
    return kDkv ? launch_dkv<float, 128>(a) : launch_dq<float, 128>(a);
  if (dtype == 1 && head_dim == 64)
    return kDkv ? launch_dkv<__nv_bfloat16, 64>(a) : launch_dq<__nv_bfloat16, 64>(a);
  if (dtype == 1 && head_dim == 128)
    return kDkv ? launch_dkv<__nv_bfloat16, 128>(a) : launch_dq<__nv_bfloat16, 128>(a);
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
