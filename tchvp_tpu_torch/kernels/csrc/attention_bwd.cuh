// Attention backward kernels shared by flash_bwd.cu (every key) and
// band_attention.cu (the band): the dq kernel and the dk/dv kernel.
//
// Both recompute the softmax weights P = exp(q k^T * scale - lse) from the
// forward's fp32 log-sum-exp, so nothing of size S x S is stored, and both
// take delta = rowsum(do * out) (fp32, computed by the wrapper). With
// dropout the keep mask of the forward (flash_common.cuh) rides on dp and on
// P for dv:
//   ds = P * (dp * keep / (1 - rate) - delta) * scale.
// Key columns and query rows outside the span (>= S without the band)
// contribute nothing, nor do pairs outside the band.
//
// As on the TPU there are two kernels and no atomics, so every gradient
// element is summed by one thread in one order and the result is the same,
// bit for bit, from run to run.
//  * dq: one block of 256 threads owns one (bh, 16-row query tile) and walks
//    the key tiles of 16 columns of its key span. The q and do tiles are
//    fp32 in shared memory (2 x 16 x Dh x 4 bytes: 147 KB at Dh 1152). Each
//    warp owns two key columns; its lanes stride the head dim (unit-stride
//    K/V loads, no 16-byte alignment assumed: Dh 392 rows start 784 bytes
//    apart) and the partial dot products for s and dp meet in a warp
//    shuffle reduction, after which lane r forms ds for query row r. Thread
//    t then owns head-dim columns t, t+256, ... of the dq accumulator
//    (16 x NC fp32 registers, NC = ceil(Dh/256) <= 5).
//  * dk/dv: one block owns one (bh, 8-key tile) and walks the query tiles of
//    16 rows of its query span, staging each q and do tile in shared
//    memory. Warp w owns key w of the tile. A 16-key tile's dk and dv
//    accumulators would take 2 x 16 x Dh x 4 bytes (147 KB at Dh 1152) and
//    spill as registers; the 8-key tile keeps them in 2 x 8 x NC registers
//    per thread, the size of the forward's accumulator.
#pragma once

#include "flash_common.cuh"

namespace tchvp {

constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;

// dq kernel tiles.
constexpr int kDqRows = 16;
constexpr int kDqKeys = 16;
constexpr int kDqKeysPerWarp = kDqKeys / kBwdWarps;  // 2

// dk/dv kernel tiles: one key per warp.
constexpr int kKvKeys = kBwdWarps;  // 8
constexpr int kKvRows = 16;

// ds of one (row, col) weight from its scaled logit and dp; with dropout
// also the dropped weight P * keep / (1 - rate) for dv.
__device__ __forceinline__ float grad_logit(float logit, float dp, float lse, float delta,
                                            float scale, bool keep, float keep_prob,
                                            float* p_drop) {
  const float p = expf(logit - lse);
  const float dpm = keep ? dp / keep_prob : 0.f;
  *p_drop = keep ? p / keep_prob : 0.f;
  return p * (dpm - delta) * scale;
}

template <typename T, int NC, bool Band>
__global__ void __launch_bounds__(kBwdThreads)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, int seq_len, int head_dim, int window, float scale,
                        int dropout, float keep_prob, uint32_t drop_threshold,
                        const int* __restrict__ seed) {
  extern __shared__ float smem[];
  float* q_s = smem;                                // [kDqRows][head_dim]
  float* do_s = q_s + kDqRows * head_dim;           // [kDqRows][head_dim]
  float* ds_s = do_s + kDqRows * head_dim;          // [kDqRows][kDqKeys]
  float* lse_s = ds_s + kDqRows * kDqKeys;          // [kDqRows]
  float* delta_s = lse_s + kDqRows;                 // [kDqRows]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kDqRows;
  const size_t base = (size_t)bh * seq_len * head_dim;
  const T* kb = k + base;
  const T* vb = v + base;
  int k_lo, k_hi;
  key_span<Band>(q0, min(seq_len, q0 + kDqRows) - 1, seq_len, window, &k_lo, &k_hi);

  stage_rows<kBwdThreads>(q_s, q + base, q0, kDqRows, seq_len, head_dim);
  stage_rows<kBwdThreads>(do_s, dout + base, q0, kDqRows, seq_len, head_dim);
  if (tid < kDqRows) {
    const bool row_ok = q0 + tid < seq_len;
    lse_s[tid] = row_ok ? lse[(size_t)bh * seq_len + q0 + tid] : 0.f;
    delta_s[tid] = row_ok ? delta[(size_t)bh * seq_len + q0 + tid] : 0.f;
  }
  float acc[kDqRows][NC];
#pragma unroll
  for (int r = 0; r < kDqRows; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  const uint32_t hash_base = dropout ? dropout_base(seed, bh) : 0u;
  __syncthreads();

  for (int k0 = k_lo; k0 < k_hi; k0 += kDqKeys) {
    // 1. s = q k^T and dp = do v^T for this warp's two key columns.
    const int jw = k0 + warp * kDqKeysPerWarp;
    float s[kDqKeysPerWarp][kDqRows];
    float dp[kDqKeysPerWarp][kDqRows];
#pragma unroll
    for (int kk = 0; kk < kDqKeysPerWarp; ++kk)
#pragma unroll
      for (int r = 0; r < kDqRows; ++r) s[kk][r] = dp[kk][r] = 0.f;
    for (int d = lane; d < head_dim; d += 32) {
      float kv[kDqKeysPerWarp], vv[kDqKeysPerWarp];
#pragma unroll
      for (int kk = 0; kk < kDqKeysPerWarp; ++kk) {
        const bool ok = jw + kk < k_hi;
        kv[kk] = ok ? to_f32(kb[(size_t)(jw + kk) * head_dim + d]) : 0.f;
        vv[kk] = ok ? to_f32(vb[(size_t)(jw + kk) * head_dim + d]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kDqRows; ++r) {
        const float qv = q_s[r * head_dim + d];
        const float ov = do_s[r * head_dim + d];
#pragma unroll
        for (int kk = 0; kk < kDqKeysPerWarp; ++kk) {
          s[kk][r] = fmaf(qv, kv[kk], s[kk][r]);
          dp[kk][r] = fmaf(ov, vv[kk], dp[kk][r]);
        }
      }
    }
    // 2. ds of (row r, key col) on lane r.
#pragma unroll
    for (int kk = 0; kk < kDqKeysPerWarp; ++kk) {
      const int col = jw + kk;
#pragma unroll
      for (int r = 0; r < kDqRows; ++r) {
        const float st = warp_sum(s[kk][r]);
        const float dpt = warp_sum(dp[kk][r]);
        if (lane == r) {
          float ds = 0.f, p_drop;
          if (col < k_hi && q0 + r < seq_len && in_band<Band>(q0 + r, col, window)) {
            const bool keep = !dropout || keep_element(hash_base, q0 + r, col, drop_threshold);
            ds = grad_logit(st * scale, dpt, lse_s[r], delta_s[r], scale, keep,
                            dropout ? keep_prob : 1.f, &p_drop);
          }
          ds_s[r * kDqKeys + warp * kDqKeysPerWarp + kk] = ds;
        }
      }
    }
    __syncthreads();

    // 3. dq += ds k over this thread's head-dim columns.
    const int jn = min(kDqKeys, k_hi - k0);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tid + c * kBwdThreads;
      if (d < head_dim) {
        for (int j = 0; j < jn; ++j) {
          const float kv = to_f32(kb[(size_t)(k0 + j) * head_dim + d]);
#pragma unroll
          for (int r = 0; r < kDqRows; ++r) acc[r][c] = fmaf(ds_s[r * kDqKeys + j], kv, acc[r][c]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d = tid + c * kBwdThreads;
    if (d < head_dim) {
#pragma unroll
      for (int r = 0; r < kDqRows; ++r)
        if (q0 + r < seq_len) dq[base + (size_t)(q0 + r) * head_dim + d] = from_f32<T>(acc[r][c]);
    }
  }
}

template <typename T, int NC, bool Band>
__global__ void __launch_bounds__(kBwdThreads)
attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int seq_len, int head_dim,
                         int window, float scale, int dropout, float keep_prob,
                         uint32_t drop_threshold, const int* __restrict__ seed) {
  extern __shared__ float smem[];
  float* q_s = smem;                                // [kKvRows][head_dim]
  float* do_s = q_s + kKvRows * head_dim;           // [kKvRows][head_dim]
  float* p_s = do_s + kKvRows * head_dim;           // [kKvRows][kKvKeys] dropped P
  float* ds_s = p_s + kKvRows * kKvKeys;            // [kKvRows][kKvKeys]
  float* lse_s = ds_s + kKvRows * kKvKeys;          // [kKvRows]
  float* delta_s = lse_s + kKvRows;                 // [kKvRows]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kKvKeys;
  const int col = k0 + warp;  // this warp's key
  const bool col_ok = col < seq_len;
  const size_t base = (size_t)bh * seq_len * head_dim;
  const T* kb = k + base;
  const T* vb = v + base;
  int q_lo, q_hi;
  query_span<Band>(k0, min(seq_len, k0 + kKvKeys) - 1, seq_len, window, &q_lo, &q_hi);

  float dk_acc[kKvKeys][NC], dv_acc[kKvKeys][NC];
#pragma unroll
  for (int j = 0; j < kKvKeys; ++j)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[j][c] = dv_acc[j][c] = 0.f;
  const uint32_t hash_base = dropout ? dropout_base(seed, bh) : 0u;

  for (int q0 = q_lo; q0 < q_hi; q0 += kKvRows) {
    stage_rows<kBwdThreads>(q_s, q + base, q0, kKvRows, seq_len, head_dim);
    stage_rows<kBwdThreads>(do_s, dout + base, q0, kKvRows, seq_len, head_dim);
    if (tid < kKvRows) {
      const bool row_ok = q0 + tid < q_hi;
      lse_s[tid] = row_ok ? lse[(size_t)bh * seq_len + q0 + tid] : 0.f;
      delta_s[tid] = row_ok ? delta[(size_t)bh * seq_len + q0 + tid] : 0.f;
    }
    __syncthreads();

    // 1. s = q k^T and dp = do v^T of the 16 rows against this warp's key.
    float s[kKvRows], dp[kKvRows];
#pragma unroll
    for (int r = 0; r < kKvRows; ++r) s[r] = dp[r] = 0.f;
    if (col_ok) {
      for (int d = lane; d < head_dim; d += 32) {
        const float kv = to_f32(kb[(size_t)col * head_dim + d]);
        const float vv = to_f32(vb[(size_t)col * head_dim + d]);
#pragma unroll
        for (int r = 0; r < kKvRows; ++r) {
          s[r] = fmaf(q_s[r * head_dim + d], kv, s[r]);
          dp[r] = fmaf(do_s[r * head_dim + d], vv, dp[r]);
        }
      }
    }
    // 2. The dropped weight and ds of (row r, this key) on lane r; the hash
    // takes (query row, key col), as in the forward.
#pragma unroll
    for (int r = 0; r < kKvRows; ++r) {
      const float st = warp_sum(s[r]);
      const float dpt = warp_sum(dp[r]);
      if (lane == r) {
        float ds = 0.f, p_drop = 0.f;
        if (col_ok && q0 + r < q_hi && in_band<Band>(q0 + r, col, window)) {
          const bool keep = !dropout || keep_element(hash_base, q0 + r, col, drop_threshold);
          ds = grad_logit(st * scale, dpt, lse_s[r], delta_s[r], scale, keep,
                          dropout ? keep_prob : 1.f, &p_drop);
        }
        p_s[r * kKvKeys + warp] = p_drop;
        ds_s[r * kKvKeys + warp] = ds;
      }
    }
    __syncthreads();

    // 3. dv += P_drop^T do and dk += ds^T q over this thread's columns.
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tid + c * kBwdThreads;
      if (d < head_dim) {
#pragma unroll
        for (int r = 0; r < kKvRows; ++r) {
          const float ov = do_s[r * head_dim + d];
          const float qv = q_s[r * head_dim + d];
#pragma unroll
          for (int j = 0; j < kKvKeys; ++j) {
            dv_acc[j][c] = fmaf(p_s[r * kKvKeys + j], ov, dv_acc[j][c]);
            dk_acc[j][c] = fmaf(ds_s[r * kKvKeys + j], qv, dk_acc[j][c]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d = tid + c * kBwdThreads;
    if (d < head_dim) {
#pragma unroll
      for (int j = 0; j < kKvKeys; ++j) {
        if (k0 + j < seq_len) {
          const size_t at = base + (size_t)(k0 + j) * head_dim + d;
          dk[at] = from_f32<T>(dk_acc[j][c]);
          dv[at] = from_f32<T>(dv_acc[j][c]);
        }
      }
    }
  }
}

struct BwdArgs {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int batch_heads, seq_len, head_dim, window;
  float scale, dropout_rate;
  uint32_t drop_threshold;
  const int* seed;
  cudaStream_t stream;
};

template <typename T, int NC, bool Band>
cudaError_t launch_dq(const BwdArgs& a) {
  const size_t smem = (size_t)(2 * kDqRows * a.head_dim + kDqRows * kDqKeys + 2 * kDqRows) * sizeof(float);
  auto kernel = attention_bwd_dq_kernel<T, NC, Band>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq_len + kDqRows - 1) / kDqRows, a.batch_heads);
  kernel<<<grid, kBwdThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dq), a.seq_len, a.head_dim,
      a.window, a.scale, a.dropout_rate > 0.f ? 1 : 0, 1.f - a.dropout_rate, a.drop_threshold,
      a.seed);
  return cudaGetLastError();
}

template <typename T, int NC, bool Band>
cudaError_t launch_dkv(const BwdArgs& a) {
  const size_t smem =
      (size_t)(2 * kKvRows * a.head_dim + 2 * kKvRows * kKvKeys + 2 * kKvRows) * sizeof(float);
  auto kernel = attention_bwd_dkv_kernel<T, NC, Band>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq_len + kKvKeys - 1) / kKvKeys, a.batch_heads);
  kernel<<<grid, kBwdThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.seq_len, a.head_dim, a.window, a.scale, a.dropout_rate > 0.f ? 1 : 0,
      1.f - a.dropout_rate, a.drop_threshold, a.seed);
  return cudaGetLastError();
}

template <typename T, int NC, bool Band>
cudaError_t launch_bwd(int which, const BwdArgs& a) {
  return which == 0 ? launch_dq<T, NC, Band>(a) : launch_dkv<T, NC, Band>(a);
}

template <typename T, bool Band>
cudaError_t dispatch_bwd(int which, int chunks, const BwdArgs& a) {
  switch (chunks) {
    case 1: return launch_bwd<T, 1, Band>(which, a);
    case 2: return launch_bwd<T, 2, Band>(which, a);
    case 3: return launch_bwd<T, 3, Band>(which, a);
    case 4: return launch_bwd<T, 4, Band>(which, a);
    case 5: return launch_bwd<T, 5, Band>(which, a);
    default: return cudaErrorInvalidValue;
  }
}

// The C launchers' body: `which` 0 runs the dq kernel into dq, 1 the dk/dv
// kernel into dk and dv. Checks the arguments, picks the dtype and the
// number of head-dim chunks (Dh <= 1280), and launches on `stream`.
template <bool Band>
int run_bwd(int which, const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dq, void* dk, void* dv, int batch_heads,
            int seq_len, int head_dim, int window, int is_bf16, float scale, float dropout_rate,
            unsigned int drop_threshold, const void* seed, void* stream) {
  if (batch_heads < 1 || batch_heads > 65535 || seq_len < 1 || head_dim < 1 ||
      (Band && (window < 1 || window > seq_len)) || (dropout_rate > 0.f && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  const int chunks = (head_dim + kBwdThreads - 1) / kBwdThreads;
  if (chunks > kMaxChunks) return (int)cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, dout, lse, delta, dq, dk, dv, batch_heads, seq_len, head_dim,
                  window, scale, dropout_rate, drop_threshold,
                  static_cast<const int*>(seed), static_cast<cudaStream_t>(stream)};
  return (int)(is_bf16 ? dispatch_bwd<__nv_bfloat16, Band>(which, chunks, a)
                       : dispatch_bwd<float, Band>(which, chunks, a));
}

}  // namespace tchvp
