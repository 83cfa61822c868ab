// Attention forward kernel shared by flash_fwd.cu (every key) and
// band_attention.cu (the band: query window i sees key windows i-1 and i).
//
// One block of 256 threads owns one (bh, 16-row query tile) and walks the
// key tiles of 32 columns of its key span in order, keeping the running
// max, the running sum and the output accumulator in fp32 (the TPU kernels'
// VMEM scratch becomes shared memory and registers). The sequential TPU
// grid axis over key tiles becomes the loop inside the block; the (bh, q
// tile) axes become the CUDA grid, which the SMs run in parallel.
//  * Q tile: fp32 in shared memory, 16 x Dh (73.7 KB at Dh 1152, above the
//    48 KB static limit, hence dynamic shared memory with the attribute).
//  * Logits: each warp owns 4 key columns; its lanes stride the head dim,
//    so K loads and Q reads are unit-stride across the warp and no
//    16-byte alignment is assumed (Dh 392 rows start 784 bytes apart).
//    The partial dot products meet in a warp shuffle reduction.
//  * Softmax: one lane per key column (the key tile is one warp wide),
//    two query rows per warp. Masked elements take weight 0.
//  * P.V: thread t owns head-dim columns t, t+256, ... for all 16 rows;
//    V is read once per block straight from global memory, unit-stride.
// The head dim is never tiled for the accumulator: NC = ceil(Dh/256) <= 5
// chunks of 16 fp32 registers each cover Dh up to 1280.
// With Band false the key span is [0, S) and the only mask is col < S;
// with Band true it is key_span's and the band is masked per element.
#pragma once

#include "flash_common.cuh"

namespace tchvp {

constexpr int kFwdBlockQ = 16;
constexpr int kFwdBlockK = 32;  // one warp wide: one lane per key column
constexpr int kFwdThreads = 256;
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kFwdKeysPerWarp = kFwdBlockK / kFwdWarps;  // 4
constexpr int kFwdRowsPerWarp = kFwdBlockQ / kFwdWarps;  // 2

template <typename T, int NC, bool Band>
__global__ void __launch_bounds__(kFwdThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int seq_len, int head_dim, int window,
                     float scale, int dropout, float keep_prob,
                     uint32_t drop_threshold, const int* __restrict__ seed) {
  extern __shared__ float smem[];
  float* q_s = smem;                            // [kFwdBlockQ][head_dim]
  float* p_s = q_s + kFwdBlockQ * head_dim;     // [kFwdBlockQ][kFwdBlockK]
  float* m_s = p_s + kFwdBlockQ * kFwdBlockK;   // running max
  float* l_s = m_s + kFwdBlockQ;                // running (undropped) sum
  float* a_s = l_s + kFwdBlockQ;                // this tile's rescale factor

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kFwdBlockQ;
  const size_t base = (size_t)bh * seq_len * head_dim;
  const T* kb = k + base;
  const T* vb = v + base;
  int k_lo, k_hi;
  key_span<Band>(q0, min(seq_len, q0 + kFwdBlockQ) - 1, seq_len, window, &k_lo, &k_hi);

  stage_rows<kFwdThreads>(q_s, q + base, q0, kFwdBlockQ, seq_len, head_dim);
  if (tid < kFwdBlockQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kFwdBlockQ][NC];
#pragma unroll
  for (int r = 0; r < kFwdBlockQ; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  const uint32_t hash_base = dropout ? dropout_base(seed, bh) : 0u;
  __syncthreads();

  for (int k0 = k_lo; k0 < k_hi; k0 += kFwdBlockK) {
    // 1. Logits of this warp's key columns against the 16 query rows.
    const int jw = k0 + warp * kFwdKeysPerWarp;
    float s[kFwdKeysPerWarp][kFwdBlockQ];
#pragma unroll
    for (int kk = 0; kk < kFwdKeysPerWarp; ++kk)
#pragma unroll
      for (int r = 0; r < kFwdBlockQ; ++r) s[kk][r] = 0.f;
    for (int d = lane; d < head_dim; d += 32) {
      float kv[kFwdKeysPerWarp];
#pragma unroll
      for (int kk = 0; kk < kFwdKeysPerWarp; ++kk)
        kv[kk] = (jw + kk < k_hi) ? to_f32(kb[(size_t)(jw + kk) * head_dim + d]) : 0.f;
#pragma unroll
      for (int r = 0; r < kFwdBlockQ; ++r) {
        const float qv = q_s[r * head_dim + d];
#pragma unroll
        for (int kk = 0; kk < kFwdKeysPerWarp; ++kk) s[kk][r] = fmaf(qv, kv[kk], s[kk][r]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kFwdKeysPerWarp; ++kk) {
      const int col = jw + kk;
#pragma unroll
      for (int r = 0; r < kFwdBlockQ; ++r) {
        const float total = warp_sum(s[kk][r]);
        if (lane == r) {
          const bool valid = col < k_hi && in_band<Band>(q0 + r, col, window);
          p_s[r * kFwdBlockK + warp * kFwdKeysPerWarp + kk] = valid ? total * scale : kNegInf;
        }
      }
    }
    __syncthreads();

    // 2. Online softmax: lane = key column, kFwdRowsPerWarp rows per warp.
    const int col = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < kFwdRowsPerWarp; ++rr) {
      const int r = warp * kFwdRowsPerWarp + rr;
      const float x = p_s[r * kFwdBlockK + lane];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(x));
      // Without the band a masked column (col >= S) gives exp(-1e30 - m) = 0
      // since the first tile holds a real column of every row; in the band
      // a row may see a whole tile masked, so its weights are set to 0.
      const bool valid = !Band || (col < k_hi && in_band<Band>(q0 + r, col, window));
      float p = valid ? expf(x - m_new) : 0.f;
      const float alpha = expf(m_prev - m_new);
      const float sum = warp_sum(p);  // l takes the undropped sum
      if (dropout) {
        p = keep_element(hash_base, q0 + r, col, drop_threshold) ? p / keep_prob : 0.f;
      }
      p_s[r * kFwdBlockK + lane] = p;
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // 3. acc = acc * alpha + P V over this thread's head-dim columns.
    const int jn = min(kFwdBlockK, k_hi - k0);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tid + c * kFwdThreads;
      if (d < head_dim) {
#pragma unroll
        for (int r = 0; r < kFwdBlockQ; ++r) acc[r][c] *= a_s[r];
        for (int j = 0; j < jn; ++j) {
          const float vv = to_f32(vb[(size_t)(k0 + j) * head_dim + d]);
#pragma unroll
          for (int r = 0; r < kFwdBlockQ; ++r) acc[r][c] = fmaf(p_s[r * kFwdBlockK + j], vv, acc[r][c]);
        }
      }
    }
    __syncthreads();
  }

  // Finalize: rows whose l is 0 (none when S >= 1) divide by 1, as safe_l.
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d = tid + c * kFwdThreads;
    if (d < head_dim) {
#pragma unroll
      for (int r = 0; r < kFwdBlockQ; ++r) {
        if (q0 + r < seq_len) {
          const float l = l_s[r];
          const float safe_l = (l == 0.f) ? 1.f : l;
          out[base + (size_t)(q0 + r) * head_dim + d] = from_f32<T>(acc[r][c] / safe_l);
        }
      }
    }
  }
  if (tid < kFwdBlockQ && q0 + tid < seq_len) {
    const float l = l_s[tid];
    const float safe_l = (l == 0.f) ? 1.f : l;
    lse[(size_t)bh * seq_len + q0 + tid] = m_s[tid] + logf(safe_l);
  }
}

template <typename T, int NC, bool Band>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                       int batch_heads, int seq_len, int head_dim, int window, float scale,
                       float dropout_rate, uint32_t drop_threshold, const int* seed,
                       cudaStream_t stream) {
  const size_t smem =
      (size_t)(kFwdBlockQ * head_dim + kFwdBlockQ * kFwdBlockK + 3 * kFwdBlockQ) * sizeof(float);
  auto kernel = attention_fwd_kernel<T, NC, Band>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_len + kFwdBlockQ - 1) / kFwdBlockQ, batch_heads);
  kernel<<<grid, kFwdThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), seq_len, head_dim, window, scale,
      dropout_rate > 0.f ? 1 : 0, 1.f - dropout_rate, drop_threshold, seed);
  return cudaGetLastError();
}

template <typename T, bool Band>
cudaError_t dispatch_fwd(int chunks, const void* q, const void* k, const void* v, void* out,
                         void* lse, int batch_heads, int seq_len, int head_dim, int window,
                         float scale, float dropout_rate, uint32_t drop_threshold,
                         const int* seed, cudaStream_t stream) {
#define TCHVP_LAUNCH(NC)                                                                   \
  case NC:                                                                               \
    return launch_fwd<T, NC, Band>(q, k, v, out, lse, batch_heads, seq_len, head_dim,   \
                                   window, scale, dropout_rate, drop_threshold, seed, stream);
  switch (chunks) {
    TCHVP_LAUNCH(1)
    TCHVP_LAUNCH(2)
    TCHVP_LAUNCH(3)
    TCHVP_LAUNCH(4)
    TCHVP_LAUNCH(5)
    default:
      return cudaErrorInvalidValue;
  }
#undef TCHVP_LAUNCH
}

// The C launchers' body: checks the arguments, picks the dtype and the
// number of head-dim chunks, and launches on `stream`.
template <bool Band>
int run_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
            int batch_heads, int seq_len, int head_dim, int window, int is_bf16,
            float scale, float dropout_rate, unsigned int drop_threshold,
            const void* seed, void* stream) {
  if (batch_heads < 1 || batch_heads > 65535 || seq_len < 1 || head_dim < 1 ||
      (Band && (window < 1 || window > seq_len)) || (dropout_rate > 0.f && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  const int chunks = (head_dim + kFwdThreads - 1) / kFwdThreads;
  if (chunks > kMaxChunks) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* seed_i = static_cast<const int*>(seed);
  if (is_bf16)
    return (int)dispatch_fwd<__nv_bfloat16, Band>(chunks, q, k, v, out, lse, batch_heads,
                                                  seq_len, head_dim, window, scale,
                                                  dropout_rate, drop_threshold, seed_i, s);
  return (int)dispatch_fwd<float, Band>(chunks, q, k, v, out, lse, batch_heads, seq_len,
                                        head_dim, window, scale, dropout_rate,
                                        drop_threshold, seed_i, s);
}

}  // namespace tchvp
