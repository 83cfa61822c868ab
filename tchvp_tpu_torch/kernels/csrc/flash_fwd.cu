// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel tchvp_tpu/kernels/flash_attention.py
// (_fwd_kernel, driven by _flash_fwd): blockwise online-softmax attention
// over (BH, S, Dh) that writes `out` in the input dtype and the fp32
// log-sum-exp, masks key columns >= S, and can apply attention-weight
// dropout from the squirrel3 hash of the global (row, col) index, bit for
// bit the TPU kernel's mask.
//
// Design. One block of 256 threads owns one (bh, 16-row query tile) and
// walks the key tiles of 32 columns in order, keeping the running max, the
// running sum and the output accumulator in fp32 (the TPU kernel's VMEM
// scratch becomes shared memory and registers). The sequential TPU grid
// axis over key tiles becomes the loop inside the block; the (bh, q tile)
// axes become the CUDA grid, which the SMs run in parallel.
//  * Q tile: fp32 in shared memory, 16 x Dh (73.7 KB at Dh 1152, above the
//    48 KB static limit, hence dynamic shared memory with the attribute).
//  * Logits: each warp owns 4 key columns; its lanes stride the head dim,
//    so K loads and Q reads are unit-stride across the warp and no
//    16-byte alignment is assumed (Dh 392 rows start 784 bytes apart).
//    The partial dot products meet in a warp shuffle reduction.
//  * Softmax: one lane per key column (the key tile is one warp wide),
//    two query rows per warp.
//  * P.V: thread t owns head-dim columns t, t+256, ... for all 16 rows;
//    V is read once per block straight from global memory, unit-stride.
// The head dim is never tiled for the accumulator: NC = ceil(Dh/256) <= 5
// chunks of 16 fp32 registers each cover Dh up to 1280.
//
// Bound on the H100: at the flagship shape (BH 64, S 128, Dh 392, bf16)
// the bytes (q, k, v, out once: 25.7 MB) bound it at ~7.7 us against
// ~1.7 us of bf16 tensor-core work. This first version does the products
// on the fp32 CUDA cores and runs far above that bound (PERF.md); the
// tensor-core (wgmma) and TMA version is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 16;
constexpr int kBlockK = 32;  // one warp wide: one lane per key column
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKeysPerWarp = kBlockK / kWarps;  // 4
constexpr int kRowsPerWarp = kBlockQ / kWarps;  // 2
constexpr int kMaxChunks = 5;                   // Dh <= 1280
constexpr float kNegInf = -1e30f;               // the TPU kernel's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// _squirrel3 of flash_attention.py: uint32 arithmetic wraps as on the TPU.
__device__ __forceinline__ uint32_t squirrel3(uint32_t x) {
  x *= 0xB5297A4Du;
  x ^= x >> 8;
  x += 0x68E31DA4u;
  x ^= x << 8;
  x *= 0x1B56C4E9u;
  x ^= x >> 8;
  return x;
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int seq_len, int head_dim,
                 float scale, int dropout, float keep_prob,
                 uint32_t drop_threshold, uint32_t seed) {
  extern __shared__ float smem[];
  float* q_s = smem;                      // [kBlockQ][head_dim]
  float* p_s = q_s + kBlockQ * head_dim;  // [kBlockQ][kBlockK]
  float* m_s = p_s + kBlockQ * kBlockK;   // running max
  float* l_s = m_s + kBlockQ;             // running (undropped) sum
  float* a_s = l_s + kBlockQ;             // this tile's rescale factor

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const size_t base = (size_t)bh * seq_len * head_dim;
  const T* qb = q + base;
  const T* kb = k + base;
  const T* vb = v + base;

  for (int i = tid; i < kBlockQ * head_dim; i += kThreads) {
    const int r = i / head_dim;
    const int d = i - r * head_dim;
    q_s[i] = (q0 + r < seq_len) ? to_f32(qb[(size_t)(q0 + r) * head_dim + d]) : 0.f;
  }
  if (tid < kBlockQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kBlockQ][NC];
#pragma unroll
  for (int r = 0; r < kBlockQ; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  const uint32_t hash_base = seed * 0x9E3779B1u + (uint32_t)bh * 0x85EBCA77u;
  __syncthreads();

  for (int k0 = 0; k0 < seq_len; k0 += kBlockK) {
    // 1. Logits of this warp's key columns against the 16 query rows.
    const int jw = k0 + warp * kKeysPerWarp;
    float s[kKeysPerWarp][kBlockQ];
#pragma unroll
    for (int kk = 0; kk < kKeysPerWarp; ++kk)
#pragma unroll
      for (int r = 0; r < kBlockQ; ++r) s[kk][r] = 0.f;
    for (int d = lane; d < head_dim; d += 32) {
      float kv[kKeysPerWarp];
#pragma unroll
      for (int kk = 0; kk < kKeysPerWarp; ++kk)
        kv[kk] = (jw + kk < seq_len) ? to_f32(kb[(size_t)(jw + kk) * head_dim + d]) : 0.f;
#pragma unroll
      for (int r = 0; r < kBlockQ; ++r) {
        const float qv = q_s[r * head_dim + d];
#pragma unroll
        for (int kk = 0; kk < kKeysPerWarp; ++kk) s[kk][r] = fmaf(qv, kv[kk], s[kk][r]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kKeysPerWarp; ++kk) {
      const bool valid = jw + kk < seq_len;
#pragma unroll
      for (int r = 0; r < kBlockQ; ++r) {
        const float total = warp_sum(s[kk][r]);
        if (lane == r) p_s[r * kBlockK + warp * kKeysPerWarp + kk] = valid ? total * scale : kNegInf;
      }
    }
    __syncthreads();

    // 2. Online softmax: lane = key column, kRowsPerWarp rows per warp.
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const float x = p_s[r * kBlockK + lane];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(x));
      float p = expf(x - m_new);
      const float alpha = expf(m_prev - m_new);
      const float sum = warp_sum(p);  // l takes the undropped sum
      if (dropout) {
        uint32_t h = squirrel3((uint32_t)(q0 + r) ^ hash_base);
        h = squirrel3(h + (uint32_t)(k0 + lane) * 0x27D4EB2Fu);
        p = (h >= drop_threshold) ? p / keep_prob : 0.f;
      }
      p_s[r * kBlockK + lane] = p;
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // 3. acc = acc * alpha + P V over this thread's head-dim columns.
    const int jn = min(kBlockK, seq_len - k0);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tid + c * kThreads;
      if (d < head_dim) {
#pragma unroll
        for (int r = 0; r < kBlockQ; ++r) acc[r][c] *= a_s[r];
        for (int j = 0; j < jn; ++j) {
          const float vv = to_f32(vb[(size_t)(k0 + j) * head_dim + d]);
#pragma unroll
          for (int r = 0; r < kBlockQ; ++r) acc[r][c] = fmaf(p_s[r * kBlockK + j], vv, acc[r][c]);
        }
      }
    }
    __syncthreads();
  }

  // Finalize: rows whose l is 0 (none when S >= 1) divide by 1, as safe_l.
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d = tid + c * kThreads;
    if (d < head_dim) {
#pragma unroll
      for (int r = 0; r < kBlockQ; ++r) {
        if (q0 + r < seq_len) {
          const float l = l_s[r];
          const float safe_l = (l == 0.f) ? 1.f : l;
          out[base + (size_t)(q0 + r) * head_dim + d] = from_f32<T>(acc[r][c] / safe_l);
        }
      }
    }
  }
  if (tid < kBlockQ && q0 + tid < seq_len) {
    const float l = l_s[tid];
    const float safe_l = (l == 0.f) ? 1.f : l;
    lse[(size_t)bh * seq_len + q0 + tid] = m_s[tid] + logf(safe_l);
  }
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, void* lse,
                   int batch_heads, int seq_len, int head_dim, float scale,
                   float dropout_rate, uint32_t drop_threshold, uint32_t seed,
                   cudaStream_t stream) {
  const size_t smem = (size_t)(kBlockQ * head_dim + kBlockQ * kBlockK + 3 * kBlockQ) * sizeof(float);
  auto kernel = flash_fwd_kernel<T, NC>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((seq_len + kBlockQ - 1) / kBlockQ, batch_heads);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), seq_len, head_dim, scale,
      dropout_rate > 0.f ? 1 : 0, 1.f - dropout_rate, drop_threshold, seed);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int chunks, const void* q, const void* k, const void* v, void* out,
                     void* lse, int batch_heads, int seq_len, int head_dim, float scale,
                     float dropout_rate, uint32_t drop_threshold, uint32_t seed,
                     cudaStream_t stream) {
#define TCHVP_LAUNCH(NC)                                                              \
  case NC:                                                                          \
    return launch<T, NC>(q, k, v, out, lse, batch_heads, seq_len, head_dim, scale, \
                         dropout_rate, drop_threshold, seed, stream);
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

}  // namespace

extern "C" {

// q, k, v, out: (batch_heads, seq_len, head_dim) contiguous, fp32 (is_bf16 0)
// or bf16 (is_bf16 1); lse: (batch_heads, seq_len) fp32. Returns the
// cudaError_t of the launch (0 on success); never synchronises.
int tchvp_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                    int batch_heads, int seq_len, int head_dim, int is_bf16,
                    float scale, float dropout_rate, unsigned int drop_threshold,
                    unsigned int seed, void* stream) {
  if (batch_heads < 1 || batch_heads > 65535 || seq_len < 1 || head_dim < 1)
    return (int)cudaErrorInvalidValue;
  const int chunks = (head_dim + kThreads - 1) / kThreads;
  if (chunks > kMaxChunks) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)dispatch<__nv_bfloat16>(chunks, q, k, v, out, lse, batch_heads, seq_len,
                                        head_dim, scale, dropout_rate, drop_threshold,
                                        seed, s);
  return (int)dispatch<float>(chunks, q, k, v, out, lse, batch_heads, seq_len, head_dim,
                              scale, dropout_rate, drop_threshold, seed, s);
}

const char* tchvp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
