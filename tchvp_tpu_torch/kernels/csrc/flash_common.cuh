// Helpers shared by the attention kernels (attention_fwd.cuh and
// attention_bwd.cuh, built as flash_fwd.cu, flash_bwd.cu and
// band_attention.cu).
//
// The attention-weight dropout mask lives here once, so the forwards and the
// backward kernels cannot drift: each keeps element (row, col) of the
// global (S, S) weight matrix of batch-head bh exactly when
//   squirrel3(squirrel3(row ^ base) + col * 0x27D4EB2F) >= threshold,
//   base = seed * 0x9E3779B1 + bh * 0x85EBCA77   (uint32, wrapping),
// the TPU kernels' _keep_mask (tchvp_tpu/kernels/flash_attention.py:82).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tchvp {

constexpr float kNegInf = -1e30f;  // the TPU kernels' NEG_INF
constexpr int kMaxChunks = 5;      // head-dim chunks of 256 columns: Dh <= 1280

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

// Per-(seed, batch-head) base of the hash; the seed is the (1,) int32 device
// tensor the wrapper passes, read only when dropout is on.
__device__ __forceinline__ uint32_t dropout_base(const int* seed, int bh) {
  return (uint32_t)seed[0] * 0x9E3779B1u + (uint32_t)bh * 0x85EBCA77u;
}

// True where the global weight (row, col) is kept.
__device__ __forceinline__ bool keep_element(uint32_t base, int row, int col,
                                             uint32_t threshold) {
  const uint32_t h = squirrel3((uint32_t)row ^ base);
  return squirrel3(h + (uint32_t)col * 0x27D4EB2Fu) >= threshold;
}

// Stages rows [row0, row0 + rows) of a (S, Dh) matrix as fp32, zero past S.
template <int Threads, typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int row0, int rows,
                                           int seq_len, int head_dim) {
  for (int i = threadIdx.x; i < rows * head_dim; i += Threads) {
    const int r = i / head_dim;
    const int d = i - r * head_dim;
    dst[i] = (row0 + r < seq_len) ? to_f32(src[(size_t)(row0 + r) * head_dim + d]) : 0.f;
  }
}

// The band of the windowed kernels (the TPU kernels' _band_mask): query row
// `row` sees key `col` when the key's window is the row's or the one before
// it. Without the band every pair is in. Indices are never negative.
template <bool Band>
__device__ __forceinline__ bool in_band(int row, int col, int window) {
  if (!Band) return true;
  const int gap = row / window - col / window;
  return gap == 0 || gap == 1;
}

// [*lo, *hi): the keys that query rows first..last (last < S) may see: with
// the band, the window before the first row's through the last row's own.
template <bool Band>
__device__ __forceinline__ void key_span(int first, int last, int seq_len, int window,
                                         int* lo, int* hi) {
  *lo = Band ? max(0, (first / window - 1) * window) : 0;
  *hi = Band ? min(seq_len, (last / window + 1) * window) : seq_len;
}

// [*lo, *hi): the query rows that may see keys first..last (last < S): with
// the band, the first key's window through the one after the last key's.
template <bool Band>
__device__ __forceinline__ void query_span(int first, int last, int seq_len, int window,
                                           int* lo, int* hi) {
  *lo = Band ? (first / window) * window : 0;
  *hi = Band ? min(seq_len, (last / window + 2) * window) : seq_len;
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace tchvp
