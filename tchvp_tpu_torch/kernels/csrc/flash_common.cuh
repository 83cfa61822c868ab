// Helpers shared by the attention kernels (flash_fwd.cu, flash_bwd.cu,
// window_fwd.cuh and window_bwd.cuh, built as flash_fwd.cu, flash_bwd.cu,
// band_attention.cu and halo_attention.cu) and fused_tail.cu.
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

// The row's half of the hash, squirrel3(row ^ base): a kernel that drops
// many weights of one row takes it once.
__device__ __forceinline__ uint32_t row_hash(uint32_t base, int row) {
  return squirrel3((uint32_t)row ^ base);
}

// True where the weight at column col of the row hashed to row_h is kept.
__device__ __forceinline__ bool keep_hashed(uint32_t row_h, int col, uint32_t threshold) {
  return squirrel3(row_h + (uint32_t)col * 0x27D4EB2Fu) >= threshold;
}

// True where the global weight (row, col) is kept.
__device__ __forceinline__ bool keep_element(uint32_t base, int row, int col,
                                             uint32_t threshold) {
  return keep_hashed(row_hash(base, row), col, threshold);
}

// The masks of the window kernels' two modes (the flash kernels see every
// pair of the (S, S) matrix and take none):
//  * kBand (band_attention.cu; the TPU kernels' _band_mask): query row `row`
//    sees key `col` when the key's window is the row's or the one before it;
//  * kHalo (halo_attention.cu; the TPU kernels' _halo_band_mask): one shard
//    of sequence-parallel windowed attention. k and v carry one extra leading
//    window, the left neighbour's halo, so they have S + w rows (k_ext) and
//    local row `row` sees k_ext column `col` when col's window is the row's
//    or the one after it. Where `no_prev` (the true sequence start) the halo
//    window, k_ext columns [0, w), is masked.
enum Mode { kBand, kHalo };

template <Mode M>
__device__ __forceinline__ bool in_band(int row, int col, int window, bool no_prev) {
  if (M == kBand) {
    const int gap = row / window - col / window;
    return gap == 0 || gap == 1;
  }
  const int gap = col / window - row / window;
  return (gap == 0 || gap == 1) && !(no_prev && col < window);
}

// Rows of k and v: S, or S + w with the halo.
template <Mode M>
__host__ __device__ __forceinline__ int kv_rows(int seq_len, int window) {
  return M == kHalo ? seq_len + window : seq_len;
}

// The column the dropout hash takes. In halo mode k_ext column c is the
// shard-local column c - w, negative for the halo window: -w..-1 wrap to
// 2^32 - w..2^32 - 1 in keep_element's uint32 cast, as the TPU kernel's
// int32 -> uint32 cast does. The other modes hash the column itself.
template <Mode M>
__device__ __forceinline__ int hash_col(int col, int window) {
  return M == kHalo ? col - window : col;
}

__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// [*lo, *hi): the keys that query rows first..last (last < S) may see.
// Band: the window before the first row's through the last row's own.
// Halo (k_ext coordinates): the first row's window through the window after
// the last row's, without the halo window where no_prev.
template <Mode M>
__host__ __device__ __forceinline__ void key_span(int first, int last, int seq_len,
                                                  int window, bool no_prev, int* lo, int* hi) {
  if (M == kBand) {
    *lo = imax(0, (first / window - 1) * window);
    *hi = imin(seq_len, (last / window + 1) * window);
  } else {
    *lo = imax(no_prev ? window : 0, (first / window) * window);
    *hi = imin(seq_len + window, (last / window + 2) * window);
  }
}

// [*lo, *hi): the query rows that may see keys first..last (last < the rows
// of k). Band: the first key's window through the one after the last key's.
// Halo: the window before the first k_ext key's through the last key's own;
// none for a tile of the masked halo window.
template <Mode M>
__device__ __forceinline__ void query_span(int first, int last, int seq_len, int window,
                                           bool no_prev, int* lo, int* hi) {
  if (M == kBand) {
    *lo = (first / window) * window;
    *hi = min(seq_len, (last / window + 2) * window);
  } else {
    *lo = max(0, (first / window - 1) * window);
    *hi = (no_prev && last < window) ? *lo : min(seq_len, (last / window + 1) * window);
  }
}

// Opt a kernel into more than 48 KB of dynamic shared memory. A block past
// the card's opt-in limit (227 KB on the H100) returns
// cudaErrorLaunchOutOfResources, which the wrappers report as a block the
// card cannot run at that shape.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  static int optin = 0;
  if (optin == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
      optin = 227 * 1024;
  }
  if (bytes > (size_t)optin) return cudaErrorLaunchOutOfResources;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Explicit instantiations split over translation units: build.py compiles
// a library's source once per block candidate, each unit with a header
// (build.py's unit_header) that defines TCHVP_UNIT, the candidate lists
// TCHVP_FLASH_BLOCKS(X) and TCHVP_WIN_BLOCKS(X), the unit's candidate
// TCHVP_UNIT_BLOCKS(X), and in unit 0, which also holds the C launchers,
// the other candidates TCHVP_EXTERN_BLOCKS(X), declared extern there.

}  // namespace tchvp
