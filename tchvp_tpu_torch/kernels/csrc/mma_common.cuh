// Building blocks of the tensor-core attention kernels (flash_fwd.cu,
// flash_bwd.cu and window_fwd.cuh): cp.async copies into shared memory, ldmatrix, mma.sync
// m16n8k16 bf16 and m16n8k8 tf32 (3xTF32 for fp32 inputs), and the dropout of
// one weight held in an mma fragment.
#pragma once

#include "flash_common.cuh"

namespace tchvp {

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }
inline bool aligned8(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 7) == 0; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, the bytes past `bytes` (0 or 16) zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 8 bytes global -> shared, the bytes past `bytes` (0 or 8) zero-filled.
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

// Rows [row0, row0 + ROWS) and columns [col0, col0 + COLS) of a row-major
// matrix of `cols` columns whose rows lie `ld` elements apart into a tile of
// row stride STRIDE, by THREADS threads; rows >= row_end and columns >= cols
// read as 0. copy: 16 or 8, cp.async copies of that many bytes (cols and ld
// multiples of them, src aligned to them); 0, element loads.
template <typename T, int ROWS, int COLS, int STRIDE, int THREADS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0, int row_end, int col0,
                                          int cols, size_t ld, int copy) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kHalf = kVec / 2;
  constexpr int kPerRow = COLS / kVec;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += THREADS) {
    const int r = i / kPerRow;
    const int c = (i - r * kPerRow) * kVec;
    T* d = dst + r * STRIDE + c;
    const int gr = row0 + r, gc = col0 + c;
    if (copy == 16) {
      const bool ok = gr < row_end && gc < cols;  // cols % kVec == 0
      cp_async16(d, ok ? src + (size_t)gr * ld + gc : src, ok ? 16 : 0);
    } else if (copy == 8) {
#pragma unroll
      for (int e = 0; e < kVec; e += kHalf) {
        const bool ok = gr < row_end && gc + e < cols;  // cols % kHalf == 0
        cp_async8(d + e, ok ? src + (size_t)gr * ld + gc + e : src, ok ? 8 : 0);
      }
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        d[e] = (gr < row_end && gc + e < cols) ? src[(size_t)gr * ld + gc + e] : from_f32<T>(0.f);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a b on a 16x8x16 bf16 tile, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b on a 16x8x8 tf32 tile, fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = hi + lo with hi, lo tf32 (round to nearest): 22 of fp32's 24 bits.
__device__ __forceinline__ void split_tf32(float x, uint32_t* hi, uint32_t* lo) {
  uint32_t h, l;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(h) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(l) : "f"(x - __uint_as_float(h)));
  *hi = h;
  *lo = l;
}

// c += a b in 3xTF32, the small products first; a already split.
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* a_hi, const uint32_t* a_lo,
                                           float b0, float b1) {
  uint32_t b_hi[2], b_lo[2];
  split_tf32(b0, &b_hi[0], &b_lo[0]);
  split_tf32(b1, &b_hi[1], &b_lo[1]);
  mma_tf32(c, a_lo, b_hi);
  mma_tf32(c, a_hi, b_lo);
  mma_tf32(c, a_hi, b_hi);
}

// Four 8x8 b16 matrices of shared memory: lane i gives the address of row
// i % 8 of matrix i / 8; lane 4g + t receives elements 2t, 2t + 1 of row g.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The same, transposed: lane 4g + t receives rows 2t, 2t + 1 of column g.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The dropout of one attention weight p of an mma fragment at column col of
// the row hashed to row_h (flash_common.cuh's row_hash): keep ? p / keep_prob
// : 0, the mask of keep_element. The window forwards divide, as since PR 6;
// the flash forward multiplies by 1 / keep_prob in its own loop.
__device__ __forceinline__ float dropout_weight(float p, uint32_t row_h, int col,
                                               uint32_t drop_threshold, float keep_prob) {
  return keep_hashed(row_h, col, drop_threshold) ? p / keep_prob : 0.f;
}

}  // namespace tchvp
