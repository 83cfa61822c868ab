// Tiles and building blocks shared by the flash forward (flash_fwd.cu) and
// the flash backward (flash_bwd.cu) on the tensor cores: the block
// candidates, the shared-memory strides and ring depth of a (KC, NT) tiling,
// one KC-column chunk of a warp's 16 x NK logits (qk_chunk), one NK-key tile
// of P.V into a column block (pv_tile), base-2 exp, and the widest copy a
// layout allows.
#pragma once

#include <initializer_list>

#include "mma_common.cuh"

namespace tchvp {


// The block candidates (BQ, BK) of the flash kernels, query rows per block
// and keys per tile, are TCHVP_FLASH_BLOCKS (build.py's FLASH_BLOCKS, given
// by the build; flash_common.cuh): a block is BQ / 16 warps of 16 rows
// sharing each K/V stage, so a warp's registers depend on BK only.
template <int ROWS>
__host__ __device__ constexpr int flash_threads() { return 2 * ROWS; }  // ROWS / 16 warps
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Row strides in shared memory: the Q, K chunks KC + 8 bf16 (16-byte rows
// of an ldmatrix block in 8 different bank groups) or KC + 4 fp32 (fragment
// loads (row g, word t) hit 32 banks); V 8 NT + 8 bf16, or 8 NT + 4 fp32 so
// that the fp32 reads (row 2t or 2t + 1, column g) hit 32 banks.
template <typename T, int KC>
__host__ __device__ constexpr int flash_stride_qk() { return sizeof(T) == 2 ? KC + 8 : KC + 4; }
template <typename T, int NT>
__host__ __device__ constexpr int flash_stride_v() { return sizeof(T) == 2 ? 8 * NT + 8 : 8 * NT + 4; }
// Slots of the (Q, K) ring: 4 (bf16) or 3 (fp32).
template <typename T>
__host__ __device__ constexpr int flash_stages() { return sizeof(T) == 2 ? 4 : 3; }
// Buffers of V: a step issued kStages - 1 steps ahead reaches the next key
// tile's V only after this tile's P.V when a tile has that many chunks, so
// one buffer does; else two.
template <typename T>
__host__ __device__ constexpr int flash_v_buffers(int n_chunks) {
  return n_chunks >= flash_stages<T>() - 1 ? 1 : 2;
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One KC-column chunk of a warp's S = Q K^T: its 16 rows (q_s) x 8 NJ keys
// (k_s), acc[j] the m16n8 tile of keys 8j..8j+7 (rows g, g + 8; keys 2t,
// 2t + 1).
template <int KC, int NJ>
__device__ __forceinline__ void qk_chunk(float (&acc)[NJ][4], const __nv_bfloat16* q_s,
                                         const __nv_bfloat16* k_s, int lane) {
  constexpr int S = flash_stride_qk<__nv_bfloat16, KC>();
  const __nv_bfloat16* qa = q_s + (lane & 15) * S + (lane >> 4) * 8;
  const __nv_bfloat16* kb = k_s + ((lane >> 4) * 8 + (lane & 7)) * S + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < KC; kk += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, qa + kk);
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      uint32_t b[4];  // keys 8j.. (b[0], b[1]) and 8j + 8.. (b[2], b[3])
      ldmatrix_x4(b, kb + 8 * j * S + kk);
      mma_bf16(acc[j], a, b);
      mma_bf16(acc[j + 1], a, b + 2);
    }
  }
}

template <int KC, int NJ>
__device__ __forceinline__ void qk_chunk(float (&acc)[NJ][4], const float* q_s, const float* k_s,
                                         int lane) {
  constexpr int S = flash_stride_qk<float, KC>();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KC; kk += 8) {
    uint32_t a_hi[4], a_lo[4];
    split_tf32(q_s[g * S + kk + t], &a_hi[0], &a_lo[0]);
    split_tf32(q_s[(g + 8) * S + kk + t], &a_hi[1], &a_lo[1]);
    split_tf32(q_s[g * S + kk + t + 4], &a_hi[2], &a_lo[2]);
    split_tf32(q_s[(g + 8) * S + kk + t + 4], &a_hi[3], &a_lo[3]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* kr = k_s + (8 * j + g) * S + kk + t;
      mma_3xtf32(acc[j], a_hi, a_lo, kr[0], kr[4]);
    }
  }
}

// acc += P V for one tile of 8 NJ keys: p[j] the weights of keys 8j.. (the
// layout of qk_chunk's acc), v_s the tile's V column block (8 NJ keys x 8 NT).
template <int NT, int NJ>
__device__ __forceinline__ void pv_tile(float (&acc)[NT][4], const float (&p)[NJ][4],
                                        const __nv_bfloat16* v_s, int lane) {
  constexpr int SV = flash_stride_v<__nv_bfloat16, NT>();
#pragma unroll
  for (int kk = 0; kk < NJ / 2; ++kk) {  // 16 keys: P's tiles 2kk, 2kk + 1
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]), pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
    const __nv_bfloat16* vr = v_s + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * SV + (lane >> 4) * 8;
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vr + jj * 16);
      mma_bf16(acc[2 * jj], a, b);
      mma_bf16(acc[2 * jj + 1], a, b + 2);
    }
  }
}

// fp32: 3xTF32, this tile's products in their own accumulator, then added.
template <int NT, int NJ>
__device__ __forceinline__ void pv_tile(float (&acc)[NT][4], const float (&p)[NJ][4],
                                        const float* v_s, int lane) {
  constexpr int SV = flash_stride_v<float, NT>();
  const int g = lane >> 2, t = lane & 3;
  float part[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
  for (int j8 = 0; j8 < NJ; ++j8) {  // keys 8 j8 + (2t, 2t + 1) as the step's columns t, t + 4
    uint32_t a_hi[4], a_lo[4];
    split_tf32(p[j8][0], &a_hi[0], &a_lo[0]);
    split_tf32(p[j8][2], &a_hi[1], &a_lo[1]);
    split_tf32(p[j8][1], &a_hi[2], &a_lo[2]);
    split_tf32(p[j8][3], &a_hi[3], &a_lo[3]);
    const float* vr = v_s + (8 * j8 + 2 * t) * SV + g;
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_3xtf32(part[j], a_hi, a_lo, vr[8 * j], vr[SV + 8 * j]);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
}

// The widest copy, 16 or 8 bytes, that the rows of Dh elements, the `n`
// strides and the pointers all allow; 0 for element copies (Dh 4 fp32, Dh
// 98 bf16).
template <typename T>
int copy_bytes(int head_dim, const long long* strides, int n, std::initializer_list<const void*> ptrs) {
  for (int bytes : {16, 8}) {
    bool ok = (head_dim * (long long)sizeof(T)) % bytes == 0;
    for (int i = 0; i < n; ++i) ok = ok && (strides[i] * (long long)sizeof(T)) % bytes == 0;
    for (const void* ptr : ptrs) ok = ok && (bytes == 16 ? aligned16(ptr) : aligned8(ptr));
    if (ok) return bytes;
  }
  return 0;
}

}  // namespace tchvp
