// Tensor-core backward of banded (kBand, band_attention.cu) and halo (kHalo,
// halo_attention.cu) attention: three launches over a (2, BH, S, cols)
// scratch of the inputs' dtype that the wrapper allocates, so that P and dS
// are formed once per (query tile, key tile) pair and never once per
// head-dim column block.
//
//   P = exp(q k^T * scale - lse),  dP = dO V^T,  keep: the forward's mask,
//   P_drop = P * keep / (1 - rate),  dS = P * (dP * keep / (1 - rate) - delta) * scale,
//   dQ = dS K,  dK = dS^T Q,  dV = P_drop^T dO,
// from the forward's fp32 lse and delta = rowsum(dO * out) (fp32, made by the
// wrapper). Pairs outside the band give P = dS = 0.
//
// Key tiles. A query tile's key span (flash_common.cuh's key_span) is cut
// into 64-key tiles on one grid: tiles start at tile_base + 64 j, where
// tile_base is 0 for the band and (w mod 64) - 64 (or 0) for the halo, so
// that halo tiles start at k_ext column w + 64 j, the band's local key 64 j.
// With has_prev 0 the halo then walks the same tiles in the same order as
// the band on the local sequence, and its bits equal the band's. Scratch
// row r of query tile q0 / 64 holds P_drop and dS of the span's tiles side
// by side: column c is key base + c, base the first tile's start
// (window_tile_span). The number of tiles of the widest span, the key tiles
// of k (or k_ext) and tile_base come from flash_attention.py's
// window_bwd_plan, the one rule; the launchers take them as they are.
//  * Pass A, P and dS (window_ds_kernel): grid (64-row query tile, key tile
//    of its span, bh), 8 warps of 16 rows x 32 keys. S = Q K^T and dP = dO
//    V^T on mma.sync over the whole head dim, streamed in 64-column chunks
//    (Q, dO, K, V each) through a cp.async ring of 3 (bf16) or 2 (fp32)
//    stages; then per element the band mask, P by ex2, the dropout hash once,
//    and P_drop and dS into the scratch (bf16 for bf16 inputs, which the
//    products of pass B read as their A operand, as the flash pair rounds
//    them; fp32 for fp32). A tile past its query tile's span writes zeros,
//    so every scratch element is defined.
//  * Pass B, dq (window_dq_kernel): grid (64-row query tile, column block of
//    wb_block_d<T>() head-dim columns, bh), 4 warps of 16 rows. Walks the
//    span's key tiles: dQ_blk += dS[rows, tile] K[tile, blk], dS by
//    ldmatrix (bf16) from a tile copied out of the L2-resident scratch, K's
//    column block by ldmatrix.trans.
//  * Pass B, dk/dv (window_dkv_kernel): grid (64-key tile, column block, bh),
//    4 warps of 16 keys. Walks the 64-row query tiles of the key tile's
//    query span (query_span): dK_blk += dS^T Q[:, blk], dV_blk += P_drop^T
//    dO[:, blk], the transposed A operands by ldmatrix.trans from the
//    scratch tiles. In kHalo the grid covers the S + w rows of k_ext; a key
//    tile of the masked halo window has no query rows and writes zeros.
// Products: bf16 mma.sync m16n8k16 -> fp32; fp32 3xTF32 on m16n8k8, each
// head-dim chunk (pass A) and each tile (pass B) in its own accumulator,
// added in fp32 (the tensor cores do not round to nearest). No atomics:
// every gradient element is summed by one thread in one order, so the bits
// are equal on repeat. Loads take 16- or 8-byte cp.async, or element loads,
// as the head dim's rows and the pointers allow (copy_bytes); rows outside
// a range are zero-filled, never read.
#pragma once

#include "flash_tiles.cuh"
#include "window_fwd.cuh"

namespace tchvp {

constexpr int kWbTile = 64;       // query rows and keys per tile
constexpr int kWbThreadsA = 256;  // pass A: 8 warps, 4 row groups x 2 key halves
constexpr int kWbThreadsB = 128;  // pass B: 4 warps of 16 rows (dq) or keys (dk/dv)

// Head-dim columns per pass-B block: 128 (bf16) or 64 (fp32, whose 3xTF32
// products keep a per-tile accumulator beside the total).
template <typename T>
__host__ __device__ constexpr int wb_block_d() { return sizeof(T) == 2 ? 128 : 64; }
// Stages of pass A's ring: 3 x 36 KB (bf16) or 2 x 68 KB (fp32).
template <typename T>
__host__ __device__ constexpr int wb_stages() { return sizeof(T) == 2 ? 3 : 2; }
// Row strides in shared memory, in elements. Q, K, dO, V column blocks of
// pass B: D + 8, so ldmatrix rows (bf16) and the fp32 reads (row t, column
// g) fall in different banks. The scratch tiles: 72 (bf16, ldmatrix) or,
// in fp32, 68 for dq's reads (row g, column t) and 72 for dk/dv's
// transposed ones (row t, column g).
template <typename T>
__host__ __device__ constexpr int wb_stride_d() { return wb_block_d<T>() + 8; }
template <typename T, bool kTrans>
__host__ __device__ constexpr int wb_stride_p() { return sizeof(T) == 2 || kTrans ? 72 : 68; }

// The first key tile of a span starting at key lo >= 0: the largest
// tile_base + 64 j <= lo.
__host__ __device__ __forceinline__ int tile_floor(int lo, int tile_base) {
  return tile_base + ((lo - tile_base) / kWbTile) * kWbTile;
}

// The key span [*k_lo, *k_hi) of the 64-row query tile at q0, its first
// tile's start *base and its number of key tiles.
template <Mode M>
__host__ __device__ __forceinline__ void window_tile_span(int q0, int seq_len, int window, bool no_prev,
                                                          int tile_base, int* k_lo, int* k_hi, int* base,
                                                          int* n_tiles) {
  key_span<M>(q0, imin(seq_len, q0 + kWbTile) - 1, seq_len, window, no_prev, k_lo, k_hi);
  *base = tile_floor(*k_lo, tile_base);
  *n_tiles = (*k_hi - *base + kWbTile - 1) / kWbTile;
}

// load_tile with rows outside [row_lo, row_hi) zero-filled (row0 may be
// negative: the halo's first key tile).
template <typename T, int ROWS, int COLS, int STRIDE, int THREADS>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int row0, int row_lo, int row_hi, int col0,
                                          int cols, size_t ld, int copy) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kHalf = kVec / 2;
  constexpr int kPerRow = COLS / kVec;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += THREADS) {
    const int r = i / kPerRow;
    const int c = (i - r * kPerRow) * kVec;
    T* d = dst + r * STRIDE + c;
    const int gr = row0 + r, gc = col0 + c;
    const bool row_ok = gr >= row_lo && gr < row_hi;
    if (copy == 16) {
      const bool ok = row_ok && gc < cols;  // cols % kVec == 0
      cp_async16(d, ok ? src + (size_t)gr * ld + gc : src, ok ? 16 : 0);
    } else if (copy == 8) {
#pragma unroll
      for (int e = 0; e < kVec; e += kHalf) {
        const bool ok = row_ok && gc + e < cols;  // cols % kHalf == 0
        cp_async8(d + e, ok ? src + (size_t)gr * ld + gc + e : src, ok ? 8 : 0);
      }
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        d[e] = (row_ok && gc + e < cols) ? src[(size_t)gr * ld + gc + e] : from_f32<T>(0.f);
    }
  }
}

// A 64 x COLS tile of shared memory (row stride STRIDE) into rows [r_lo,
// r_hi) of rows r0.. and columns d0.. (< head_dim) of a row-major matrix of
// head_dim columns, in 16- or 8-byte pieces or elements.
template <typename T, int COLS, int STRIDE>
__device__ __forceinline__ void store_rows(T* out, const T* o_s, int r0, int r_lo, int r_hi, int d0,
                                           int head_dim, int copy) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = COLS / kVec;
  for (int i = threadIdx.x; i < kWbTile * kPerRow; i += kWbThreadsB) {
    const int r = i / kPerRow;
    const int c = (i - r * kPerRow) * kVec;
    if (r0 + r < r_lo || r0 + r >= r_hi || d0 + c >= head_dim) continue;
    T* dst = out + (size_t)(r0 + r) * head_dim + d0 + c;
    const T* src = o_s + r * STRIDE + c;
    if (copy == 16) {
      *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
    } else if (copy == 8) {
      *reinterpret_cast<int2*>(dst) = *reinterpret_cast<const int2*>(src);
      if (d0 + c + kVec / 2 < head_dim)
        *reinterpret_cast<int2*>(dst + kVec / 2) = *reinterpret_cast<const int2*>(src + kVec / 2);
    } else {
      for (int e = 0; e < kVec && d0 + c + e < head_dim; ++e) dst[e] = src[e];
    }
  }
}

// A warp's 16 x 8 NT accumulator as rows 16 warp + (g, g + 8) of a tile of
// shared memory (row stride STRIDE).
template <typename T, int NT, int STRIDE>
__device__ __forceinline__ void stage_acc(T* o_s, const float (&acc)[NT][4], int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    T* orow = o_s + (warp * 16 + g + 8 * r) * STRIDE + 2 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      orow[8 * j] = from_f32<T>(acc[j][2 * r]);
      orow[8 * j + 1] = from_f32<T>(acc[j][2 * r + 1]);
    }
  }
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store_pair(float* dst, float x, float y) {
  *reinterpret_cast<float2*>(dst) = make_float2(x, y);
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

template <int NT>
__device__ __forceinline__ void add_acc(float (&acc)[NT][4], const float (&part)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
}

struct WindowBwdParams {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *scratch, *g0, *g1;  // g0: dq or dk; g1: dv
  int batch_heads, seq_len, head_dim, window, span_tiles, key_tiles, tile_base;
  float scale, dropout_rate;
  uint32_t drop_threshold;
  const int* seed;
  const int* has_prev;  // kHalo only
  int copy_in, copy_out;
  cudaStream_t stream;
};

// Pass A: P_drop and dS of one (64-row query tile, key tile of its span,
// bh) into scratch[0] (dS) and scratch[1] (P_drop) at column key - base.
template <typename T, Mode M>
__global__ void __launch_bounds__(kWbThreadsA) window_ds_kernel(const WindowBwdParams p) {
  constexpr int S = win_stride_qk<T>();
  constexpr int kStages = wb_stages<T>();
  constexpr int kTile = kWbTile * S;
  constexpr int kStage = 4 * kTile;  // Q, dO, K, V chunks
  extern __shared__ __align__(16) unsigned char wb_smem[];
  T* ring = reinterpret_cast<T*>(wb_smem);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rows = (warp & 3) * 16, keys = (warp >> 2) * 32;  // this warp's part of the tile
  const int seq_len = p.seq_len, head_dim = p.head_dim, window = p.window;
  const int q0 = blockIdx.x * kWbTile;
  const int bh = blockIdx.z;
  const bool no_prev = M == kHalo && p.has_prev[0] == 0;
  int k_lo, k_hi, base, n_tiles;
  window_tile_span<M>(q0, seq_len, window, no_prev, p.tile_base, &k_lo, &k_hi, &base, &n_tiles);
  const int cols = p.span_tiles * kWbTile;
  T* ds_out = static_cast<T*>(p.scratch) + (size_t)bh * seq_len * cols;
  T* pd_out = ds_out + (size_t)p.batch_heads * seq_len * cols;
  const int row_end = imin(seq_len, q0 + kWbTile);

  if (blockIdx.y >= n_tiles) {  // past this query tile's span: zeros
    constexpr int kPerRow = kWbTile * (int)sizeof(T) / 16;
    for (int i = threadIdx.x; i < 2 * kWbTile * kPerRow; i += kWbThreadsA) {
      const int which = i / (kWbTile * kPerRow);
      const int r = (i / kPerRow) % kWbTile;
      const int c = (i % kPerRow) * (16 / (int)sizeof(T));
      if (q0 + r < row_end)
        *reinterpret_cast<int4*>((which ? pd_out : ds_out) + (size_t)(q0 + r) * cols +
                                 blockIdx.y * kWbTile + c) = make_int4(0, 0, 0, 0);
    }
    return;
  }
  const int kt0 = base + blockIdx.y * kWbTile;
  const int kv_len = kv_rows<M>(seq_len, window);
  const T* qb = static_cast<const T*>(p.q) + (size_t)bh * seq_len * head_dim;
  const T* ob = static_cast<const T*>(p.dout) + (size_t)bh * seq_len * head_dim;
  const T* kb = static_cast<const T*>(p.k) + (size_t)bh * kv_len * head_dim;
  const T* vb = static_cast<const T*>(p.v) + (size_t)bh * kv_len * head_dim;
  const int n_chunks = (head_dim + kWinChunkD - 1) / kWinChunkD;
  const int copy = p.copy_in;

  float s_acc[4][4], dp_acc[4][4];
  zero_acc(s_acc);
  zero_acc(dp_acc);

  // Every iteration commits one group (empty past the last chunk), so
  // waiting for all but kStages - 2 groups leaves chunk c staged. Keys
  // outside [k_lo, k_hi) are zero-filled: they are never in the band.
  auto load = [&](int chunk) {
    if (chunk < n_chunks) {
      T* st = ring + (chunk % kStages) * kStage;
      const int c0 = chunk * kWinChunkD;
      load_rows<T, kWbTile, kWinChunkD, S, kWbThreadsA>(st, qb, q0, 0, seq_len, c0, head_dim, head_dim, copy);
      load_rows<T, kWbTile, kWinChunkD, S, kWbThreadsA>(st + kTile, ob, q0, 0, seq_len, c0, head_dim, head_dim,
                                                        copy);
      load_rows<T, kWbTile, kWinChunkD, S, kWbThreadsA>(st + 2 * kTile, kb, kt0, k_lo, k_hi, c0, head_dim,
                                                        head_dim, copy);
      load_rows<T, kWbTile, kWinChunkD, S, kWbThreadsA>(st + 3 * kTile, vb, kt0, k_lo, k_hi, c0, head_dim,
                                                        head_dim, copy);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) load(c);
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c staged for all; chunk c - 1's stage free
    load(c + kStages - 1);
    const T* st = ring + (c % kStages) * kStage;
    if constexpr (sizeof(T) == 2) {
      logits_chunk(s_acc, st + rows * S, st + 2 * kTile + keys * S, lane);
      logits_chunk(dp_acc, st + kTile + rows * S, st + 3 * kTile + keys * S, lane);
    } else {
      float part[4][4];
      zero_acc(part);
      logits_chunk(part, st + rows * S, st + 2 * kTile + keys * S, lane);
      add_acc(s_acc, part);
      zero_acc(part);
      logits_chunk(part, st + kTile + rows * S, st + 3 * kTile + keys * S, lane);
      add_acc(dp_acc, part);
    }
  }
  cp_async_wait<0>();

  // P_drop and dS of the warp's 16 x 32 elements, straight from the
  // fragments (rows g, g + 8; keys 8j + 2t, + 1) as pairs.
  const bool dropout = p.dropout_rate > 0.f;
  const float inv_keep = 1.f / (1.f - p.dropout_rate);
  const float scale = p.scale, scale_log2 = p.scale * kLog2e;
  const uint32_t hash_base = dropout ? dropout_base(p.seed, bh) : 0u;
  const float* lse = static_cast<const float*>(p.lse) + (size_t)bh * seq_len;
  const float* delta = static_cast<const float*>(p.delta) + (size_t)bh * seq_len;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + rows + g + 8 * half;
    if (row >= seq_len) continue;
    const float lse2 = lse[row] * kLog2e, dl = delta[row];
    const uint32_t row_h = row_hash(hash_base, row);
    const size_t at = (size_t)row * cols + blockIdx.y * kWbTile + keys + 2 * t;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float ds[2], pd[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = kt0 + keys + 8 * j + 2 * t + e;
        float w = 0.f, dp = dp_acc[j][2 * half + e];
        if (key >= k_lo && key < k_hi && in_band<M>(row, key, window, no_prev)) {
          w = fast_exp2(s_acc[j][2 * half + e] * scale_log2 - lse2);
          if (dropout) {
            const bool keep = keep_hashed(row_h, hash_col<M>(key, window), p.drop_threshold);
            dp = keep ? dp * inv_keep : 0.f;
            pd[e] = keep ? w * inv_keep : 0.f;
          } else {
            pd[e] = w;
          }
        } else {
          pd[e] = 0.f;
        }
        ds[e] = w * (dp - dl) * scale;
      }
      store_pair(ds_out + at + 8 * j, ds[0], ds[1]);
      store_pair(pd_out + at + 8 * j, pd[0], pd[1]);
    }
  }
}

// acc += dS K over one 64-key tile: ds_s the warp's 16 rows of the dS tile
// (row stride SP), k_s the tile's K column block (64 keys x D).
template <int D, int SP, int SV>
__device__ __forceinline__ void dq_tile(float (&acc)[D / 8][4], const __nv_bfloat16* ds_s,
                                        const __nv_bfloat16* k_s, int lane) {
  const __nv_bfloat16* da = ds_s + (lane & 15) * SP + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < kWbTile / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, da + 16 * kk);
    const __nv_bfloat16* kr = k_s + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * SV + (lane >> 4) * 8;
#pragma unroll
    for (int jj = 0; jj < D / 16; ++jj) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, kr + jj * 16);
      mma_bf16(acc[2 * jj], a, b);
      mma_bf16(acc[2 * jj + 1], a, b + 2);
    }
  }
}

template <int D, int SP, int SV>
__device__ __forceinline__ void dq_tile(float (&acc)[D / 8][4], const float* ds_s, const float* k_s, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float part[D / 8][4];
  zero_acc(part);
#pragma unroll
  for (int ks = 0; ks < kWbTile; ks += 8) {
    uint32_t a_hi[4], a_lo[4];
    split_tf32(ds_s[g * SP + ks + t], &a_hi[0], &a_lo[0]);
    split_tf32(ds_s[(g + 8) * SP + ks + t], &a_hi[1], &a_lo[1]);
    split_tf32(ds_s[g * SP + ks + t + 4], &a_hi[2], &a_lo[2]);
    split_tf32(ds_s[(g + 8) * SP + ks + t + 4], &a_hi[3], &a_lo[3]);
    const float* kr = k_s + (ks + t) * SV + g;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) mma_3xtf32(part[j], a_hi, a_lo, kr[8 * j], kr[4 * SV + 8 * j]);
  }
  add_acc(acc, part);
}

// Pass B, dq of one (64-row query tile, column block, bh): the span's key
// tiles in order, each K block and dS tile through a two-stage ring.
template <typename T, Mode M>
__global__ void __launch_bounds__(kWbThreadsB) window_dq_kernel(const WindowBwdParams p) {
  constexpr int D = wb_block_d<T>();
  constexpr int SV = wb_stride_d<T>();
  constexpr int SP = wb_stride_p<T, false>();
  constexpr int kStage = kWbTile * SV + kWbTile * SP;  // K block, then the dS tile
  extern __shared__ __align__(16) unsigned char wb_smem[];
  T* ring = reinterpret_cast<T*>(wb_smem);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int seq_len = p.seq_len, head_dim = p.head_dim, window = p.window;
  const int q0 = blockIdx.x * kWbTile, d0 = blockIdx.y * D, bh = blockIdx.z;
  const bool no_prev = M == kHalo && p.has_prev[0] == 0;
  int k_lo, k_hi, base, n_tiles;
  window_tile_span<M>(q0, seq_len, window, no_prev, p.tile_base, &k_lo, &k_hi, &base, &n_tiles);
  const int cols = p.span_tiles * kWbTile;
  const int kv_len = kv_rows<M>(seq_len, window);
  const T* ds_in = static_cast<const T*>(p.scratch) + (size_t)bh * seq_len * cols;
  const T* kb = static_cast<const T*>(p.k) + (size_t)bh * kv_len * head_dim;

  auto load = [&](int tile) {
    T* st = ring + (tile & 1) * kStage;
    load_rows<T, kWbTile, D, SV, kWbThreadsB>(st, kb, base + tile * kWbTile, k_lo, k_hi, d0, head_dim, head_dim,
                                              p.copy_in);
    load_rows<T, kWbTile, kWbTile, SP, kWbThreadsB>(st + kWbTile * SV, ds_in, q0, 0, seq_len, tile * kWbTile,
                                                    cols, cols, 16);
    cp_async_commit();
  };
  float acc[D / 8][4];
  zero_acc(acc);
  load(0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) {
      load(tile + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* st = ring + (tile & 1) * kStage;
    dq_tile<D, SP, SV>(acc, st + kWbTile * SV + warp * 16 * SP, st, lane);
    __syncthreads();
  }
  stage_acc<T, D / 8, SV>(ring, acc, warp, lane);
  __syncthreads();
  store_rows<T, D, SV>(static_cast<T*>(p.g0) + (size_t)bh * seq_len * head_dim, ring, q0, 0, seq_len, d0,
                       head_dim, p.copy_out);
}

// dk += dS^T Q and dv += P_drop^T dO over one 64-row query tile: ds_s and
// pd_s the tile's scratch tiles (64 rows x 64 keys, row stride SP), the
// warp's keys from column key0; q_s, do_s the column blocks (64 rows x D).
template <int D, int SP, int SV>
__device__ __forceinline__ void dkv_tile(float (&dk)[D / 8][4], float (&dv)[D / 8][4], const __nv_bfloat16* ds_s,
                                         const __nv_bfloat16* pd_s, const __nv_bfloat16* q_s,
                                         const __nv_bfloat16* do_s, int key0, int lane) {
  // A = dS^T: matrix i of ldmatrix.trans is rows 8 (i >> 1).. and keys 8 (i & 1)..
  const int a_off = ((lane & 7) + (lane >> 4) * 8) * SP + key0 + ((lane >> 3) & 1) * 8;
  const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * SV + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < kWbTile / 16; ++kk) {
    uint32_t a_ds[4], a_pd[4];
    ldmatrix_x4_trans(a_ds, ds_s + 16 * kk * SP + a_off);
    ldmatrix_x4_trans(a_pd, pd_s + 16 * kk * SP + a_off);
#pragma unroll
    for (int jj = 0; jj < D / 16; ++jj) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, q_s + 16 * kk * SV + b_off + jj * 16);
      mma_bf16(dk[2 * jj], a_ds, b);
      mma_bf16(dk[2 * jj + 1], a_ds, b + 2);
      ldmatrix_x4_trans(b, do_s + 16 * kk * SV + b_off + jj * 16);
      mma_bf16(dv[2 * jj], a_pd, b);
      mma_bf16(dv[2 * jj + 1], a_pd, b + 2);
    }
  }
}

template <int D, int SP, int SV>
__device__ __forceinline__ void dkv_tile(float (&dk)[D / 8][4], float (&dv)[D / 8][4], const float* ds_s,
                                         const float* pd_s, const float* q_s, const float* do_s, int key0,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    const float* a_s = which ? pd_s : ds_s;
    const float* b_s = which ? do_s : q_s;
    float part[D / 8][4];
    zero_acc(part);
#pragma unroll
    for (int ks = 0; ks < kWbTile; ks += 8) {  // A[key][row] = tile[row][key]
      uint32_t a_hi[4], a_lo[4];
      const float* ar = a_s + (ks + t) * SP + key0 + g;
      split_tf32(ar[0], &a_hi[0], &a_lo[0]);
      split_tf32(ar[8], &a_hi[1], &a_lo[1]);
      split_tf32(ar[4 * SP], &a_hi[2], &a_lo[2]);
      split_tf32(ar[4 * SP + 8], &a_hi[3], &a_lo[3]);
      const float* br = b_s + (ks + t) * SV + g;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) mma_3xtf32(part[j], a_hi, a_lo, br[8 * j], br[4 * SV + 8 * j]);
    }
    add_acc(which ? dv : dk, part);
  }
}

// Pass B, dk and dv of one (64-key tile, column block, bh): the query tiles
// of the key tile's query span in order, each one's dS and P_drop tiles
// and Q and dO blocks through a two-stage ring.
template <typename T, Mode M>
__global__ void __launch_bounds__(kWbThreadsB) window_dkv_kernel(const WindowBwdParams p) {
  constexpr int D = wb_block_d<T>();
  constexpr int SV = wb_stride_d<T>();
  constexpr int SP = wb_stride_p<T, true>();
  constexpr int kStage = 2 * kWbTile * SP + 2 * kWbTile * SV;  // dS, P_drop tiles; Q, dO blocks
  extern __shared__ __align__(16) unsigned char wb_smem[];
  T* ring = reinterpret_cast<T*>(wb_smem);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int seq_len = p.seq_len, head_dim = p.head_dim, window = p.window;
  const int kt0 = p.tile_base + blockIdx.x * kWbTile, d0 = blockIdx.y * D, bh = blockIdx.z;
  const bool no_prev = M == kHalo && p.has_prev[0] == 0;
  const int kv_len = kv_rows<M>(seq_len, window);
  const int cols = p.span_tiles * kWbTile;
  int r_lo, r_hi;
  query_span<M>(imax(kt0, 0), imin(kt0 + kWbTile, kv_len) - 1, seq_len, window, no_prev, &r_lo, &r_hi);
  const int qt_lo = r_lo / kWbTile;
  const int n_q = r_hi > r_lo ? (r_hi + kWbTile - 1) / kWbTile - qt_lo : 0;
  const T* ds_in = static_cast<const T*>(p.scratch) + (size_t)bh * seq_len * cols;
  const T* pd_in = ds_in + (size_t)p.batch_heads * seq_len * cols;
  const T* qb = static_cast<const T*>(p.q) + (size_t)bh * seq_len * head_dim;
  const T* ob = static_cast<const T*>(p.dout) + (size_t)bh * seq_len * head_dim;

  // The scratch column of this key tile in query tile qt's span, or -1
  // where the span does not hold it.
  auto column = [&](int qt) {
    int k_lo, k_hi, base, n_tiles;
    window_tile_span<M>(qt * kWbTile, seq_len, window, no_prev, p.tile_base, &k_lo, &k_hi, &base, &n_tiles);
    const int c = kt0 - base;
    return c >= 0 && c < n_tiles * kWbTile ? c : -1;
  };
  auto load = [&](int i) {
    const int qt = qt_lo + i, c = column(qt);
    if (c >= 0) {
      T* st = ring + (i & 1) * kStage;
      const int q0 = qt * kWbTile;
      load_rows<T, kWbTile, kWbTile, SP, kWbThreadsB>(st, ds_in, q0, 0, seq_len, c, cols, cols, 16);
      load_rows<T, kWbTile, kWbTile, SP, kWbThreadsB>(st + kWbTile * SP, pd_in, q0, 0, seq_len, c, cols, cols,
                                                      16);
      load_rows<T, kWbTile, D, SV, kWbThreadsB>(st + 2 * kWbTile * SP, qb, q0, 0, seq_len, d0, head_dim,
                                                head_dim, p.copy_in);
      load_rows<T, kWbTile, D, SV, kWbThreadsB>(st + 2 * kWbTile * SP + kWbTile * SV, ob, q0, 0, seq_len, d0,
                                                head_dim, head_dim, p.copy_in);
    }
    cp_async_commit();
  };
  float dk[D / 8][4], dv[D / 8][4];
  zero_acc(dk);
  zero_acc(dv);
  if (n_q > 0) load(0);
  for (int i = 0; i < n_q; ++i) {
    if (i + 1 < n_q) {
      load(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (column(qt_lo + i) >= 0) {
      const T* st = ring + (i & 1) * kStage;
      dkv_tile<D, SP, SV>(dk, dv, st, st + kWbTile * SP, st + 2 * kWbTile * SP,
                          st + 2 * kWbTile * SP + kWbTile * SV, warp * 16, lane);
    }
    __syncthreads();
  }
  const int r_first = imax(kt0, 0), r_end = imin(kt0 + kWbTile, kv_len);
  stage_acc<T, D / 8, SV>(ring, dk, warp, lane);
  __syncthreads();
  store_rows<T, D, SV>(static_cast<T*>(p.g0) + (size_t)bh * kv_len * head_dim, ring, kt0, r_first, r_end, d0,
                       head_dim, p.copy_out);
  __syncthreads();
  stage_acc<T, D / 8, SV>(ring, dv, warp, lane);
  __syncthreads();
  store_rows<T, D, SV>(static_cast<T*>(p.g1) + (size_t)bh * kv_len * head_dim, ring, kt0, r_first, r_end, d0,
                       head_dim, p.copy_out);
}

// pass 0: P_drop and dS into the scratch; 1: dq; 2: dk and dv.
template <typename T, Mode M>
cudaError_t launch_window_bwd(int pass, WindowBwdParams a) {
  const int q_tiles = (a.seq_len + kWbTile - 1) / kWbTile;
  const int d_blocks = (a.head_dim + wb_block_d<T>() - 1) / wb_block_d<T>();
  void (*kernel)(const WindowBwdParams);
  size_t smem;
  dim3 grid;
  int threads = kWbThreadsB;
  if (pass == 0) {
    kernel = window_ds_kernel<T, M>;
    smem = (size_t)wb_stages<T>() * 4 * kWbTile * win_stride_qk<T>() * sizeof(T);
    grid = dim3(q_tiles, a.span_tiles, a.batch_heads);
    threads = kWbThreadsA;
    a.copy_in = copy_bytes<T>(a.head_dim, nullptr, 0, {a.q, a.k, a.v, a.dout});
  } else if (pass == 1) {
    kernel = window_dq_kernel<T, M>;
    smem = (size_t)2 * kWbTile * (wb_stride_d<T>() + wb_stride_p<T, false>()) * sizeof(T);
    grid = dim3(q_tiles, d_blocks, a.batch_heads);
    a.copy_in = copy_bytes<T>(a.head_dim, nullptr, 0, {a.k});
    a.copy_out = copy_bytes<T>(a.head_dim, nullptr, 0, {a.g0});
  } else {
    kernel = window_dkv_kernel<T, M>;
    smem = (size_t)2 * 2 * kWbTile * (wb_stride_d<T>() + wb_stride_p<T, true>()) * sizeof(T);
    grid = dim3(a.key_tiles, d_blocks, a.batch_heads);
    a.copy_in = copy_bytes<T>(a.head_dim, nullptr, 0, {a.q, a.dout});
    a.copy_out = copy_bytes<T>(a.head_dim, nullptr, 0, {a.g0, a.g1});
  }
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, a.stream>>>(a);
  return cudaGetLastError();
}

// The C launchers' body. Checks the arguments against the tiling rule
// (window_bwd_plan): tile_base as the rule gives it, span_tiles >= every
// query tile's span (with has_prev 1, the widest), key_tiles covering the
// rows of k; the band takes a window of 1..S, the halo any window >= 1 and
// a has_prev pointer; the scratch 16-byte aligned. Then launches `pass` on
// `stream`.
template <Mode M>
int run_window_bwd(int pass, WindowBwdParams a, int is_bf16) {
  const int kv_len = kv_rows<M>(a.seq_len, a.window);
  bool ok = a.batch_heads >= 1 && a.batch_heads <= 65535 && a.seq_len >= 1 && a.head_dim >= 1 &&
            a.window >= 1 && (M == kHalo || a.window <= a.seq_len) && (M == kBand || a.has_prev != nullptr) &&
            (pass != 0 || a.dropout_rate <= 0.f || a.seed != nullptr) && a.scratch != nullptr &&
            aligned16(a.scratch) && a.span_tiles >= 1 && a.key_tiles >= 1 && a.key_tiles <= 65535 &&
            a.span_tiles <= 65535;
  const int rule_base = M == kHalo && a.window % kWbTile ? a.window % kWbTile - kWbTile : 0;
  ok = ok && a.tile_base == rule_base && a.tile_base + a.key_tiles * kWbTile >= kv_len &&
       a.tile_base + (a.key_tiles - 1) * kWbTile < kv_len;
  for (int q0 = 0; ok && q0 < a.seq_len; q0 += kWbTile) {
    int k_lo, k_hi, base, n_tiles;
    window_tile_span<M>(q0, a.seq_len, a.window, false, a.tile_base, &k_lo, &k_hi, &base, &n_tiles);
    ok = n_tiles <= a.span_tiles;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)(is_bf16 ? launch_window_bwd<__nv_bfloat16, M>(pass, a) : launch_window_bwd<float, M>(pass, a));
}

}  // namespace tchvp
