// Tensor-core forward of banded (kBand, band_attention.cu) and halo (kHalo,
// halo_attention.cu) attention, in two passes over a (BH, S, span) fp32
// scratch that the wrapper allocates.
//
// The band's key span is 2w, not S, so the logits of a 64-row query tile
// are small (64 x 128 fp32 = 32 KB at w 64), and the forward splits where
// the work does:
//  * Pass A, logits (window_logits_kernel): grid (64-row query tile,
//    64-key tile of the tile's span, bh); 8 warps of 16 rows x 32 keys.
//    S = Q K^T on the tensor cores, the head dim streamed in 64-column
//    chunks through a cp.async ring of 4 (bf16) or 3 (fp32) stages (a
//    stage holds a 64 x 64 Q chunk and a 64 x 64 K chunk). It writes the
//    scaled logits, kNegInf where the band masks the pair, to
//    scratch[bh][row][key - k_lo], and each row's max over its key tile
//    after the span's columns. Splitting the span by key tile gives the
//    pass 256 blocks at config 2's shape, not 128.
//  * Pass B, P.V (window_pv_kernel): grid (64-row query tile, 128-column
//    head-dim block, bh). Each block takes its rows' exact max from the
//    tile maxima; a two-stage cp.async ring brings each 64-key tile's
//    logits (from the L2-resident scratch) and V column block into shared
//    memory; P = exp(s - m) is formed in registers straight in the mma
//    A-fragment layout (dropout from the same squirrel3 keep_element at the
//    same (row, hash_col) as the backward's pass A, window_bwd.cuh), the undropped sum l
//    added as it goes, and multiplied by V. out = acc / l leaves through
//    shared memory in 16-byte row pieces, not as 2-byte stores straight
//    from the fragments; lse = m + log(l) from the blocks of column block
//    0. The accumulator is one column block wide (16 x 128 fp32 per warp)
//    whatever Dh is, so any head dim runs, and a span wider than a tile
//    (w > 32, or w not dividing 64) is walked in 64-key tiles.
// Products: bf16 inputs take mma.sync m16n8k16 bf16 -> fp32 (Q and K
// fragments by ldmatrix from rows padded to 72 elements, V by
// ldmatrix.trans from rows padded to 136); P is rounded to bf16 for P.V,
// a rounding the TPU kernel does not make (it multiplies fp32 p). fp32
// inputs take 3xTF32 on mma.sync m16n8k8 (each operand split into a tf32
// high part and a tf32 remainder; lo*hi + hi*lo + hi*hi), which keeps fp32
// accuracy where TF32 alone would not.
// Every element of out and lse is computed by one thread in one order, with
// no atomics, so the bits are equal on repeat.
// Loads take 16-byte cp.async when Dh * sizeof(T) is a multiple of 16 and
// the pointers are 16-byte aligned, else element loads (any Dh); rows past
// S (or past the span) and columns past Dh are zero-filled.
#pragma once

#include "mma_common.cuh"

namespace tchvp {

constexpr int kWinBlockQ = 64;    // query rows per tile: 4 warps x 16
constexpr int kWinBlockK = 64;    // keys per logits block and per P.V step
constexpr int kWinChunkD = 64;    // head-dim columns per logits stage
constexpr int kWinBlockD = 128;   // head-dim columns per P.V block
constexpr int kWinThreads = 128;  // pass B: 4 warps of 16 rows
constexpr int kWinLogitsThreads = 256;  // pass A: 8 warps, 4 row groups x 2 key halves
constexpr int kWinStrideV = kWinBlockD + 8;  // V rows in shared memory, both dtypes

// Shared-memory row stride of the Q and K chunks: 72 bf16 (144 bytes: the 8
// rows of an ldmatrix block fall in 8 different 16-byte bank groups) or 68
// fp32 (the fragment loads (row g, word t) of a warp hit 32 banks).
template <typename T>
__host__ __device__ constexpr int win_stride_qk() {
  return sizeof(T) == 2 ? kWinChunkD + 8 : kWinChunkD + 4;
}

// Stages of the logits pass's cp.async ring: 4 x 18 KB (bf16) or 3 x 34 KB
// (fp32): three or two blocks per SM.
template <typename T>
__host__ __device__ constexpr int win_stages() { return sizeof(T) == 2 ? 4 : 3; }

// One 64-column chunk of a warp's S = Q K^T: 16 rows (q_s) x 32 keys (k_s),
// acc[j] the m16n8 tile of keys 8j..8j+7 (rows g, g + 8; keys 2t, 2t + 1).
// bf16 fragments come by ldmatrix: A as four 8x8 blocks (rows 0-7 / 8-15 x
// columns kk / kk + 8), B two key tiles at a time.
__device__ __forceinline__ void logits_chunk(float (&acc)[4][4], const __nv_bfloat16* q_s,
                                             const __nv_bfloat16* k_s, int lane) {
  constexpr int S = win_stride_qk<__nv_bfloat16>();
  const __nv_bfloat16* qa = q_s + (lane & 15) * S + (lane >> 4) * 8;
  const __nv_bfloat16* kb = k_s + ((lane >> 4) * 8 + (lane & 7)) * S + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < kWinChunkD; kk += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, qa + kk);
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      uint32_t b[4];  // keys 8j.. (b[0], b[1]) and 8j + 8.. (b[2], b[3])
      ldmatrix_x4(b, kb + 8 * j * S + kk);
      mma_bf16(acc[j], a, b);
      mma_bf16(acc[j + 1], a, b + 2);
    }
  }
}

__device__ __forceinline__ void logits_chunk(float (&acc)[4][4], const float* q_s,
                                             const float* k_s, int lane) {
  constexpr int S = win_stride_qk<float>();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kWinChunkD; kk += 8) {
    uint32_t a_hi[4], a_lo[4];
    split_tf32(q_s[g * S + kk + t], &a_hi[0], &a_lo[0]);
    split_tf32(q_s[(g + 8) * S + kk + t], &a_hi[1], &a_lo[1]);
    split_tf32(q_s[g * S + kk + t + 4], &a_hi[2], &a_lo[2]);
    split_tf32(q_s[(g + 8) * S + kk + t + 4], &a_hi[3], &a_lo[3]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* kr = k_s + (8 * j + g) * S + kk + t;
      mma_3xtf32(acc[j], a_hi, a_lo, kr[0], kr[4]);
    }
  }
}

// Pass A: scaled, masked logits of one (64-row query tile, 64-key tile of
// its span, bh) into scratch (BH, S, scratch_cols), column = key - k_lo,
// and each row's max over the tile at column span_cols + the tile's index
// (pass B takes the row max from these instead of sweeping the row). Warp w
// owns rows 16 (w % 4).. and keys 32 (w / 4).. of the tile: 8 warps, so
// that a block's loads and products overlap on the grid's few blocks. The
// head dim streams through a ring of win_stages<T>() chunks, the loads of
// the next stages in flight while a chunk's products run. Each chunk is
// summed in its own mma accumulator and added to the total in fp32: the
// tensor cores' accumulation does not round to nearest, and in one
// accumulator over the whole head dim the fp32 (3xTF32) error grows with Dh.
template <typename T, Mode M>
__global__ void __launch_bounds__(kWinLogitsThreads)
window_logits_kernel(const T* __restrict__ q, const T* __restrict__ k, float* __restrict__ scratch,
                     int seq_len, int head_dim, int window, int scratch_cols, int span_cols,
                     float scale, int vec, const int* __restrict__ has_prev) {
  constexpr int S = win_stride_qk<T>();
  constexpr int kStages = win_stages<T>();
  constexpr int kStage = (kWinBlockQ + kWinBlockK) * S;  // elements per stage
  extern __shared__ __align__(16) unsigned char win_smem[];
  T* ring = reinterpret_cast<T*>(win_smem);  // [kStages][Q chunk; K chunk]
  __shared__ float half_max[2][kWinBlockQ];  // each key half's row maxima

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rows = (warp & 3) * 16, keys = (warp >> 2) * 32;  // this warp's part of the tile
  const int q0 = blockIdx.x * kWinBlockQ;
  const int bh = blockIdx.z;
  const bool no_prev = M == kHalo && has_prev[0] == 0;
  int k_lo, k_hi;
  key_span<M>(q0, imin(seq_len, q0 + kWinBlockQ) - 1, seq_len, window, no_prev, &k_lo, &k_hi);
  k_hi = imin(k_hi, k_lo + span_cols);  // never past the scratch's logits columns
  const int kt0 = k_lo + blockIdx.y * kWinBlockK;
  if (kt0 >= k_hi) return;  // the grid covers the widest tile's span
  const T* qb = q + (size_t)bh * seq_len * head_dim;
  const T* kb = k + (size_t)bh * kv_rows<M>(seq_len, window) * head_dim;
  const int n_chunks = (head_dim + kWinChunkD - 1) / kWinChunkD;

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // Every iteration commits one group (empty past the last chunk), so
  // waiting for all but kStages - 2 groups leaves chunk c staged.
  auto load = [&](int chunk) {
    if (chunk < n_chunks) {
      T* st = ring + (chunk % kStages) * kStage;
      load_tile<T, kWinBlockQ, kWinChunkD, S, kWinLogitsThreads>(st, qb, q0, seq_len,
                                                                 chunk * kWinChunkD, head_dim,
                                                                 head_dim, vec ? 16 : 0);
      load_tile<T, kWinBlockK, kWinChunkD, S, kWinLogitsThreads>(st + kWinBlockQ * S, kb, kt0, k_hi,
                                                                 chunk * kWinChunkD, head_dim,
                                                                 head_dim, vec ? 16 : 0);
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
    float part[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
    logits_chunk(part, st + rows * S, st + (kWinBlockQ + keys) * S, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
  }

  float* xb = scratch + (size_t)bh * seq_len * scratch_cols;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = rows + g + 8 * half, row = q0 + r;
    const bool row_ok = row < seq_len;
    float m = kNegInf;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = kt0 + keys + 8 * j + 2 * t;  // and key + 1: a float2 (scratch_cols % 4 == 0)
      float2 x = make_float2(kNegInf, kNegInf);
      if (row_ok && key < k_hi && in_band<M>(row, key, window, no_prev)) x.x = acc[j][2 * half] * scale;
      if (row_ok && key + 1 < k_hi && in_band<M>(row, key + 1, window, no_prev))
        x.y = acc[j][2 * half + 1] * scale;
      float* dst = xb + (size_t)row * scratch_cols + key - k_lo;
      if (row_ok && key + 1 < k_hi) *reinterpret_cast<float2*>(dst) = x;
      else if (row_ok && key < k_hi) *dst = x.x;
      m = fmaxf(m, fmaxf(x.x, x.y));
    }
    // The 4 lanes of a row group hold the warp's keys between them.
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    if (t == 0) half_max[keys / 32][r] = m;
  }
  __syncthreads();
  if (threadIdx.x < kWinBlockQ && q0 + threadIdx.x < seq_len)
    xb[(size_t)(q0 + threadIdx.x) * scratch_cols + span_cols + blockIdx.y] =
        fmaxf(half_max[0][threadIdx.x], half_max[1][threadIdx.x]);
}

// The logits tile of pass B in shared memory: 64 rows x 64 fp32 columns,
// rows padded to 68 floats (the fp32 fragment loads (row g, column t) of a
// warp hit 32 banks).
constexpr int kWinStrideP = kWinBlockK + 4;

// Scratch columns [c0, c0 + 64) of rows [q0, q0 + 64) into p_s; columns at
// or past the span, and rows past S, are zero-filled (and never read as
// logits). scratch_cols % 4 == 0, so every 16-byte source is aligned.
__device__ __forceinline__ void load_logits_tile(float* p_s, const float* xb, int q0, int seq_len,
                                                 int c0, int span, int scratch_cols) {
  constexpr int kPerRow = kWinBlockK / 4;
  for (int i = threadIdx.x; i < kWinBlockQ * kPerRow; i += kWinThreads) {
    const int r = i / kPerRow;
    const int c = c0 + (i - r * kPerRow) * 4;
    const int n = q0 + r < seq_len ? imax(0, imin(4, span - c)) : 0;
    cp_async16(p_s + r * kWinStrideP + c - c0, n ? xb + (size_t)(q0 + r) * scratch_cols + c : xb,
               4 * n);
  }
}

// One row's weights: its max m, its undropped sum l so far, whether it is
// a row of the sequence, its index.
struct RowWeights {
  float m, l;
  bool ok;
  int row;
};

// The weights of row w at span columns c, c + 1 (x: the row's logits tile,
// c0 the tile's first column): p = exp(s - m), 0 where masked or past the
// span; `l` takes the undropped p, and with dropout p becomes keep ? p /
// keep_prob : 0.
template <Mode M>
__device__ __forceinline__ float2 weights2(RowWeights& w, const float* x, int c, int c0, int span,
                                          int k_lo, int window, int dropout, float keep_prob,
                                          uint32_t hash_base, uint32_t drop_threshold) {
  float2 s = make_float2(kNegInf, kNegInf);
  if (w.ok && c < span) {
    s = *reinterpret_cast<const float2*>(x + c - c0);
    if (c + 1 >= span) s.y = kNegInf;
  }
  float p0 = s.x == kNegInf ? 0.f : expf(s.x - w.m);
  float p1 = s.y == kNegInf ? 0.f : expf(s.y - w.m);
  w.l += p0 + p1;
  if (dropout) {
    p0 = dropout_weight(p0, row_hash(hash_base, w.row), hash_col<M>(k_lo + c, window), drop_threshold, keep_prob);
    p1 = dropout_weight(p1, row_hash(hash_base, w.row), hash_col<M>(k_lo + c + 1, window), drop_threshold,
                        keep_prob);
  }
  return make_float2(p0, p1);
}

template <Mode M>
__device__ __forceinline__ float weight1(RowWeights& w, const float* x, int c, int c0, int span,
                                         int k_lo, int window, int dropout, float keep_prob,
                                         uint32_t hash_base, uint32_t drop_threshold) {
  const float s = (w.ok && c < span) ? x[c - c0] : kNegInf;
  float p = s == kNegInf ? 0.f : expf(s - w.m);
  w.l += p;
  if (dropout)
    p = dropout_weight(p, row_hash(hash_base, w.row), hash_col<M>(k_lo + c, window), drop_threshold, keep_prob);
  return p;
}

// One 64-key tile of a warp's P.V: rows a, b (g, g + 8 of the warp; xa, xb
// their rows of the logits tile), V tile v_s (64 keys x 128 columns), span
// columns c0.. of the tile.
template <Mode M>
__device__ __forceinline__ void pv_tile(float (&acc)[16][4], RowWeights& ra, RowWeights& rb,
                                        const float* xa, const float* xb,
                                        const __nv_bfloat16* v_s, int c0, int span, int k_lo,
                                        int window, int dropout, float keep_prob,
                                        uint32_t hash_base, uint32_t thr, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < kWinBlockK; ks += 16) {
    const int c = c0 + ks + 2 * t;
    const float2 pa0 = weights2<M>(ra, xa, c, c0, span, k_lo, window, dropout, keep_prob, hash_base, thr);
    const float2 pb0 = weights2<M>(rb, xb, c, c0, span, k_lo, window, dropout, keep_prob, hash_base, thr);
    const float2 pa1 = weights2<M>(ra, xa, c + 8, c0, span, k_lo, window, dropout, keep_prob, hash_base, thr);
    const float2 pb1 = weights2<M>(rb, xb, c + 8, c0, span, k_lo, window, dropout, keep_prob, hash_base, thr);
    const uint32_t a[4] = {pack_bf16(pa0.x, pa0.y), pack_bf16(pb0.x, pb0.y),
                           pack_bf16(pa1.x, pa1.y), pack_bf16(pb1.x, pb1.y)};
    const __nv_bfloat16* vr =
        v_s + (ks + (lane & 7) + ((lane >> 3) & 1) * 8) * kWinStrideV + (lane >> 4) * 8;
#pragma unroll
    for (int jj = 0; jj < kWinBlockD / 16; ++jj) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vr + jj * 16);
      mma_bf16(acc[2 * jj], a, b);
      mma_bf16(acc[2 * jj + 1], a, b + 2);
    }
  }
}

template <Mode M>
__device__ __forceinline__ void pv_tile(float (&acc)[16][4], RowWeights& ra, RowWeights& rb,
                                        const float* xa, const float* xb, const float* v_s,
                                        int c0, int span, int k_lo, int window, int dropout,
                                        float keep_prob, uint32_t hash_base, uint32_t thr,
                                        int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < kWinBlockK; ks += 8) {
    const int c = c0 + ks + t;
    uint32_t a_hi[4], a_lo[4];
    split_tf32(weight1<M>(ra, xa, c, c0, span, k_lo, window, dropout, keep_prob, hash_base, thr), &a_hi[0], &a_lo[0]);
    split_tf32(weight1<M>(rb, xb, c, c0, span, k_lo, window, dropout, keep_prob, hash_base, thr), &a_hi[1], &a_lo[1]);
    split_tf32(weight1<M>(ra, xa, c + 4, c0, span, k_lo, window, dropout, keep_prob, hash_base, thr), &a_hi[2], &a_lo[2]);
    split_tf32(weight1<M>(rb, xb, c + 4, c0, span, k_lo, window, dropout, keep_prob, hash_base, thr), &a_hi[3], &a_lo[3]);
    const float* vr = v_s + (ks + t) * kWinStrideV + g;
#pragma unroll
    for (int j = 0; j < kWinBlockD / 8; ++j)
      mma_3xtf32(acc[j], a_hi, a_lo, vr[8 * j], vr[4 * kWinStrideV + 8 * j]);
  }
}

// Pass B: out and lse of one (64-row query tile, 128-column block, bh). A
// two-stage cp.async ring brings each key tile's V block and logits tile;
// the output tile goes out through shared memory in 16-byte rows.
template <typename T, Mode M>
__global__ void __launch_bounds__(kWinThreads)
window_pv_kernel(const T* __restrict__ v, const float* __restrict__ scratch, T* __restrict__ out,
                 float* __restrict__ lse, int seq_len, int head_dim, int window, int scratch_cols,
                 int span_cols, int dropout, float keep_prob, uint32_t drop_threshold,
                 const int* __restrict__ seed, int vec, const int* __restrict__ has_prev) {
  constexpr int kVStage = kWinBlockK * kWinStrideV;  // elements of T
  constexpr int kPStage = kWinBlockQ * kWinStrideP;  // floats
  extern __shared__ __align__(16) unsigned char win_smem[];
  T* v_s = reinterpret_cast<T*>(win_smem);                                   // [2][64][136]
  float* p_s = reinterpret_cast<float*>(win_smem + 2 * kVStage * sizeof(T));  // [2][64][68]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kWinBlockQ;
  const int d0 = blockIdx.y * kWinBlockD;
  const int bh = blockIdx.z;
  const bool no_prev = M == kHalo && has_prev[0] == 0;
  int k_lo, k_hi;
  key_span<M>(q0, imin(seq_len, q0 + kWinBlockQ) - 1, seq_len, window, no_prev, &k_lo, &k_hi);
  const int span = imin(k_hi - k_lo, span_cols);
  k_hi = k_lo + span;
  const int n_tiles = (span + kWinBlockK - 1) / kWinBlockK;
  const T* vb = v + (size_t)bh * kv_rows<M>(seq_len, window) * head_dim;
  const float* xs = scratch + (size_t)bh * seq_len * scratch_cols;

  auto load = [&](int tile) {
    const int stage = tile & 1;
    load_tile<T, kWinBlockK, kWinBlockD, kWinStrideV, kWinThreads>(v_s + stage * kVStage, vb,
                                                                   k_lo + tile * kWinBlockK, k_hi,
                                                                   d0, head_dim, head_dim,
                                                                   vec ? 16 : 0);
    load_logits_tile(p_s + stage * kPStage, xs, q0, seq_len, tile * kWinBlockK, span, scratch_cols);
    cp_async_commit();
  };
  load(0);

  // 1. Each row's exact max over its span, from pass A's tile maxima.
  RowWeights rw[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    RowWeights& w = rw[h];
    w.row = q0 + warp * 16 + g + 8 * h;
    w.ok = w.row < seq_len;
    w.l = 0.f;
    w.m = kNegInf;
    if (w.ok)
      for (int tile = 0; tile < n_tiles; ++tile)
        w.m = fmaxf(w.m, xs[(size_t)w.row * scratch_cols + span_cols + tile]);
  }

  float acc[kWinBlockD / 8][4];
#pragma unroll
  for (int j = 0; j < kWinBlockD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const uint32_t hash_base = dropout ? dropout_base(seed, bh) : 0u;

  // 2. acc += P V over the span's key tiles.
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) {
      load(tile + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* x = p_s + (tile & 1) * kPStage + (warp * 16 + g) * kWinStrideP;
    pv_tile<M>(acc, rw[0], rw[1], x, x + 8 * kWinStrideP, v_s + (tile & 1) * kVStage,
               tile * kWinBlockK, span, k_lo, window, dropout, keep_prob, hash_base,
               drop_threshold, lane);
    __syncthreads();
  }

  // 3. out = acc / l, staged in shared memory (V's first stage), then
  // written in 16-byte pieces; lse = m + log(l). l is 0 only past S.
  T* o_s = v_s;  // [64][kWinStrideV]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    RowWeights& w = rw[h];
    float l = w.l + __shfl_xor_sync(0xffffffffu, w.l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float safe_l = (l == 0.f) ? 1.f : l;
    T* orow = o_s + (warp * 16 + g + 8 * h) * kWinStrideV + 2 * t;
#pragma unroll
    for (int j = 0; j < kWinBlockD / 8; ++j) {
      orow[8 * j] = from_f32<T>(acc[j][2 * h] / safe_l);
      orow[8 * j + 1] = from_f32<T>(acc[j][2 * h + 1] / safe_l);
    }
    if (w.ok && blockIdx.y == 0 && t == 0) lse[(size_t)bh * seq_len + w.row] = w.m + logf(safe_l);
  }
  __syncthreads();
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = kWinBlockD / kVec;
  T* ob = out + (size_t)bh * seq_len * head_dim;
  for (int i = threadIdx.x; i < kWinBlockQ * kPerRow; i += kWinThreads) {
    const int r = i / kPerRow;
    const int c = (i - r * kPerRow) * kVec;
    if (q0 + r >= seq_len || d0 + c >= head_dim) continue;
    T* dst = ob + (size_t)(q0 + r) * head_dim + d0 + c;
    const T* src = o_s + r * kWinStrideV + c;
    if (vec) {
      *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
    } else {
      for (int e = 0; e < kVec && d0 + c + e < head_dim; ++e) dst[e] = src[e];
    }
  }
}

// A forward's arguments. span_cols, the widest key span of a 64-row query
// tile, comes from the host (flash_attention.py's window_plan): it sets the
// logits pass's key-tile grid and where each scratch row's tile maxima start.
struct WindowArgs {
  const void *q, *k, *v;
  void *out, *lse, *scratch;
  int batch_heads, seq_len, head_dim, window, span_cols, scratch_cols;
  float scale, dropout_rate;
  uint32_t drop_threshold;
  const int* seed;
  const int* has_prev;  // kHalo only
  cudaStream_t stream;
};

// 1 when every load and store may take 16 bytes: rows of Dh elements are a
// multiple of 16 bytes and the tensors 16-byte aligned.
template <typename T>
int window_vec(const WindowArgs& a) {
  return (a.head_dim * (int)sizeof(T)) % 16 == 0 && aligned16(a.q) && aligned16(a.k) &&
         aligned16(a.v) && aligned16(a.out);
}

// Pass A alone.
template <typename T, Mode M>
cudaError_t launch_window_logits(const WindowArgs& a) {
  const int q_tiles = (a.seq_len + kWinBlockQ - 1) / kWinBlockQ;
  const int key_tiles = (a.span_cols + kWinBlockK - 1) / kWinBlockK;
  const size_t smem =
      (size_t)win_stages<T>() * (kWinBlockQ + kWinBlockK) * win_stride_qk<T>() * sizeof(T);
  auto kernel = window_logits_kernel<T, M>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(q_tiles, key_tiles, a.batch_heads), kWinLogitsThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<float*>(a.scratch),
      a.seq_len, a.head_dim, a.window, a.scratch_cols, a.span_cols, a.scale, window_vec<T>(a),
      a.has_prev);
  return cudaGetLastError();
}

// Pass B alone, on the logits in the scratch.
template <typename T, Mode M>
cudaError_t launch_window_pv(const WindowArgs& a) {
  const int q_tiles = (a.seq_len + kWinBlockQ - 1) / kWinBlockQ;
  const int d_blocks = (a.head_dim + kWinBlockD - 1) / kWinBlockD;
  const size_t smem = (size_t)2 * kWinBlockK * kWinStrideV * sizeof(T) +
                      (size_t)2 * kWinBlockQ * kWinStrideP * sizeof(float);
  auto kernel = window_pv_kernel<T, M>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(q_tiles, d_blocks, a.batch_heads), kWinThreads, smem, a.stream>>>(
      static_cast<const T*>(a.v), static_cast<const float*>(a.scratch), static_cast<T*>(a.out),
      static_cast<float*>(a.lse), a.seq_len, a.head_dim, a.window, a.scratch_cols, a.span_cols,
      a.dropout_rate > 0.f ? 1 : 0, 1.f - a.dropout_rate, a.drop_threshold, a.seed,
      window_vec<T>(a), a.has_prev);
  return cudaGetLastError();
}

// The C launchers' body: checks the arguments (the band takes a window of
// 1..S, the halo any window >= 1 and a has_prev pointer; span_cols 1..the
// keys; scratch_cols must hold span_cols and one column per 64-key tile, and
// be a multiple of 4, the scratch 16-byte aligned), picks the dtype and
// launches pass A, then pass B, on `stream`.
template <Mode M>
int run_window_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                   void* scratch, int batch_heads, int seq_len, int head_dim, int window,
                   int span_cols, int scratch_cols, int is_bf16, float scale, float dropout_rate,
                   unsigned int drop_threshold, const void* seed, const void* has_prev,
                   void* stream) {
  if (batch_heads < 1 || batch_heads > 65535 || seq_len < 1 || head_dim < 1 ||
      (M == kBand && (window < 1 || window > seq_len)) ||
      (M == kHalo && (window < 1 || has_prev == nullptr)) ||
      (dropout_rate > 0.f && seed == nullptr) || scratch == nullptr || span_cols < 1 ||
      span_cols > kv_rows<M>(seq_len, window) ||
      scratch_cols < span_cols + (span_cols + kWinBlockK - 1) / kWinBlockK ||
      scratch_cols % 4 != 0 || !aligned16(scratch))
    return (int)cudaErrorInvalidValue;
  const WindowArgs a{q, k, v, out, lse, scratch, batch_heads, seq_len, head_dim, window,
                     span_cols, scratch_cols, scale, dropout_rate, drop_threshold,
                     static_cast<const int*>(seed), static_cast<const int*>(has_prev),
                     static_cast<cudaStream_t>(stream)};
  cudaError_t err = is_bf16 ? launch_window_logits<__nv_bfloat16, M>(a)
                            : launch_window_logits<float, M>(a);
  if (err != cudaSuccess) return (int)err;
  return (int)(is_bf16 ? launch_window_pv<__nv_bfloat16, M>(a) : launch_window_pv<float, M>(a));
}

}  // namespace tchvp
